"""Global scale/shift recovery by confidence-weighted least squares."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.parallel import halo


def weighted_lsq(
    mde: torch.Tensor,
    disp: torch.Tensor,
    conf: torch.Tensor,
    min_quantile: float = 0.2,
    max_quantile: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit scale*|mde| + shift ~= relu(disp), weighted by 0.9*|conf| + 0.1,
    over the elements of relu(disp) within its [q20, q90] per sample.

    Statistics are per sample over all non-batch elements; the 2x2 normal
    equations are solved in closed form in f32.  Returns (scale, shift),
    each (B,1,1,1) in mde's dtype.

    With a row group active the inputs (B,C,H,W) hold the rank's rows, and
    every rank fits on the group's gathered maps: the quantiles need the
    whole disparity anyway, the maps are at quarter resolution (2 x H/4 x
    W/4 values each), and the fit is then the one-process fit bit for bit,
    where five sums reduced over the ranks would be reordered and the 2x2
    solve amplifies that reordering well past f32 rounding.
    """
    g = halo.active()
    if g is not None:
        mde, disp, conf = (g.gather_rows(t, -2) for t in (mde, disp, conf))
    b = mde.shape[0]
    m = torch.abs(mde.reshape(b, -1).float())
    d = F.relu(disp.reshape(b, -1).float())
    c = torch.abs(conf.reshape(b, -1).float())

    lo = torch.quantile(d, min_quantile, dim=1, keepdim=True)
    hi = torch.quantile(d, max_quantile, dim=1, keepdim=True)
    keep = ((d >= lo) & (d <= hi)).float()
    w = (c * 0.9 + 0.1) * keep

    a00 = torch.sum(w * m * m, dim=1)
    a01 = torch.sum(w * m, dim=1)
    a11 = torch.sum(w, dim=1)
    b0 = torch.sum(w * m * d, dim=1)
    b1 = torch.sum(w * d, dim=1)

    det = a00 * a11 - a01 * a01
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, torch.ones_like(det))
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.zeros_like(det))
    shift = torch.where(ok, (a00 * b1 - a01 * b0) / safe, torch.zeros_like(det))
    return scale.view(b, 1, 1, 1).to(mde.dtype), shift.view(b, 1, 1, 1).to(mde.dtype)
