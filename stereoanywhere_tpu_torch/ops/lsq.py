"""Global scale/shift recovery: confidence-weighted least squares (the
model's), and the JAX package's two other estimators, the unweighted
masked least squares `normalized_scale_and_shift` and the quantile-anchored
`naive_scale_shift`.  Each returns (scale, shift), (B,1,1,1)."""
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


def normalized_scale_and_shift(
    prediction: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    min_quantile: float = 0.2,
    max_quantile: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit scale*prediction + shift ~= target over the masked elements, per
    sample, unweighted, in f32.  Unless the quantiles are (0, 1) the mask
    also drops targets outside [q_min, q_max] of the WHOLE batch's targets
    (the reference takes `torch.quantile` without a dim; kept).  A singular
    system gives (0, 0)."""
    b = prediction.shape[0]
    p = prediction.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    m = mask.reshape(b, -1).float()
    if min_quantile > 0.0 or max_quantile < 1.0:
        lo = torch.quantile(t, min_quantile)
        hi = torch.quantile(t, max_quantile)
        m = m * ((t >= lo) & (t <= hi)).float()

    a00 = torch.sum(m * p * p, dim=1)
    a01 = torch.sum(m * p, dim=1)
    a11 = torch.sum(m, dim=1)
    b0 = torch.sum(m * p * t, dim=1)
    b1 = torch.sum(m * t, dim=1)

    det = a00 * a11 - a01 * a01
    ok = det != 0
    safe = torch.where(ok, det, torch.ones_like(det))
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.zeros_like(det))
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, torch.zeros_like(det))
    return scale.view(b, 1, 1, 1), shift.view(b, 1, 1, 1)


def _masked_sorted(v: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row of v (B, N) sorted with its unmasked entries replaced by
    the dtype's largest value (so they sort last), and the masked count."""
    big = torch.full_like(v, torch.finfo(v.dtype).max)
    return torch.sort(torch.where(mask, v, big), dim=1).values, mask.sum(dim=1)


def _masked_quantile(s: torch.Tensor, n: torch.Tensor, q: float) -> torch.Tensor:
    """torch.quantile's linear interpolation between order statistics, over
    each row's n masked entries of the masked sort s; NaN where n is 0 (the
    reference raises on the empty tensor)."""
    pos = q * (n.float() - 1.0)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = (pos - lo.float()).to(s.dtype)
    vlo = torch.gather(s, 1, lo.clamp(min=0)[:, None])[:, 0]
    vhi = torch.gather(s, 1, hi.clamp(min=0)[:, None])[:, 0]
    return torch.where(n > 0, vlo * (1 - frac) + vhi * frac, torch.full_like(vlo, float("nan")))


def _masked_median(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """torch.median's lower middle order statistic of each row's n masked
    entries; NaN where n is 0."""
    med = torch.gather(s, 1, ((n - 1) // 2).clamp(min=0)[:, None])[:, 0]
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def naive_scale_shift(
    mde: torch.Tensor,
    disp: torch.Tensor,
    conf: torch.Tensor,
    conf_th: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantile-anchored scale and shift over each sample's elements with
    conf > conf_th: scale = (q90(disp) - median(disp)) / (q90(mde) -
    median(mde)), shift = median(disp) - scale * median(mde), with
    torch.quantile's interpolation and torch.median's lower middle; a
    batched masked sort, in mde's dtype at the end."""
    b = mde.shape[0]
    m = mde.reshape(b, -1).float()
    d = disp.reshape(b, -1).float()
    mask = conf.reshape(b, -1).float() > conf_th
    sm, n = _masked_sorted(m, mask)
    sd, _ = _masked_sorted(d, mask)
    m90, mmed = _masked_quantile(sm, n, 0.9), _masked_median(sm, n)
    d90, dmed = _masked_quantile(sd, n, 0.9), _masked_median(sd, n)
    scale = (d90 - dmed) / (m90 - mmed)
    shift = dmed - scale * mmed
    return scale.view(b, 1, 1, 1).to(mde.dtype), shift.view(b, 1, 1, 1).to(mde.dtype)
