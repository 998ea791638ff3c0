"""Joint normalization, depth -> normals, disparity warping, soft LRC, on
(B,C,H,W) maps in either memory format.

With a row group active (`parallel/halo.py`) the tensors hold the rank's
image rows: the min-max is the group's, the normals take a row from each
neighbour (the edge row at the image's top and bottom), and the warp's
row taps, which depend on the global row index and height (the
reference's y * (H-1)/H quirk), take one row from above.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stereoanywhere_tpu_torch.parallel import halo


def joint_minmax_normalize(xs: list[torch.Tensor], eps: float = 1e-4) -> list[torch.Tensor]:
    """Joint per-sample, per-channel min-max normalization over a list of
    NCHW tensors (min and max over H, W, taken jointly over the list, and
    detached, as the JAX package stops their gradient)."""
    lo = torch.stack([x.amin(dim=(2, 3), keepdim=True) for x in xs]).amin(dim=0).detach()
    hi = torch.stack([x.amax(dim=(2, 3), keepdim=True) for x in xs]).amax(dim=0).detach()
    g = halo.active()
    if g is not None:
        lo, hi = g.all_reduce(lo, dist.ReduceOp.MIN), g.all_reduce(hi, dist.ReduceOp.MAX)
    return [(x - lo) / (hi - lo + eps) for x in xs]


def estimate_normals(depth: torch.Tensor, normal_gain: float) -> torch.Tensor:
    """Depth (B,1,H,W) -> unit normals (B,3,H,W) of gain*depth: normalize
    [-d/dx, -d/dy, 1] with replicate-padded central differences (no 1/2)."""
    g = halo.active()
    if g is None:
        xp = F.pad(depth * normal_gain, (1, 1, 1, 1), mode="replicate")
    else:
        xp = F.pad(g.halo(depth * normal_gain, -2, 1, 1, pad="edge"), (1, 1, 0, 0), mode="replicate")
    gx = xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]
    gy = xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]
    n = torch.cat([-gx, -gy, torch.ones_like(gx)], dim=1)
    return n / torch.linalg.vector_norm(n, dim=1, keepdim=True)


def _sample_rows_linear(values: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """values (B,C,H,W) sampled along W at src_x (B,1,H,W), linear, zeros
    outside [0, W-1]."""
    w = values.shape[-1]
    x0 = torch.floor(src_x)
    frac = (src_x - x0).to(values.dtype)
    x0i = x0.long()

    def tap(idx, weight):
        valid = ((idx >= 0) & (idx <= w - 1)).to(values.dtype)
        safe = idx.clamp(0, w - 1).expand(-1, values.shape[1], -1, -1)
        return torch.gather(values, 3, safe) * weight * valid

    return tap(x0i, 1.0 - frac) + tap(x0i + 1, frac)


def disp_warping(disp: torch.Tensor, img: torch.Tensor, right_disp: bool = False) -> torch.Tensor:
    """Warp img (B,C,H,W) along x by disp (B,1,H,W).

    Reference quirk kept: the sampling grid is built as 2*(x±d)/W - 1 and
    read with align_corners=True, so the source x is (x±d)*(W-1)/W and the
    source y is y*(H-1)/H, bilinear in 2-D, zeros outside the image.
    """
    _, _, n, w = img.shape
    xs = torch.arange(w, device=img.device, dtype=disp.dtype).view(1, 1, 1, w)
    src_x = (xs + disp) if right_disp else (xs - disp)
    src_x = src_x * ((w - 1) / w)

    # output row i reads rows y0 = floor(i (h-1)/h) and y0 + 1, which is i - 1
    # and i for i > 0: a rank of a row group takes one row from above
    g = halo.active()
    h, start = n, 0
    if g is not None:
        h, ranges = g.span(n)
        start = ranges[g.index][0]
    ys = torch.arange(h, device=img.device, dtype=torch.float32) * ((h - 1) / h)
    y0 = torch.floor(ys)
    fy = (ys - y0).to(img.dtype).view(1, 1, h, 1)
    y0i = y0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    if g is not None:
        first = max(start - 1, 0)  # the band's first global row
        img = g.halo(img, -2, 1, 0)[:, :, 1 - (start - first):]  # rows [first, start + n)
        rows = slice(start, start + n)
        fy, y0i, y1i = fy[:, :, rows], y0i[rows] - first, y1i[rows] - first
    img0 = img[:, :, y0i]
    img1 = img[:, :, y1i]
    return _sample_rows_linear(img0, src_x) * (1.0 - fy) + _sample_rows_linear(img1, src_x) * fy


def softlrc(disp2: torch.Tensor, disp3: torch.Tensor, lrc_th: float = 1.0):
    """Soft left-right consistency weights in (0,1) for both views."""
    div_const = math.log(1 + math.exp(lrc_th))
    warped_disp2 = disp_warping(F.relu(disp3), disp2, right_disp=True)
    warped_disp3 = disp_warping(F.relu(disp2), disp3, right_disp=False)
    s2 = F.softplus(-torch.abs(disp2 - warped_disp3) + lrc_th) / div_const
    s3 = F.softplus(-torch.abs(disp3 - warped_disp2) + lrc_th) / div_const
    return s2, s3
