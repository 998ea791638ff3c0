"""Convex (learned) upsampling of a coarse flow / disparity field, and its
plain bilinear counterpart `upflow`, on (B,C,H,W) tensors in either memory
format."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.ops.interp import resize_bilinear_align_corners
from stereoanywhere_tpu_torch.parallel import halo


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, n_downsample: int = 2) -> torch.Tensor:
    """flow (B,D,H,W), mask (B,9*f*f,H,W) logits -> (B,D,f*H,f*W), f = 2^n.

    Mask channel index (k*f + i)*f + j holds tap k of the 3x3 neighbourhood
    for sub-pixel (i, j); the taps are softmaxed and combine the f-scaled
    zero-padded neighbourhood of the coarse flow.  Under a row group the
    neighbourhood takes a row of flow from each neighbouring rank.
    """
    b, d, h, w = flow.shape
    f = 2 ** n_downsample
    m = torch.softmax(mask.view(b, 1, 9, f, f, h, w), dim=2)
    g = halo.active()
    if g is None:
        neigh = F.unfold(flow * f, kernel_size=3, padding=1)
    else:
        neigh = F.unfold(g.halo(flow * f, -2, 1, 1), kernel_size=3, padding=(0, 1))
    neigh = neigh.view(b, d, 9, 1, 1, h, w)
    up = torch.sum(m * neigh, dim=2)  # (B,D,f,f,H,W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, d, h * f, w * f)


def upflow(flow: torch.Tensor, factor: int = 2, use_scale_factor: bool = True) -> torch.Tensor:
    """Bilinear x 2^factor upsampling with aligned corners of (B,D,H,W),
    the values scaled by 2^factor too when `use_scale_factor` (the
    reference's `upflow`)."""
    scale = 2 ** factor
    out = resize_bilinear_align_corners(flow, (flow.shape[-2] * scale, flow.shape[-1] * scale))
    return out * scale if use_scale_factor else out
