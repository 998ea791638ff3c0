"""Correlation pyramid and its per-iteration radius-window lookup.

`lookup_corr_pyramid` is plain PyTorch in the gather form (the JAX
package's `_lookup_level_gather`).  `lookup_corr_pyramid_pair` looks both
pyramids up at shared coordinates.  Every `lookup_impl` of the JAX package
computes one function: its XLA formulations ("inline", "lagged",
"window", and "auto", which resolves to "window") and its Pallas kernels
("mxu", "barrel") differ only in how a TPU evaluates it.  So every impl
takes the K5 kernel (`ops/cuda/corr_lookup.py` `dual_lookup`, every level
of both pyramids in one launch) on a CUDA tensor, and its plain version,
the gather, on a CPU one.  On the card "barrel" needs no packing step: the
TPU's volume-interleaved layout (`pack_pyramid_pair`) and its bf16-only
and (B*H) % 4 conditions are TPU layout, not the function.
"""
from __future__ import annotations

import torch

from stereoanywhere_tpu_torch.config import LOOKUP_IMPLS
from stereoanywhere_tpu_torch.ops.interp import avg_pool_last_axis_2


def build_corr_pyramid(volume: torch.Tensor, num_levels: int = 4) -> list[torch.Tensor]:
    """volume (B,H,W2,W3) -> [volume, pooled by 2 along W3, ...], num_levels long."""
    levels = [volume]
    for _ in range(num_levels - 1):
        levels.append(avg_pool_last_axis_2(levels[-1]))
    return levels


def _lookup_level(level: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Linear interpolation of level (B,H,W2,Wl) at coords + [-r..r], zeros
    outside [0, Wl-1] -> (B,H,W2,2r+1)."""
    wl = level.shape[-1]
    taps = torch.arange(-radius, radius + 1, device=coords.device, dtype=coords.dtype)
    pos = coords.unsqueeze(-1) + taps
    x0 = torch.floor(pos)
    frac = (pos - x0).to(level.dtype)
    x0i = x0.long()

    def tap(idx, weight):
        valid = ((idx >= 0) & (idx <= wl - 1)).to(level.dtype)
        vals = torch.gather(level, -1, idx.clamp(0, wl - 1))
        return vals * weight * valid

    return tap(x0i, 1.0 - frac) + tap(x0i + 1, frac)


def lookup_corr_pyramid(levels: list[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Index every level i at coords/2^i (coords (B,H,W2), the right-image x).
    Returns (B,H,W2, levels*(2r+1)), level-major."""
    return torch.cat(
        [_lookup_level(level, coords / (2 ** i), radius) for i, level in enumerate(levels)], dim=-1
    )


def lookup_corr_pyramid_pair(pyramids, coords: torch.Tensor, radius: int, impl: str = "window"):
    """Both pyramids of `pyramids` looked up at coords (B,H,W2) f32:
    (corr_a, corr_b), each (B,H,W2, levels*(2r+1)).  impl: one of
    LOOKUP_IMPLS, all the same function.  An `ops.cuda.corr_lookup.DualPyramid`
    takes the K5 kernel on a CUDA tensor and its plain version on a CPU one;
    a pair of level lists (the train-mode forward's) takes the gather on
    any device, which autograd differentiates (K5 has no backward pass)."""
    if impl not in LOOKUP_IMPLS:
        raise ValueError(f"unknown lookup impl {impl!r}; use one of {LOOKUP_IMPLS}")
    if isinstance(pyramids, tuple):
        levels_a, levels_b = pyramids
        return lookup_corr_pyramid(levels_a, coords, radius), lookup_corr_pyramid(levels_b, coords, radius)
    from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import dual_lookup

    return dual_lookup(pyramids, coords, radius)
