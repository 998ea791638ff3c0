"""Correlation pyramid and its per-iteration radius-window lookup.

`lookup_corr_pyramid` is plain PyTorch in the gather form (the JAX
package's `_lookup_level_gather`).  `lookup_corr_pyramid_pair` looks both
pyramids up at shared coordinates and dispatches on `lookup_impl` as the
JAX package's `lookup_corr_pyramid_pair` does: its XLA formulations
("inline", "lagged", "window") compute one function, which the port has
once, in the gather form; its Pallas kernels ("mxu", "barrel") become the
K5 kernel (`ops/cuda/corr_lookup.py` `dual_lookup`), which looks every level
of both pyramids up in one launch.  On the card "barrel" needs no packing
step: the TPU's volume-interleaved layout (`pack_pyramid_pair`) and its
bf16-only and (B*H) % 4 conditions are TPU layout, not the function.
"""
from __future__ import annotations

import torch

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


XLA_IMPLS = ("inline", "lagged", "window")
KERNEL_IMPLS = ("mxu", "barrel")


def lookup_corr_pyramid(levels: list[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Index every level i at coords/2^i (coords (B,H,W2), the right-image x).
    Returns (B,H,W2, levels*(2r+1)), level-major."""
    return torch.cat(
        [_lookup_level(level, coords / (2 ** i), radius) for i, level in enumerate(levels)], dim=-1
    )


def lookup_corr_pyramid_pair(levels_a, levels_b, coords: torch.Tensor, radius: int, impl: str = "window"):
    """Both pyramids (same shapes) looked up at coords (B,H,W2) f32:
    (corr_a, corr_b), each (B,H,W2, levels*(2r+1)).  impl: one of
    XLA_IMPLS (the gather, twice) or KERNEL_IMPLS (the K5 kernel on a CUDA
    tensor, its plain version, the same gather, on a CPU one)."""
    if impl in XLA_IMPLS:
        return lookup_corr_pyramid(levels_a, coords, radius), lookup_corr_pyramid(levels_b, coords, radius)
    if impl in KERNEL_IMPLS:
        from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import dual_lookup

        return dual_lookup(levels_a, levels_b, coords, radius)
    raise ValueError(f"unknown lookup impl {impl!r}; use one of {XLA_IMPLS + KERNEL_IMPLS}")
