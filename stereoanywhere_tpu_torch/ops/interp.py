"""Resizing and pooling with the JAX package's semantics.

Every resize here is separable and applied as constant interpolation
matrices contracted over the trailing spatial axes, exactly as the JAX
package computes it, so the two agree to float rounding.  The functions act
on the LAST two (or three) axes: NCHW / NCDHW tensors inside the port.

Four families, and a nearest resize:
- align-corners bilinear / trilinear: torch `F.interpolate(...,
  align_corners=True)` semantics, used throughout the stereo branch;
- half-pixel bilinear without antialiasing: the DPT head's final upsample;
- half-pixel bicubic with a=-0.75, clamped border taps and no antialiasing
  (torch `F.interpolate(mode='bicubic')`): DAv2's input resize in
  `infer_mono_depth`, as the reference's `infer_image` does it;
- `jax.image.resize` semantics (`resize_jax_image`): half-pixel centres,
  Keys cubic with a=-0.5 (not torch's a=-0.75) or the linear tent, and an
  ANTIALIASED kernel when downsampling.  The serving pipeline resizes with
  it (JAX `serve/pipeline.py`), so the port reproduces it;
- nearest (`resize_nearest`), torch's `mode='nearest'` index rule
  floor(i * in / out) with the product taken in f32, as the JAX package
  takes it: the masks of `vol_downsample`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import device_constant


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) align-corners linear interpolation matrix."""
    if out_size == 1:
        src = np.zeros((1,), np.float32)
    else:
        scale = np.float32((in_size - 1) / (out_size - 1))
        src = np.arange(out_size, dtype=np.float32) * scale
    x0 = np.clip(np.floor(src), 0, max(in_size - 1, 0)).astype(np.int64)
    x1 = np.minimum(x0 + 1, in_size - 1)
    w = (src - x0.astype(np.float32)).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, x0), 1.0 - w)
    np.add.at(m, (rows, x1), w)
    return m


@functools.lru_cache(maxsize=None)
def _halfpix_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) half-pixel linear matrix, edge taps clamped, no antialias."""
    src = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(in_size / out_size) - 0.5
    x0 = np.floor(src)
    w = (src - x0).astype(np.float32)
    x0i = np.clip(x0, 0, in_size - 1).astype(np.int64)
    x1i = np.clip(x0 + 1, 0, in_size - 1).astype(np.int64)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, x0i), 1.0 - w)
    np.add.at(m, (rows, x1i), w)
    return m


@functools.lru_cache(maxsize=None)
def _bicubic_halfpix_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) half-pixel bicubic (a=-0.75) matrix, border taps clamped
    to the edge, no antialias (the JAX package's
    `_interp_matrix_bicubic_halfpix`, its f32 arithmetic in its order)."""
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size / out_size) - np.float32(0.5)
    i0 = np.floor(src)
    t = src - i0
    a = np.float32(-0.75)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        d = np.abs(t - np.float32(k))
        d2, d3 = d * d, d * d * d
        w = np.where(
            d <= 1,
            (a + 2) * d3 - (a + 3) * d2 + 1,
            np.where(d < 2, a * d3 - 5 * a * d2 + 8 * a * d - 4 * a, np.float32(0.0)),
        ).astype(np.float32)
        idx = np.clip(i0.astype(np.int64) + k, 0, in_size - 1)
        np.add.at(m, (rows, idx), w)
    return m


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_image_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out, in) weights of `jax.image.resize` along one axis (scale out/in,
    no translation, antialiased when downsampling).  The sample positions
    (i + 0.5) * inv_scale - 0.5 are rounded once, as XLA computes them with
    a fused multiply-add (rounded twice, they are up to 2e-6 off)."""
    kernel = {"cubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size) + 0.5) * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x)  # (in, out)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


_MATRICES = {
    "align_corners": _align_corners_matrix,
    "halfpix": _halfpix_matrix,
    "bicubic_halfpix": _bicubic_halfpix_matrix,
    "jax_cubic": lambda i, o: _jax_image_matrix(i, o, "cubic"),
    "jax_bilinear": lambda i, o: _jax_image_matrix(i, o, "bilinear"),
}


def _resize(x: torch.Tensor, sizes: tuple[int, ...], kind: str, order=None) -> torch.Tensor:
    """Resize the last len(sizes) axes to `sizes` with the matrices of
    `kind`, one axis at a time in `order` (indices into sizes); axes
    already at their size are skipped."""
    nd = len(sizes)
    for i in range(nd) if order is None else order:
        axis = x.ndim - nd + i
        if x.shape[axis] != sizes[i]:
            m = device_constant(_MATRICES[kind], (x.shape[axis], sizes[i]), x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, m, dims=([axis], [1])), -1, axis)
    return x


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes, align_corners=True."""
    return _resize(x, tuple(out_hw), "align_corners")


def resize_trilinear_align_corners(x: torch.Tensor, out_dhw: tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of the last three axes, align_corners=True."""
    return _resize(x, tuple(out_dhw), "align_corners")


def resize_bilinear_halfpix(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of the last two axes without antialiasing
    (torch `F.interpolate(mode='bilinear', align_corners=False)`), W first as
    the JAX package orders it."""
    return _resize(x, tuple(out_hw), "halfpix", order=(1, 0))


def resize_bicubic_halfpix(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bicubic resize of the last two axes, a=-0.75, border taps
    clamped, no antialiasing (torch `F.interpolate(mode='bicubic',
    align_corners=False)`), W first as the JAX package orders it."""
    return _resize(x, tuple(out_hw), "bicubic_halfpix", order=(1, 0))


def resize_jax_image(x: torch.Tensor, out_hw: tuple[int, int], method: str) -> torch.Tensor:
    """`jax.image.resize(x, ..., method)` over the last two axes, method
    'cubic' (Keys a=-0.5) or 'bilinear', antialiased when downsampling."""
    return _resize(x, tuple(out_hw), f"jax_{method}")


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output: floor(f32(i) * f32(in / out)), the
    JAX package's int32 arange times a Python float, which JAX rounds to
    f32 before the product."""
    return np.floor(np.arange(out_size, dtype=np.float32) * np.float32(in_size / out_size)).astype(np.int64)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two axes (torch `mode='nearest'`)."""
    for axis, out_size in ((x.ndim - 2, out_hw[0]), (x.ndim - 1, out_hw[1])):
        idx = device_constant(_nearest_index, (x.shape[axis], out_size), x.device, torch.int64)
        x = torch.index_select(x, axis, idx)
    return x


def interp_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Align-corners bilinear resize of x to ref's spatial size."""
    return resize_bilinear_align_corners(x, (ref.shape[-2], ref.shape[-1]))


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool, zero padding counted."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def interp_like_nhwc(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`interp_like` on NHWC tensors; the result is contiguous NHWC."""
    return interp_like(x.permute(0, 3, 1, 2), ref.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def pool2x_nhwc(x: torch.Tensor) -> torch.Tensor:
    """`pool2x` on NHWC tensors; the result is contiguous NHWC."""
    return pool2x(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def pool4x(x: torch.Tensor) -> torch.Tensor:
    """5x5 stride-4 pad-1 average pool, zero padding counted."""
    return F.avg_pool2d(x, 5, stride=4, padding=1, count_include_pad=True)


def avg_pool_last_axis_2(x: torch.Tensor) -> torch.Tensor:
    """Average-pool by 2 along the last axis; an odd last element is dropped."""
    m = (x.shape[-1] // 2) * 2
    x = x[..., :m]
    return 0.5 * (x[..., 0::2] + x[..., 1::2])
