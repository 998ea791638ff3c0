"""Resizing and pooling with the JAX package's semantics.

Every resize here is separable and applied as constant interpolation
matrices contracted over the trailing spatial axes, exactly as the JAX
package computes it, so the two agree to float rounding.  The functions act
on the LAST two (or three) axes: NCHW / NCDHW tensors inside the port.

Three families:
- align-corners bilinear / trilinear: torch `F.interpolate(...,
  align_corners=True)` semantics, used throughout the stereo branch;
- half-pixel bilinear without antialiasing: the DPT head's final upsample;
- `jax.image.resize` semantics (`resize_jax_image`): half-pixel centres,
  Keys cubic with a=-0.5 (not torch's a=-0.75) or the linear tent, and an
  ANTIALIASED kernel when downsampling.  The serving pipeline resizes with
  it (JAX `serve/pipeline.py`), so the port reproduces it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_image_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out, in) weights of `jax.image.resize` along one axis (scale out/in,
    no translation, antialiased when downsampling)."""
    kernel = {"cubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
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
    "jax_cubic": lambda i, o: _jax_image_matrix(i, o, "cubic"),
    "jax_bilinear": lambda i, o: _jax_image_matrix(i, o, "bilinear"),
}


@functools.lru_cache(maxsize=128)
def _device_matrix(kind: str, in_size: int, out_size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The (out, in) matrix of `kind`, built and copied to `device` once.  A
    copy from pageable host memory waits for the device to drain, so a
    resize inside the GRU loop must not make one.  The cache is bounded so
    that a server fed many request sizes does not grow without limit."""
    return torch.from_numpy(_MATRICES[kind](in_size, out_size)).to(device=device, dtype=dtype)


def _resize(x: torch.Tensor, sizes: tuple[int, ...], kind: str, order=None) -> torch.Tensor:
    """Resize the last len(sizes) axes to `sizes` with the matrices of
    `kind`, one axis at a time in `order` (indices into sizes); axes
    already at their size are skipped."""
    nd = len(sizes)
    for i in range(nd) if order is None else order:
        axis = x.ndim - nd + i
        if x.shape[axis] != sizes[i]:
            m = _device_matrix(kind, x.shape[axis], sizes[i], x.device, x.dtype)
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


def resize_jax_image(x: torch.Tensor, out_hw: tuple[int, int], method: str) -> torch.Tensor:
    """`jax.image.resize(x, ..., method)` over the last two axes, method
    'cubic' (Keys a=-0.5) or 'bilinear', antialiased when downsampling."""
    return _resize(x, tuple(out_hw), f"jax_{method}")


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
