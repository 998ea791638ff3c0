"""Resizing and pooling with the JAX package's semantics.

Every resize here is separable and applied as constant interpolation
matrices contracted over the trailing spatial axes, exactly as the JAX
package computes it, so the two agree to float rounding.  The functions act
on the LAST two (or three) axes of (B,C,H,W) / (B,C,D,H,W) tensors, as a
contraction over the axis moved last; `interp_like`, which resizes the
refinement loop's states, contracts a channels-last tensor in its memory
order instead, and it stays channels-last, with no transposing copy
(`_along`).

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

With a row group active (`parallel/halo.py`), the align-corners and
nearest resizes, `interp_like` and `pool2x` hold the rank's rows in their
image-row axis (the first of the last two; the trilinear resize's
`row_axis`): a resize gives the rank's rows at the target scale, from the
rows of the constant matrix for them and the band of input rows those rows
touch, fetched from the neighbours; `pool2x` takes one row from above.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import channels_last_format, device_constant
from stereoanywhere_tpu_torch.parallel import halo


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


@functools.lru_cache(maxsize=None)
def _band(kind: str, in_size: int, out_size: int, start: int, stop: int) -> tuple[int, int]:
    """The input columns [lo, hi) that output rows [start, stop) of the
    matrix touch."""
    cols = np.flatnonzero(_MATRICES[kind](in_size, out_size)[start:stop].any(axis=0))
    return int(cols[0]), int(cols[-1]) + 1


def _band_matrix(kind: str, in_size: int, out_size: int, start: int, stop: int) -> np.ndarray:
    lo, hi = _band(kind, in_size, out_size, start, stop)
    return np.ascontiguousarray(_MATRICES[kind](in_size, out_size)[start:stop, lo:hi])


def _along(x: torch.Tensor, m: torch.Tensor, axis: int, in_memory_order: bool) -> torch.Tensor:
    """m (out, in) applied along x's `axis`.  With `in_memory_order`, a
    channels-last x is viewed in its memory order (B, spatial axes, C),
    where the axis has the axes before it as a batch and the ones after it
    as columns: one batched product, and the result is channels-last too."""
    if not in_memory_order or channels_last_format(x) is None:
        return torch.movedim(torch.tensordot(x, m, dims=([axis], [1])), -1, axis)
    order = (0, *range(2, x.ndim), 1)
    xm = x.permute(order)
    p = order.index(axis)
    y = torch.matmul(m, xm.reshape(-1, xm.shape[p], math.prod(xm.shape[p + 1:])))
    return y.view(*xm.shape[:p], m.shape[0], *xm.shape[p + 1:]).permute(tuple(order.index(i) for i in range(x.ndim)))


def _resize_rows(g, x: torch.Tensor, axis: int, out_local: int, kind: str, in_memory_order: bool) -> torch.Tensor:
    """The row axis of a sharded x resized: this rank's output rows at the
    scale where it holds out_local rows, from the band of input rows they
    touch."""
    h_in, _ = g.span(x.shape[axis])
    h_out, out_ranges = g.span(out_local)
    if h_in == h_out:
        return x
    band = g.fetch(x, axis, [_band(kind, h_in, h_out, a, b) for a, b in out_ranges])
    a, b = out_ranges[g.index]
    m = device_constant(_band_matrix, (kind, h_in, h_out, a, b), x.device, x.dtype)
    return _along(band, m, axis, in_memory_order)


def _resize(x: torch.Tensor, sizes: tuple[int, ...], kind: str, order=None, row_axis: int | None = None,
            in_memory_order: bool = False) -> torch.Tensor:
    """Resize the last len(sizes) axes to `sizes` with the matrices of
    `kind`, one axis at a time in `order` (indices into sizes); axes
    already at their size are skipped.  With a row group active, `row_axis`
    holds the rank's rows and its size is the rank's rows at the target.
    `in_memory_order`: see `_along`."""
    nd = len(sizes)
    g = halo.active() if row_axis is not None else None
    for i in range(nd) if order is None else order:
        axis = x.ndim - nd + i
        if g is not None and axis == row_axis % x.ndim:
            x = _resize_rows(g, x, axis, sizes[i], kind, in_memory_order)
        elif x.shape[axis] != sizes[i]:
            m = device_constant(_MATRICES[kind], (x.shape[axis], sizes[i]), x.device, x.dtype)
            x = _along(x, m, axis, in_memory_order)
    return x


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes, align_corners=True (the first
    of them the image rows)."""
    return _resize(x, tuple(out_hw), "align_corners", row_axis=-2)


def resize_trilinear_align_corners(x: torch.Tensor, out_dhw: tuple[int, int, int], row_axis: int = -2) -> torch.Tensor:
    """Trilinear resize of the last three axes, align_corners=True; the
    image rows are `row_axis`: -2 in the hourglass's (B,C,W3,H,W2), -3 in a
    (B,H,W2,W3) volume."""
    return _resize(x, tuple(out_dhw), "align_corners", row_axis=row_axis)


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


def _nearest_band(in_size: int, out_size: int, start: int, stop: int) -> np.ndarray:
    idx = _nearest_index(in_size, out_size)[start:stop]
    return idx - idx[0]


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two axes (torch `mode='nearest'`), the
    first of them the image rows."""
    g = halo.active()
    for axis, out_size in ((x.ndim - 2, out_hw[0]), (x.ndim - 1, out_hw[1])):
        if g is not None and axis == x.ndim - 2:
            h_in, _ = g.span(x.shape[axis])
            h_out, ranges = g.span(out_size)
            src = _nearest_index(h_in, h_out)
            x = g.fetch(x, axis, [(int(src[a]), int(src[b - 1]) + 1) for a, b in ranges])
            a, b = ranges[g.index]
            idx = device_constant(_nearest_band, (h_in, h_out, a, b), x.device, torch.int64)
        else:
            idx = device_constant(_nearest_index, (x.shape[axis], out_size), x.device, torch.int64)
        x = torch.index_select(x, axis, idx)
    return x


def interp_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Align-corners bilinear resize of x to ref's spatial size; a
    channels-last x (the refinement loop's states) stays so."""
    return _resize(x, (ref.shape[-2], ref.shape[-1]), "align_corners", row_axis=-2, in_memory_order=True)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool, zero padding counted.  Under a row
    group, the row above the rank's (zero at the image's top) stands for
    the padding, which the divisor counts either way.  A channels-last x
    that autograd differentiates is pooled on an NCHW copy: CUDA's
    channels-last avg_pool2d backward returns wrong gradients (off by the
    gradient's own size; torch 2.11, NVIDIA H100), its forward does not."""
    g = halo.active()
    fmt = channels_last_format(x)
    if fmt is not None and x.requires_grad and torch.is_grad_enabled():
        return pool2x(x.contiguous()).contiguous(memory_format=fmt)
    if g is None:
        return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
    return F.avg_pool2d(g.halo(x, -2, 1, 0), 3, stride=2, padding=(0, 1), count_include_pad=True)


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
