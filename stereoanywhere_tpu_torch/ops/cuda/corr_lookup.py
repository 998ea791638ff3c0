"""K5 `dual_lookup`: both correlation pyramids looked up at shared coordinates.

    corr_p[b, h, w, l*(2r+1) + r + t] = lerp(level_p_l[b, h, w, :], coords[b, h, w] / 2^l + t)

for p in {a, b}, every level l and t in [-r, r], with entries outside
[0, Wl - 1] taken as zero (the reference `corr_sampler` semantics,
level-major taps).

Replaces every Pallas TPU kernel of this function in
`stereoanywhere_tpu/ops/pallas/`: `corr_kernel.py` `dual_lookup_pallas`,
`corr_tent.py` `dual_lookup_tent`, `corr_gather.py` `dual_lookup_windowed`,
`corr_lagged.py` `dual_lookup_lagged`, `corr_mxu.py` `dual_lookup_mxu`,
`corr_barrel.py` `lookup_packed_pair` / `dual_lookup_barrel` and
`step_fused.py` `_lookup_level_call`.  They differ only in how a TPU
evaluates the same sums (tent products over the whole row on the vector
unit, ones-matmul tap reductions on the MXU, lane-packed barrel rotates).
Source: `csrc/corr_lookup.cu`.

Bound on the H100: no products worth the name; it moves bytes.  What the
function must read is the window around each coordinate, 2r+2 entries a
(pixel, pyramid, level) where they fall inside the level, plus the
coordinates, and it writes 2 x L x (2r+1) values a pixel.  The design: one
launch for every level of both pyramids, one thread a (pixel, pyramid,
level) that reads only its window (one or two 32-byte sectors of the
level's row) and sums in f32; the whole Wl row is never touched, so the
work does not grow with the disparity range.  Written in CUDA rather than
Triton: it is a gather, which CUDA expresses directly.
"""
from __future__ import annotations

import ctypes

import torch

from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid
from stereoanywhere_tpu_torch.ops.cuda.build import DTYPE_CODES, bind, check_status, current_stream

_LIB = "corr_lookup"
MAX_LEVELS = 8


def dual_lookup_ref(levels_a, levels_b, coords: torch.Tensor, radius: int):
    """Plain version of K5: the gather lookup applied to both pyramids."""
    return lookup_corr_pyramid(levels_a, coords, radius), lookup_corr_pyramid(levels_b, coords, radius)


def dual_lookup(levels_a, levels_b, coords: torch.Tensor, radius: int):
    """levels_* (B,H,W2,Wl_i) in one dtype, coords (B,H,W2) f32 ->
    (corr_a, corr_b), each (B,H,W2, L*(2r+1)) in the levels' dtype.  The
    two results are views of one (2, B, H, W2, L*(2r+1)) tensor."""
    if coords.device.type == "cpu":
        return dual_lookup_ref(levels_a, levels_b, coords, radius)
    levels = [*levels_a, *levels_b]
    nl = len(levels_a)
    dt = levels[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"dual_lookup: dtype {dt} not supported (float32 or bfloat16)")
    if not 1 <= nl <= MAX_LEVELS or len(levels_b) != nl:
        raise ValueError(f"dual_lookup: {nl} / {len(levels_b)} levels (1 to {MAX_LEVELS}, the same for both)")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise TypeError("dual_lookup: coords must be contiguous float32")
    b, h, w2 = coords.shape
    for i, (la, lb) in enumerate(zip(levels_a, levels_b)):
        for t in (la, lb):
            if t.device != coords.device or t.dtype != dt or not t.is_contiguous():
                raise TypeError("dual_lookup: levels must be contiguous, of one dtype, on the coords' device")
            if t.shape != la.shape or tuple(t.shape[:3]) != (b, h, w2):
                raise ValueError(f"dual_lookup: level {i} shapes {tuple(la.shape)} / {tuple(lb.shape)} "
                                 f"against coords {tuple(coords.shape)}")
    k = 2 * radius + 1
    out = torch.empty((2, b, h, w2, nl * k), device=coords.device, dtype=dt)
    ptrs_a = (ctypes.c_void_p * nl)(*[t.data_ptr() for t in levels_a])
    ptrs_b = (ctypes.c_void_p * nl)(*[t.data_ptr() for t in levels_b])
    wls = (ctypes.c_int * nl)(*[t.shape[-1] for t in levels_a])
    fn = bind(_LIB, "sa_dual_lookup", 5, 4)
    status = fn(ctypes.addressof(ptrs_a), ctypes.addressof(ptrs_b), ctypes.addressof(wls), coords.data_ptr(),
                out.data_ptr(), nl, b * h * w2, radius, DTYPE_CODES[dt], current_stream())
    check_status(_LIB, "dual_lookup", status)
    dual_lookup.launches += 1
    return out[0], out[1]


dual_lookup.launches = 0
