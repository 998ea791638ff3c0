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
`step_fused.py` `_lookup_level_call`, and the JAX package's XLA lookups
(`ops/corr_lookup.py`): they differ only in how a TPU evaluates the same
sums (tent products over the whole row on the vector unit, ones-matmul tap
reductions on the MXU, lane-packed barrel rotates).  Source:
`csrc/corr_lookup.cu`, whose note gives the design.

Bound on the H100: no products worth the name; it moves bytes.  What the
function must read is the window around each coordinate, 2r+2 entries a
(pixel, pyramid, level) where they fall inside the level, plus the
coordinates, and it writes 2 x L x (2r+1) values a pixel.  At sector
granularity a 20-byte bf16 window spans one or two of the card's 32-byte
sectors.  The kernel reads each window as aligned 16-byte chunks, a warp
the neighbouring rows of one (pyramid, level), and writes the output
through shared memory in 16-byte stores; the whole Wl row is never
touched, so the work does not grow with the disparity range.  Written in
CUDA rather than Triton: it is a gather, which CUDA expresses directly.

`DualPyramid` checks the levels and builds the kernel's pointer and width
arrays once per pyramid pair (once a forward); a call of `dual_lookup`
then checks only the coordinates.  The kernel has no backward pass: both
functions raise on a tensor that requires grad.
"""
from __future__ import annotations

import ctypes

import torch

from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid
from stereoanywhere_tpu_torch.ops.cuda.build import DTYPE_CODES, bind, check_status, current_stream

_LIB = "corr_lookup"
MAX_LEVELS = 8
MAX_RADIUS = 8


def _refuse_grad(*tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("dual_lookup has no backward pass: a differentiable forward uses "
                           "ops.corr_lookup.lookup_corr_pyramid (the plain gather)")


class DualPyramid:
    """The stereo and mono pyramids of one forward, looked up together:
    levels_a / levels_b, lists of the same length and shapes (B,H,W2,Wl_i)
    in one dtype.  On the card each level must be contiguous, 16-byte
    aligned and float32 or bfloat16; the kernel's arrays of level pointers
    and widths are built here."""

    def __init__(self, levels_a, levels_b):
        self.levels_a, self.levels_b = list(levels_a), list(levels_b)
        nl = len(self.levels_a)
        if not 1 <= nl <= MAX_LEVELS or len(self.levels_b) != nl:
            raise ValueError(f"dual_lookup: {nl} / {len(self.levels_b)} levels (1 to {MAX_LEVELS}, the same for both)")
        levels = [*self.levels_a, *self.levels_b]
        _refuse_grad(*levels)
        first = self.levels_a[0]
        self.device, self.dtype, self.shape = first.device, first.dtype, tuple(first.shape[:3])
        self.widths = [t.shape[-1] for t in self.levels_a]
        self._call = None
        if self.device.type == "cpu":
            return
        if self.dtype not in DTYPE_CODES:
            raise TypeError(f"dual_lookup: dtype {self.dtype} not supported (float32 or bfloat16)")
        for i, (la, lb) in enumerate(zip(self.levels_a, self.levels_b)):
            for t in (la, lb):
                if t.device != self.device or t.dtype != self.dtype or not t.is_contiguous() or t.data_ptr() % 16:
                    raise TypeError("dual_lookup: levels must be contiguous, 16-byte aligned, of one dtype and "
                                    "on one device")
                if t.shape != la.shape or tuple(t.shape[:3]) != self.shape:
                    raise ValueError(f"dual_lookup: level {i} shapes {tuple(la.shape)} / {tuple(lb.shape)} against "
                                     f"level 0's {self.shape}")
        self._ptrs_a = (ctypes.c_void_p * nl)(*[t.data_ptr() for t in self.levels_a])
        self._ptrs_b = (ctypes.c_void_p * nl)(*[t.data_ptr() for t in self.levels_b])
        self._wls = (ctypes.c_int * nl)(*self.widths)
        fn = bind(_LIB, "sa_dual_lookup", 5, 4)
        head = (ctypes.addressof(self._ptrs_a), ctypes.addressof(self._ptrs_b), ctypes.addressof(self._wls))
        m = self.shape[0] * self.shape[1] * self.shape[2]
        code = DTYPE_CODES[self.dtype]
        self._call = lambda coords, out, radius: fn(*head, coords, out, nl, m, radius, code, current_stream())


def dual_lookup_ref(pyramids: DualPyramid, coords: torch.Tensor, radius: int):
    """Plain version of K5: the gather lookup applied to both pyramids."""
    return (lookup_corr_pyramid(pyramids.levels_a, coords, radius),
            lookup_corr_pyramid(pyramids.levels_b, coords, radius))


def dual_lookup(pyramids: DualPyramid, coords: torch.Tensor, radius: int):
    """Both pyramids at coords (B,H,W2) f32 -> (corr_a, corr_b), each
    (B,H,W2, L*(2r+1)) in the levels' dtype.  On the card the two results
    are views of one (2, B, H, W2, L*(2r+1)) tensor."""
    _refuse_grad(coords)
    call = pyramids._call
    if call is None:  # the pyramids lie on the CPU
        if coords.device.type != "cpu":
            raise TypeError(f"dual_lookup: coords on {coords.device}, pyramids on the CPU")
        return dual_lookup_ref(pyramids, coords, radius)
    if coords.device != pyramids.device or coords.dtype != torch.float32 or not coords.is_contiguous():
        raise TypeError(f"dual_lookup: coords must be contiguous float32 on {pyramids.device}")
    if coords.shape != pyramids.shape:
        raise ValueError(f"dual_lookup: coords {tuple(coords.shape)} against pyramids of {pyramids.shape}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"dual_lookup: radius {radius} (0 to {MAX_RADIUS})")
    out = torch.empty((2, *pyramids.shape, len(pyramids.widths) * (2 * radius + 1)), device=pyramids.device,
                      dtype=pyramids.dtype)
    status = call(coords.data_ptr(), out.data_ptr(), radius)
    if status:
        check_status(_LIB, "dual_lookup", status)
    dual_lookup.launches += 1
    return out.unbind(0)


dual_lookup.launches = 0
