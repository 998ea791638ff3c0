"""K7 `flow_head`, K8 `motion_encoder`, K9 `conv_gru` and the K6-interface
`gru_fused`: the quarter-resolution plane of one rotated refinement step.

    flow_head:      coords' = coords + conv2(relu(conv1(h)))[..., x]
    motion_encoder: [relu(_conv([c2(c1(corr_a)), c2(c1(corr_b)), f2(f1(flow-x))])) | flow-x | 0]
    conv_gru:       h' = (1 - z) h + z q over [h, x...] with context injections

on NHWC tensors with weights packed by `ops/step_fused.py` (plain versions
there).

Replaces the Pallas TPU kernels `stereoanywhere_tpu/ops/pallas/step_fused.py`
`fused_step_head` (its flow-head call, `_fh_kernel`), `fused_step_motion`
(`_motion_kernel`) and `fused_step_gru` (`_gru_kernel`); `gru_fused` stands
for `ops/pallas/gru_fused.py` `gru_fused` (`_zr_kernel`, `_q_kernel`), the
same ConvGRU with one x stream, through the K9 kernel.  Source:
`csrc/step_fused.cu` (the convolutions in `csrc/conv_wgmma.cuh`, and the
f32 bodies in `csrc/conv_igemm.cuh`).

Bound on the H100 at the 512^2 request (H4 x W4 = 128 x 128): all three are
convolutions above the card's ridge in bf16 (K9 at level 0: 43.5 GFLOP for
32 MB; K8: 11.0 GFLOP for 7.3 MB; K7: 9.7 GFLOP for 4.9 MB; chip_smoke's
counts), so tensor-core FLOP/s bound them.  Every 3x3 (and 7x7) conv is an
implicit GEMM whose [h, x...] concatenation is never built.
- K9, K8's two 3x3 stages and K7's conv1 in bf16 (the fused loop's type):
  `csrc/conv_wgmma.cuh`.  A tile is a 2-D patch of 128 or 64 pixels of one
  image, loaded per K-step (tap x input x 64 channels) by one TMA load from
  a 4-D map over (C, W, H, B): a tap is a coordinate offset and the zero
  padding is TMA's zero fill, so no thread computes an address.  A
  producer warpgroup keeps an mbarrier ring full, consumer warpgroups run
  `wgmma` (128 x 256 or 128 x 128 tiles on the 1/4-resolution plane, 64-row
  tiles on the small planes so they fill more SMs; 128 x 64 for K8's
  grouped stage, whose tiles each lie in one group of 64 outputs and read
  only that group's 64 input channels), the grid is persistent, and the
  epilogues (K9's gates and blend, K8's ReLU and its flow-x lane, K7's ReLU
  and tap columns) work on 16-byte pieces of the f32 sums through a padded
  shared tile.
- The f32 bodies (`csrc/conv_igemm.cuh`): FP32 FMA tiles, the taps nine
  shifted K-slices whose zero padding is a predicated load, the epilogue
  applied to each accumulator.
K7 is the TPU kernel's tap-column form: conv2 has one output channel (x),
so conv2(fh1)[p] = sum_tap z9[p + off_tap, tap] with z9 = fh1 . w2[tap],
z9 zero outside the plane.  In bf16, conv1's epilogue (128 x 256 tiles: all
256 channels of a pixel in one tile) rounds fh1 = relu(conv1 + b1) to bf16,
as the TPU kernel's slab, and reduces it at once to the 9 f32 tap columns
against conv2's x row kept in shared memory: fh1 (8.4 MB at the 512^2
request's plane) never reaches device memory, z9 (0.6 MB) does; a second
launch sums the taps in the TPU kernel's order and updates the
coordinates.  A tile narrower than 256 channels (forced, or picked on a
small plane) writes a partial z9 set that the tap sum adds.
What the TPU kernels kept in VMEM slabs between their other stages (c1/f1,
c2/f2, z, r*h) goes through device-memory scratch here, rounded to the
compute dtype as the slabs are, so a call is several launches: K7 two (three
in f32: conv1, its tap columns, the tap sum), K8 three (the 1x1 correlation conv and the 7x7 flow
conv: in bf16 `mma.sync` products over 64 pixels, the 36-channel
correlation rows, 72 bytes, being no TMA row, and the 7x7 taps an im2col in
shared memory; in f32 on the CUDA cores, one thread an output channel; then
convc2/convf2 as one 3-group conv, then the merge conv), K9 two (z and r*h, then q and the blend: q's conv reads r*h of
neighbouring pixels, which another block computes).  Each call counts once.
"""
from __future__ import annotations

import ctypes

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_operands, check_status, current_stream, library
from stereoanywhere_tpu_torch.ops.step_fused import (
    GruWeights,
    HeadWeights,
    MotionWeights,
    conv_gru_ref,
    flow_head_ref,
    motion_encoder_ref,
    pack_gru_hwio,
)

_LIB = "step_fused"
_BK = 32  # the kernels' K-step: every input's channel count is a multiple of it
_Z9_SETS = 4  # K7's partial tap-column sets: one a 64-channel tile column at most


def _check_coords(what: str, coords: torch.Tensor, device, shape) -> None:
    if coords.dtype != torch.float32 or coords.device != device or not coords.is_contiguous():
        raise TypeError(f"{what}: coords must be contiguous float32 on {device}")
    if tuple(coords.shape) != tuple(shape):
        raise ValueError(f"{what}: coords {tuple(coords.shape)}, expected {tuple(shape)}")


def flow_head(h: torch.Tensor, coords: torch.Tensor, w: HeadWeights) -> torch.Tensor:
    """h (B,H,W,128), coords (B,H,W) f32 -> coords + the flow head's x-delta."""
    if h.device.type == "cpu":
        return flow_head_ref(h, coords, w)
    out = _flow_head_call("flow_head", h, coords, w, 0)
    flow_head.launches += 1
    return out


def _flow_head_call(what: str, h: torch.Tensor, coords: torch.Tensor, w: HeadWeights, tile: int) -> torch.Tensor:
    """One call of the flow-head library function; tile 1..5 forces conv1's
    bf16 tile through the diagnostic entry point (0: picked)."""
    code = check_operands(what, h, w.w1, w.w2)
    b, hh, ww, c = h.shape
    if w.w1.shape != (256, 9, c) or w.w2.shape != (9, 256) or c % _BK:
        raise ValueError(f"{what}: h {tuple(h.shape)}, w1 {tuple(w.w1.shape)}, w2 {tuple(w.w2.shape)}")
    _check_coords(what, coords, h.device, (b, hh, ww))
    f32 = h.dtype == torch.float32
    fh1 = torch.empty((b, hh, ww, 256), device=h.device, dtype=h.dtype) if f32 else None
    z9 = torch.empty((_Z9_SETS, 9, b, hh, ww), device=h.device, dtype=torch.float32)
    out = torch.empty_like(coords)
    ptrs = [h.data_ptr(), w.w1.data_ptr(), w.b1.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(), coords.data_ptr()]
    if tile:
        if f32:
            raise TypeError(f"{what}: a forced tile is a bf16 diagnostic")
        fn = bind(_LIB, "sa_flow_head_forced_tile", 8, 5)
        status = fn(*ptrs, z9.data_ptr(), out.data_ptr(), b, hh, ww, c, tile, current_stream())
    else:
        fn = bind(_LIB, "sa_flow_head", 9, 5)
        status = fn(*ptrs, None if fh1 is None else fh1.data_ptr(), z9.data_ptr(), out.data_ptr(), b, hh, ww, c, code,
                    current_stream())
    check_status(_LIB, what, status)
    return out


def motion_encoder(corr_a: torch.Tensor, corr_b: torch.Tensor, coords: torch.Tensor, w: MotionWeights) -> torch.Tensor:
    """corr_* (B,H,W,36) (the dual lookup's two outputs), coords (B,H,W) f32
    -> (B,H,W,128) motion features in corr's dtype."""
    if corr_a.device.type == "cpu":
        return motion_encoder_ref(corr_a, corr_b, coords, w)
    code = check_operands("motion_encoder", corr_a, corr_b, w.w_c1, w.w_f1, w.w_c2f2, w.w_mc)
    b, hh, ww, kc = corr_a.shape
    if (corr_b.shape != corr_a.shape or kc != 36 or w.w_c1.shape != (64, 36) or w.w_f1.shape != (64, 49)
            or w.w_c2f2.shape != (192, 9, 64) or w.w_mc.shape != (128, 9, 192)):
        raise ValueError(f"motion_encoder: corr {tuple(corr_a.shape)} / {tuple(corr_b.shape)} or packed weights")
    _check_coords("motion_encoder", coords, corr_a.device, (b, hh, ww))
    a1 = torch.empty((b, hh, ww, 192), device=corr_a.device, dtype=corr_a.dtype)
    a2 = torch.empty_like(a1)
    out = torch.empty((b, hh, ww, 128), device=corr_a.device, dtype=corr_a.dtype)
    fn = bind(_LIB, "sa_motion", 14, 5)
    status = fn(corr_a.data_ptr(), corr_b.data_ptr(), coords.data_ptr(), w.w_c1.data_ptr(), w.b_c1.data_ptr(),
                w.w_f1.data_ptr(), w.b_f1.data_ptr(), w.w_c2f2.data_ptr(), w.b_c2f2.data_ptr(), w.w_mc.data_ptr(),
                w.b_mc.data_ptr(), a1.data_ptr(), a2.data_ptr(), out.data_ptr(), b, hh, ww, kc, code,
                current_stream())
    check_status(_LIB, "motion_encoder", status)
    motion_encoder.launches += 1
    return out


def _gru_launch(what, h, xs, inj, inj_ld, w: GruWeights) -> torch.Tensor:
    """One call of the ConvGRU library function."""
    code = check_operands(what, h, *xs, w.w_zr, w.w_q)
    b, hh, ww, hd = h.shape
    cs = [x.shape[-1] for x in xs]
    cin = hd + sum(cs)
    if (not 1 <= len(xs) <= 2 or any(tuple(x.shape[:3]) != (b, hh, ww) for x in xs) or hd % _BK
            or any(c % _BK for c in cs) or w.w_zr.shape != (2 * hd, 9, cin) or w.w_q.shape != (hd, 9, cin)):
        raise ValueError(f"{what}: h {tuple(h.shape)}, x {[tuple(x.shape) for x in xs]}, "
                         f"w_zr {tuple(w.w_zr.shape)}, w_q {tuple(w.w_q.shape)} (channels multiples of {_BK})")
    for t in inj:
        if t.device != h.device or t.dtype != h.dtype or tuple(t.shape[:3]) != (b, hh, ww) or t.shape[-1] < hd:
            raise ValueError(f"{what}: context injections must be (B,H,W,>= {hd}) in h's dtype and device")
    z, rh, out = (torch.empty_like(h) for _ in range(3))
    x2 = xs[1].data_ptr() if len(xs) == 2 else None
    fn = bind(_LIB, "sa_conv_gru", 13, 8)
    status = fn(h.data_ptr(), xs[0].data_ptr(), x2, *[t.data_ptr() for t in inj], w.w_zr.data_ptr(),
                w.b_zr.data_ptr(), w.w_q.data_ptr(), w.b_q.data_ptr(), z.data_ptr(), rh.data_ptr(), out.data_ptr(),
                b, hh, ww, hd, cs[0], cs[1] if len(cs) == 2 else 0, inj_ld, code, current_stream())
    check_status(_LIB, what, status)
    return out


def conv_gru(h: torch.Tensor, xs, czrq: torch.Tensor, w: GruWeights) -> torch.Tensor:
    """ConvGRU at any of the cascade's scales: h (B,H,W,hd), xs 1 or 2
    inputs (B,H,W,C), czrq (B,H,W,3 hd) = [cz | cr | cq] -> h'."""
    if h.device.type == "cpu":
        return conv_gru_ref(h, xs, czrq, w)
    hd = h.shape[-1]
    check_operands("conv_gru", czrq)
    if czrq.shape != (*h.shape[:3], 3 * hd):
        raise ValueError(f"conv_gru: czrq {tuple(czrq.shape)} against h {tuple(h.shape)}")
    out = _gru_launch("conv_gru", h, list(xs), (czrq, czrq[..., hd:], czrq[..., 2 * hd:]), 3 * hd, w)
    conv_gru.launches += 1
    return out


def gru_fused_ref(h, x, cz, cr, cq, wzr, bzr, wq, bq) -> torch.Tensor:
    """Plain version of the K6 interface: the ConvGRU over [h, x] with HWIO
    kernels wzr (3,3,Ch+Cx,2Ch), wq (3,3,Ch+Cx,Ch) and biases rounded to h's
    dtype, as the TPU kernel takes them."""
    return conv_gru_ref(h, [x], None, pack_gru_hwio(wzr, bzr, wq, bq, h.dtype), inj=(cz, cr, cq))


def gru_fused(h, x, cz, cr, cq, wzr, bzr, wq, bq) -> torch.Tensor:
    """The K6 interface (`ops/pallas/gru_fused.py` `gru_fused`): h (B,H,W,Ch),
    x (B,H,W,Cx), cz/cr/cq (B,H,W,Ch), HWIO kernels over [h, x] -> h'.  Runs
    the K9 kernel with one x stream; its weights are packed on every call."""
    if h.device.type == "cpu":
        return gru_fused_ref(h, x, cz, cr, cq, wzr, bzr, wq, bq)
    inj = (cz.contiguous(), cr.contiguous(), cq.contiguous())
    out = _gru_launch("gru_fused", h, [x], inj, h.shape[-1], pack_gru_hwio(wzr, bzr, wq, bq, h.dtype))
    gru_fused.launches += 1
    return out


flow_head.launches = 0
motion_encoder.launches = 0
conv_gru.launches = 0
gru_fused.launches = 0


_GEOMETRY_KEYS = ("bm", "bn", "bw", "bh", "tiles", "blocks", "stages", "threads", "smem")


def flow_head_forced_tile(h: torch.Tensor, coords: torch.Tensor, w: HeadWeights, tile: int) -> torch.Tensor:
    """K7's bf16 body with conv1's tile candidate `tile` (1..5: 128x256,
    128x128, 64x128, 64x64, 128x64) forced: a diagnostic, not a path of the
    model, and not counted."""
    if not 1 <= tile <= 5:
        raise ValueError(f"flow_head_forced_tile: tile {tile} is not a candidate (1..5)")
    return _flow_head_call("flow_head_forced_tile", h, coords, w, tile)


def flow_head_geometry(b: int, h: int, w: int) -> dict:
    """K7's bf16 conv1 launch on a (B, H, W) plane, as the library computes
    it; keys as `launch_geometry`'s."""
    fn = library(_LIB).sa_flow_head_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 9)()
    check_status(_LIB, "flow_head geometry", fn(b, h, w, out))
    return dict(zip(_GEOMETRY_KEYS, out))


def launch_geometry(b: int, h: int, w: int, hd: int = 128) -> list[dict]:
    """K9's bf16 launches (z/r, then q) on a (B, H, W) plane, as the library
    computes them: tile rows BM and width BN, the pixel patch BW x BH,
    tiles, blocks of the persistent grid, ring stages, threads and dynamic
    shared memory."""
    fn = library(_LIB).sa_conv_gru_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 18)()
    check_status(_LIB, "conv_gru geometry", fn(b, h, w, hd, out))
    return [dict(zip(_GEOMETRY_KEYS, out[9 * i:9 * i + 9])) for i in range(2)]


def motion_geometry(b: int, h: int, w: int) -> list[dict]:
    """K8's bf16 3x3 launches (the grouped convc2/convf2 stage, then the
    merge conv) on a (B, H, W) plane, as the library computes them; keys as
    `launch_geometry`'s."""
    fn = library(_LIB).sa_motion_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 18)()
    check_status(_LIB, "motion_encoder geometry", fn(b, h, w, out))
    return [dict(zip(_GEOMETRY_KEYS, out[9 * i:9 * i + 9])) for i in range(2)]
