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
`csrc/step_fused.cu` (the convolutions in `csrc/conv_igemm.cuh`).

Bound on the H100 at the 512^2 request (H4 x W4 = 128 x 128): all three are
convolutions above the card's ridge in bf16 (K9 at level 0: 43.5 GFLOP for
32 MB; K8: 11.0 GFLOP for 7.3 MB; K7: 9.7 GFLOP for 4.9 MB; chip_smoke's
counts), so tensor-core FLOP/s bound them.  The design: every 3x3 (and 7x7) conv is an implicit GEMM on
`mma.sync` m16n8k16 tiles, the taps nine shifted K-slices whose zero
padding is a predicated load, the [h, x...] concatenations never built, and
the gates, blend, ReLUs and the [out | flow-x | 0] lanes applied to the f32
accumulators.  What the TPU kernels kept in VMEM slabs between their
stages (fh1, c1/f1, c2/f2, z, r*h) goes through device-memory scratch
here, so a call is several launches: K7 two (conv1 on the tensor cores,
then conv2's one output channel and the coordinate update, a warp a
pixel), K8 three (the 1x1 correlation conv and the 7x7 flow conv on the
CUDA cores, then convc2/convf2 as one 3-group conv, then the merge conv),
K9 two (z and r*h, then q and the blend).  Each call counts once.
`wgmma`/TMA and keeping the slabs on chip are later work.
"""
from __future__ import annotations

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_operands, check_status, current_stream
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


def _check_coords(what: str, coords: torch.Tensor, device, shape) -> None:
    if coords.dtype != torch.float32 or coords.device != device or not coords.is_contiguous():
        raise TypeError(f"{what}: coords must be contiguous float32 on {device}")
    if tuple(coords.shape) != tuple(shape):
        raise ValueError(f"{what}: coords {tuple(coords.shape)}, expected {tuple(shape)}")


def flow_head(h: torch.Tensor, coords: torch.Tensor, w: HeadWeights) -> torch.Tensor:
    """h (B,H,W,128), coords (B,H,W) f32 -> coords + the flow head's x-delta."""
    if h.device.type == "cpu":
        return flow_head_ref(h, coords, w)
    code = check_operands("flow_head", h, w.w1, w.w2)
    b, hh, ww, c = h.shape
    if w.w1.shape != (256, 9, c) or w.w2.shape != (9, 256) or c % _BK:
        raise ValueError(f"flow_head: h {tuple(h.shape)}, w1 {tuple(w.w1.shape)}, w2 {tuple(w.w2.shape)}")
    _check_coords("flow_head", coords, h.device, (b, hh, ww))
    fh1 = torch.empty((b, hh, ww, 256), device=h.device, dtype=h.dtype)
    out = torch.empty_like(coords)
    fn = bind(_LIB, "sa_flow_head", 8, 5)
    status = fn(h.data_ptr(), w.w1.data_ptr(), w.b1.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(), coords.data_ptr(),
                fh1.data_ptr(), out.data_ptr(), b, hh, ww, c, code, current_stream())
    check_status(_LIB, "flow_head", status)
    flow_head.launches += 1
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
