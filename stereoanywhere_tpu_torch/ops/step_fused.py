"""The rotated refinement step's shape gate, weight packing and plain versions.

The port's counterpart of the non-kernel half of the JAX package's
`ops/pallas/step_fused.py`.  The kernels themselves (K7 flow head, K8
motion encoder, K9 ConvGRU) are in `ops/cuda/step_fused.py`; the functions
here are what they compute, in plain PyTorch, on NHWC tensors:

- `flow_head_ref`: coords + conv2(relu(conv1(h))), the x output only;
- `motion_encoder_ref`: [relu(_conv([c2(c1(corr_a)), c2(c1(corr_b)),
  f2(f1(flow-x))])) | flow-x | 0], convc1/convc2 shared by the two
  correlation streams, convf1 on flow-x alone (flow-y is structurally
  zero);
- `conv_gru_ref`: the ConvGRU over [h, x...] with the context injections.

They keep the TPU kernels' rounding points: sums in f32, and each stage
output that the TPU kernel stores in a compute-dtype slab (fh1, c1, c2,
flo1, flo2, z, r*h) rounded to the compute dtype.

Weights are packed once per model and dtype (`models/update.py`
`MultiUpdateBlock.fused_weights`) in the layout the kernels read: a conv
weight (O, I, k, k) becomes (O, k*k, I), so that its K index is
tap * I + c; biases are f32.  The TPU's 128-lane padding, its tap-stacked
flow head and the caller-built flow columns (`make_flowcols`) are TPU
layout and have no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

R = 8  # rows per band of the TPU kernels; the shape gate keeps their rule


def fused_step_supported(shape) -> bool:
    """The JAX package's shape gate (8-row bands, at least 2 of them,
    8-aligned widths, 128 hidden channels) on an NHWC shape (B, H4, W4, C)."""
    _, ht, w2, ch = shape
    return ht % R == 0 and ht // R >= 2 and w2 % 8 == 0 and ch == 128


class HeadWeights(NamedTuple):
    w1: torch.Tensor  # (256, 9, 128) conv1
    b1: torch.Tensor  # (256,) f32
    w2: torch.Tensor  # (9, 256) conv2's x output: tap, channel
    b2: torch.Tensor  # (1,) f32


class MotionWeights(NamedTuple):
    w_c1: torch.Tensor  # (64, 36) convc1
    b_c1: torch.Tensor  # (64,) f32
    w_f1: torch.Tensor  # (64, 49) convf1 on flow-x: tap dy * 7 + dx
    b_f1: torch.Tensor  # (64,) f32
    w_c2f2: torch.Tensor  # (192, 9, 64): [convc2; convc2; convf2], a 3-group conv
    b_c2f2: torch.Tensor  # (192,) f32
    w_mc: torch.Tensor  # (128, 9, 192) _conv, output rows 126 and 127 zero
    b_mc: torch.Tensor  # (128,) f32, last two zero


class GruWeights(NamedTuple):
    w_zr: torch.Tensor  # (2 hd, 9, hd + Cx): [convz; convr] over [h, x...]
    b_zr: torch.Tensor  # (2 hd,) f32
    w_q: torch.Tensor  # (hd, 9, hd + Cx) convq over [r*h, x...]
    b_q: torch.Tensor  # (hd,) f32


class FusedWeights(NamedTuple):
    head: HeadWeights
    motion: MotionWeights
    gru: tuple  # GruWeights of gru08, gru16, gru32


def _taps(w: torch.Tensor, dtype) -> torch.Tensor:
    """(O, I, k, k) -> (O, k*k, I), contiguous, in dtype."""
    o, i, kh, kw = w.shape
    return w.detach().permute(0, 2, 3, 1).reshape(o, kh * kw, i).to(dtype).contiguous()


def _f32(b: torch.Tensor) -> torch.Tensor:
    return b.detach().float().contiguous()


def pack_head_weights(conv1: torch.nn.Conv2d, conv2: torch.nn.Conv2d, dtype) -> HeadWeights:
    return HeadWeights(
        w1=_taps(conv1.weight, dtype), b1=_f32(conv1.bias),
        w2=_taps(conv2.weight[:1], dtype)[0].contiguous(), b2=_f32(conv2.bias[:1]),
    )


def pack_motion_weights(enc, dtype) -> MotionWeights:
    """`enc`: the port's MotionEncoder (convc1, convc2, convf1, convf2, _conv)."""
    c2, f2 = _taps(enc.convc2.weight, dtype), _taps(enc.convf2.weight, dtype)
    mc = _taps(enc._conv.weight, dtype)
    pad = torch.zeros((2, *mc.shape[1:]), dtype=dtype, device=mc.device)
    return MotionWeights(
        w_c1=enc.convc1.weight.detach()[:, :, 0, 0].to(dtype).contiguous(), b_c1=_f32(enc.convc1.bias),
        w_f1=enc.convf1.weight.detach()[:, 0].reshape(64, 49).to(dtype).contiguous(), b_f1=_f32(enc.convf1.bias),
        w_c2f2=torch.cat([c2, c2, f2]).contiguous(),
        b_c2f2=_f32(torch.cat([enc.convc2.bias, enc.convc2.bias, enc.convf2.bias])),
        w_mc=torch.cat([mc, pad]).contiguous(),
        b_mc=_f32(F.pad(enc._conv.bias.detach(), (0, 2))),
    )


def pack_gru_weights(gru, dtype) -> GruWeights:
    """`gru`: the port's ConvGRU (convz, convr, convq over [h, x...])."""
    return GruWeights(
        w_zr=torch.cat([_taps(gru.convz.weight, dtype), _taps(gru.convr.weight, dtype)]).contiguous(),
        b_zr=_f32(torch.cat([gru.convz.bias, gru.convr.bias])),
        w_q=_taps(gru.convq.weight, dtype), b_q=_f32(gru.convq.bias),
    )


def pack_gru_hwio(wzr, bzr, wq, bq, dtype) -> GruWeights:
    """The K6 interface's weights: HWIO kernels over [h, x] (the JAX
    layout), biases rounded to the dtype as the TPU kernel does."""
    def taps(w):
        kh, kw, i, o = w.shape
        return w.permute(3, 0, 1, 2).reshape(o, kh * kw, i).to(dtype).contiguous()

    return GruWeights(taps(wzr), bzr.to(dtype).float().contiguous(), taps(wq), bq.to(dtype).float().contiguous())


# ---------------------------------------------------------------------------
# plain versions (NHWC)


def _conv(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Same-padded conv of NHWC x (f32) with packed w (O, k*k, I): f32 NHWC."""
    o, taps, i = w.shape
    k = int(round(taps ** 0.5))
    wt = w.float().reshape(o, k, k, i).permute(0, 3, 1, 2)
    return F.conv2d(x.permute(0, 3, 1, 2), wt, padding=k // 2, groups=groups).permute(0, 2, 3, 1)


def flow_x(coords: torch.Tensor, dtype) -> torch.Tensor:
    """coords (B,H,W) f32 -> coords - x, rounded to dtype."""
    x = torch.arange(coords.shape[-1], device=coords.device, dtype=torch.float32)
    return (coords - x).to(dtype)


def flow_head_ref(h: torch.Tensor, coords: torch.Tensor, w: HeadWeights) -> torch.Tensor:
    """Plain version of K7: h (B,H,W,128), coords (B,H,W) f32 -> coords + delta-x."""
    fh1 = torch.relu(_conv(h.float(), w.w1) + w.b1).to(h.dtype)
    delta = _conv(fh1.float(), w.w2.reshape(1, 9, -1))[..., 0]
    return coords + (delta + w.b2)


def motion_encoder_ref(corr_a: torch.Tensor, corr_b: torch.Tensor, coords: torch.Tensor,
                       w: MotionWeights) -> torch.Tensor:
    """Plain version of K8: corr_* (B,H,W,36), coords (B,H,W) f32 ->
    (B,H,W,128) = [126 encoder channels | flow-x | 0] in corr's dtype."""
    dt = corr_a.dtype
    fx = flow_x(coords, dt)
    c1 = [torch.relu(c.float() @ w.w_c1.float().t() + w.b_c1).to(dt) for c in (corr_a, corr_b)]
    f1 = torch.relu(_conv(fx[..., None].float(), w.w_f1.reshape(64, 49, 1)) + w.b_f1).to(dt)
    a2 = torch.relu(_conv(torch.cat([*c1, f1], dim=-1).float(), w.w_c2f2, groups=3) + w.b_c2f2).to(dt)
    mo = torch.relu(_conv(a2.float(), w.w_mc) + w.b_mc)
    mo = torch.cat([mo[..., :126], fx[..., None].float(), torch.zeros_like(mo[..., :1])], dim=-1)
    return mo.to(dt)


def conv_gru_ref(h: torch.Tensor, xs, czrq: torch.Tensor, w: GruWeights, inj=None) -> torch.Tensor:
    """Plain version of K9: h (B,H,W,hd), xs list of (B,H,W,C) inputs,
    czrq (B,H,W,3 hd) = [cz | cr | cq] (or `inj` = (cz, cr, cq) apart) -> h'."""
    dt, hd = h.dtype, h.shape[-1]
    cz, cr, cq = inj if inj is not None else (czrq[..., :hd], czrq[..., hd:2 * hd], czrq[..., 2 * hd:])
    zr = _conv(torch.cat([h, *xs], dim=-1).float(), w.w_zr) + w.b_zr
    z = torch.sigmoid(zr[..., :hd] + cz.float()).to(dt)
    rh = (torch.sigmoid(zr[..., hd:] + cr.float()) * h.float()).to(dt)
    q = torch.tanh(_conv(torch.cat([rh, *xs], dim=-1).float(), w.w_q) + w.b_q + cq.float())
    zf = z.float()
    return ((1 - zf) * h.float() + zf * q).to(dt)
