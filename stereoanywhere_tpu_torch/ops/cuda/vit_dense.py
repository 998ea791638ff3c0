"""K1 `ln_dense` and K3 `dense_scale_residual`: the Dense side of a ViT block.

    ln_dense:             qkv = LN(x; g, b, eps) @ W^T + bias
    dense_scale_residual: x'  = x + gamma * (o @ W^T + bias)

on (B, T, D) tokens, with W in torch `nn.Linear` layout (out, in).

Replaces the Pallas TPU kernels `stereoanywhere_tpu/ops/pallas/vit_dense.py`
`ln_dense` (`_ln_dense_kernel`) and `dense_scale_residual`
(`_dense_sr_kernel`).  Source: `csrc/vit_dense.cu`.

Bound on the H100 at the ViT-L 512^2 request (M = 2 x 1370 tokens): both
are matrix products well above the card's ridge (K1: 17.2 GFLOP for 29 MB
moved, K3: 5.75 GFLOP for 19 MB), so tensor-core FLOP/s bound them.  Two
bodies each, picked by dtype; both bf16 bodies run on one product core:
- K1 in bf16 (the deployed type), two launches, the first half of K4's
  body (`csrc/vit_mlp.cu`) with a bias epilogue: the LayerNorm row pass of
  `csrc/ln_rows.cuh` writes LN(x) rounded to bf16 into an (M, D) scratch
  (the TPU kernel's rounding point, so no number changes; 5-6 us of
  traffic at 512^2 against the product's 17 us bound), then the persistent
  TMA + `wgmma` product of `csrc/gemm_wgmma.cuh` (128 x BN tiles, BN picked
  so the tiles spread evenly over the SMs: 256 at 512^2, 264 tiles in two
  full rounds; 176 at 375x1242) adds the bias, launched as a programmatic
  dependent of the row pass;
- K3 in bf16, one launch: the same `gemm_wgmma.cuh` product (BN 176 at
  512^2, 132 tiles in one round; 208 at 375x1242, 360 tiles in 2.7) with
  the bias, LayerScale and residual in its epilogue: x + gamma * y in f32
  from the accumulators, x read as bf16 pairs at each thread's own rows
  and columns (rows past M masked), rounded to bf16 once, the TPU
  kernel's one rounding point;
- f32 (the check type): FP32 FMA tiles of `csrc/gemm_tile.cuh` (64x64, 4x4
  per thread), which keep the full f32 product; K1 normalises each A tile
  in its prologue.
"""
from __future__ import annotations

import ctypes

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import (
    bind, check_depth, check_operands, check_status, current_stream, library,
)

_LIB = "vit_dense"


def _layer_norm_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass f32 LayerNorm, the kernels' statistics."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g.float() + b.float()


def ln_dense_ref(x, g, b, w, bias, eps: float = 1e-6):
    """Plain version of K1: the LN output is rounded to W's dtype before the
    product (as the TPU kernel does), sums in f32, output in x's dtype."""
    h = _layer_norm_f32(x, g, b, eps).to(w.dtype).float()
    return (h @ w.float().t() + bias.float()).to(x.dtype)


def dense_scale_residual_ref(x, o, w, bias, gamma):
    """Plain version of K3: f32 product and epilogue, output in x's dtype."""
    y = o.float() @ w.float().t() + bias.float()
    return (x.float() + gamma.float() * y).to(x.dtype)


def ln_dense(x, g, b, w, bias, eps: float = 1e-6):
    """LN(x) @ w^T + bias: x (B, T, D), w (F, D) -> (B, T, F)."""
    if x.device.type == "cpu":
        return ln_dense_ref(x, g, b, w, bias, eps)
    code = check_operands("ln_dense", x, g, b, w, bias)
    bt, t, d = x.shape
    f = w.shape[0]
    if w.shape != (f, d) or g.shape != (d,) or b.shape != (d,) or bias.shape != (f,):
        raise ValueError(f"ln_dense: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    check_depth("ln_dense", x.dtype, d)
    # LN(x) for the bf16 body's row pass (the f32 body normalises in its prologue)
    ln = torch.empty_like(x) if x.dtype == torch.bfloat16 else x
    out = torch.empty((bt, t, f), device=x.device, dtype=x.dtype)
    fn = bind(_LIB, "sa_ln_dense", 7, 4, 1)
    status = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(), ln.data_ptr(),
                out.data_ptr(), bt * t, d, f, code, eps, current_stream())
    check_status(_LIB, "ln_dense", status)
    ln_dense.launches += 1
    return out


def dense_scale_residual(x, o, w, bias, gamma):
    """x + gamma * (o @ w^T + bias): x, o (B, T, D), w (D, D)."""
    if x.device.type == "cpu":
        return dense_scale_residual_ref(x, o, w, bias, gamma)
    code = check_operands("dense_scale_residual", x, o, w, bias, gamma)
    bt, t, d = x.shape
    if o.shape != x.shape or w.shape != (d, d) or bias.shape != (d,) or gamma.shape != (d,):
        raise ValueError(f"dense_scale_residual: bad shapes x{tuple(x.shape)} o{tuple(o.shape)} w{tuple(w.shape)}")
    check_depth("dense_scale_residual", x.dtype, d)
    out = torch.empty_like(x)
    fn = bind(_LIB, "sa_dense_scale_residual", 6, 4)
    status = fn(x.data_ptr(), o.data_ptr(), w.data_ptr(), bias.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                bt * t, d, d, code, current_stream())
    check_status(_LIB, "dense_scale_residual", status)
    dense_scale_residual.launches += 1
    return out


ln_dense.launches = 0
dense_scale_residual.launches = 0


def launch_geometry(m: int, f: int) -> dict:
    """K1's bf16 launches at M tokens and F outputs, as the library computes
    them: the LN pass's blocks and threads; the product's tile width BN
    (tiles are 128 x BN), tiles, blocks of its persistent grid, dynamic
    shared memory and threads."""
    fn = library(_LIB).sa_ln_dense_geometry
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    check_status(_LIB, "ln_dense geometry", fn(m, f, out))
    return dict(ln_blocks=out[0], ln_threads=out[1], bn=out[2], tiles=out[3], blocks=out[4], smem=out[5],
                threads=out[6])


def residual_geometry(m: int, d: int) -> dict:
    """K3's bf16 launch at M tokens and width D, as the library computes it:
    the product's tile width BN (tiles are 128 x BN), tiles, blocks of its
    persistent grid, dynamic shared memory and threads."""
    fn = library(_LIB).sa_dense_scale_residual_geometry
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    check_status(_LIB, "dense_scale_residual geometry", fn(m, d, out))
    return dict(bn=out[0], tiles=out[1], blocks=out[2], smem=out[3], threads=out[4])
