"""K1 `ln_dense` and K3 `dense_scale_residual`: the Dense side of a ViT block.

    ln_dense:             qkv = LN(x; g, b, eps) @ W^T + bias
    dense_scale_residual: x'  = x + gamma * (o @ W^T + bias)

on (B, T, D) tokens, with W in torch `nn.Linear` layout (out, in).

Replaces the Pallas TPU kernels `stereoanywhere_tpu/ops/pallas/vit_dense.py`
`ln_dense` (`_ln_dense_kernel`) and `dense_scale_residual`
(`_dense_sr_kernel`).  Source: `csrc/vit_dense.cu`.

Bound on the H100 at the ViT-L 512^2 request (M = 2 x 1370 tokens): both
are matrix products well above the card's ridge (K1: 17.2 GFLOP for 29 MB
moved, K3: 5.75 GFLOP for 19 MB), so tensor-core FLOP/s bound them.  The
design keeps LayerNorm inside the product's prologue (each block computes
its rows' f32 statistics, then normalizes each A tile on its way to the
products) and the bias, LayerScale and residual in its epilogue, so neither
the normalized activations nor the un-scaled product ever reach device
memory.  In bf16
(the deployed type) the product runs on the tensor cores through `mma.sync`
m16n8k16 (128x128 block tile, 8 warps, K in steps of 64 through a 3-stage
cp.async ring, LN applied to each A tile in shared memory); in f32 it runs
as FP32 FMA tiles (64x64, 4x4 per thread), which keep the full f32 product.
`wgmma`/TMA pipelines are later work.
"""
from __future__ import annotations

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_depth, check_operands, check_status, current_stream

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
    out = torch.empty((bt, t, f), device=x.device, dtype=x.dtype)
    fn = bind(_LIB, "sa_ln_dense", 6, 4, 1)
    status = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                bt * t, d, f, code, eps, current_stream())
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
