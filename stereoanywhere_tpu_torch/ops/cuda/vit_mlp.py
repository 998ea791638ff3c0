"""K4 `vit_mlp`: the MLP of a ViT block without its residual.

    ffn = gelu_erf(LN(x; g, b, eps) @ W1^T + b1) @ W2^T + b2

on (B, T, D) tokens, weights in torch `nn.Linear` layout (out, in); the
LayerScale and the residual add stay outside, as in the JAX block.

Replaces the Pallas TPU kernel `stereoanywhere_tpu/ops/pallas/vit_mlp.py`
`vit_mlp` (`_mlp_kernel`).  Source: `csrc/vit_mlp.cu`.

Bound on the H100 at the ViT-L 512^2 request (M = 2 x 1370, D = 1024,
hidden 4096): 46 GFLOP against 28 MB of tokens and weights, so the products
bound it.  The TPU kernel kept the (M, 4096) hidden in VMEM and wrote only
f32 hidden-split partials.  This first version does NOT: it runs as two
launches of one tiled product through a scratch buffer in device memory,
(1) LN prologue + W1 + b1 + exact-erf gelu (`erff`) epilogue into an
(M, 4096) hidden of W's dtype -- the rounding the TPU kernel applies before
its second product -- and (2) hidden @ W2^T + b2.  The scratch costs
2 x 22 MB (bf16) of extra traffic per call; keeping it on chip is later
work.  Both products are the tiled product of `vit_dense` (`mma.sync`
tensor-core tiles in bf16, FP32 FMA tiles in f32).  The launch counter
counts one per call of the wrapper.
"""
from __future__ import annotations

import math

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_depth, check_operands, check_status, current_stream
from stereoanywhere_tpu_torch.ops.cuda.vit_dense import _layer_norm_f32

_LIB = "vit_mlp"


def vit_mlp_ref(x, g, b, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain version of K4: LN output and gelu output rounded to the weights'
    dtype before each product, f32 sums, output in x's dtype."""
    h = _layer_norm_f32(x, g, b, eps).to(w1.dtype).float()
    a = h @ w1.float().t() + b1.float()
    a = (0.5 * a * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0))))).to(w2.dtype).float()
    return (a @ w2.float().t() + b2.float()).to(x.dtype)


def vit_mlp(x, g, b, w1, b1, w2, b2, eps: float = 1e-6):
    """gelu(LN(x) @ w1^T + b1) @ w2^T + b2: x (B, T, D), w1 (Hd, D), w2 (D, Hd)."""
    if x.device.type == "cpu":
        return vit_mlp_ref(x, g, b, w1, b1, w2, b2, eps)
    code = check_operands("vit_mlp", x, g, b, w1, b1, w2, b2)
    bt, t, d = x.shape
    hidden = w1.shape[0]
    if w1.shape != (hidden, d) or w2.shape != (d, hidden) or b1.shape != (hidden,) or b2.shape != (d,):
        raise ValueError(f"vit_mlp: bad shapes x{tuple(x.shape)} w1{tuple(w1.shape)} w2{tuple(w2.shape)}")
    check_depth("vit_mlp", x.dtype, d, hidden)
    scratch = torch.empty((bt * t, hidden), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    fn = bind(_LIB, "sa_vit_mlp", 9, 4, 1)
    status = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), scratch.data_ptr(), out.data_ptr(), bt * t, d, hidden, code, eps,
                current_stream())
    check_status(_LIB, "vit_mlp", status)
    vit_mlp.launches += 1
    return out


vit_mlp.launches = 0
