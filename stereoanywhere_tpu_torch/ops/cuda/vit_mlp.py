"""K4 `vit_mlp`: the MLP of a ViT block without its residual.

    ffn = gelu_erf(LN(x; g, b, eps) @ W1^T + b1) @ W2^T + b2

on (B, T, D) tokens, weights in torch `nn.Linear` layout (out, in); the
LayerScale and the residual add stay outside, as in the JAX block.

Replaces the Pallas TPU kernel `stereoanywhere_tpu/ops/pallas/vit_mlp.py`
`vit_mlp` (`_mlp_kernel`).  Source: `csrc/vit_mlp.cu`.

Bound on the H100 at the ViT-L 512^2 request (M = 2 x 1370, D = 1024,
hidden 4096): 46 GFLOP against 28 MB of tokens and weights, so the products
bound it.  The TPU kernel kept the (M, 4096) hidden in VMEM and wrote only
f32 hidden-split partials.  Here the hidden goes through device memory:
keeping it on chip would need a 128 x 1024 f32 accumulator a block (more
than the register file) or product 1 recomputed for each N-split of
product 2, and the scratch costs about 13 us of traffic at 512^2 against a
46 us bound.  Two bodies, picked by dtype:
- bf16 (the deployed type), three launches (`csrc/vit_mlp.cu`): a
  LayerNorm row pass writes LN(x) rounded to bf16 (the TPU kernel's first
  rounding point, so no number changes); then two launches of the TMA +
  `wgmma` product of `csrc/gemm_wgmma.cuh`: 128 x BN tiles, BN 256, 208 or
  176 picked per product so that the tiles spread evenly over the SMs; a
  producer warpgroup keeping a ring of 3 or 4 mbarrier-guarded stages full,
  two consumer warpgroups, the output through a padded shared tile in
  16-byte rows; a persistent grid of one block an SM, launched as a
  programmatic dependent of the kernel before it.  The first product
  adds b1 and applies gelu in its epilogue into an (M, hidden) bf16
  scratch (the second rounding point), the second adds b2.  The gelu's erf
  is the TPU kernel's Abramowitz-Stegun polynomial (1.5e-7 from the exact
  erf of the plain version);
- f32 (the check type): two launches of the FP32 FMA tile of
  `csrc/gemm_tile.cuh`, LayerNorm in the first one's prologue.
The launch counter counts one per call of the wrapper.
"""
from __future__ import annotations

import ctypes
import math

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import (
    bind, check_depth, check_operands, check_status, current_stream, library,
)
from stereoanywhere_tpu_torch.ops.cuda.vit_dense import _layer_norm_f32

_LIB = "vit_mlp"


def layer_norm_rows_ref(x, g, b, eps: float = 1e-6, dtype=None):
    """Plain version of the bf16 body's LayerNorm pass: two-pass f32
    statistics, the result rounded to `dtype` (x's by default)."""
    return _layer_norm_f32(x, g, b, eps).to(dtype or x.dtype)


def vit_mlp_ref(x, g, b, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain version of K4: LN output and gelu output rounded to the weights'
    dtype before each product, f32 sums, output in x's dtype."""
    h = layer_norm_rows_ref(x, g, b, eps, w1.dtype).float()
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
    # LN(x) for the bf16 body's row pass (the f32 body normalises in its prologue)
    ln = torch.empty_like(x) if x.dtype == torch.bfloat16 else x
    scratch = torch.empty((bt * t, hidden), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    fn = bind(_LIB, "sa_vit_mlp", 10, 4, 1)
    status = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), ln.data_ptr(), scratch.data_ptr(), out.data_ptr(), bt * t, d, hidden, code, eps,
                current_stream())
    check_status(_LIB, "vit_mlp", status)
    vit_mlp.launches += 1
    return out


vit_mlp.launches = 0


def launch_geometry(m: int, d: int, hidden: int) -> dict:
    """The bf16 body's launches at these shapes, as the library computes
    them: the LN pass's blocks and threads; for each product its tile width
    BN (tiles are 128 x BN), tiles, blocks of its persistent grid and
    dynamic shared memory; the products' threads."""
    lib = library(_LIB)
    fn = lib.sa_vit_mlp_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 11)()
    check_status(_LIB, "vit_mlp geometry", fn(m, d, hidden, out))
    products = [dict(bn=out[2 + 4 * p], tiles=out[3 + 4 * p], blocks=out[4 + 4 * p], smem=out[5 + 4 * p])
                for p in range(2)]
    return dict(ln_blocks=out[0], ln_threads=out[1], products=products, threads=out[10])
