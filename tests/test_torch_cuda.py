"""The hand-written CUDA kernels K1-K4 against their plain PyTorch versions,
on the card.  Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the test conftest's fixtures, so that it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are ragged on purpose: token counts, widths and depths that are no
multiple of any tile, so the kernels' edge masks are exercised.  Tolerance:
max |kernel - plain| <= tol * max |plain|, tol 1e-5 in f32 (the same f32
arithmetic, sums in another order) and 1e-2 in bf16 (one bf16 rounding of
the output, at most 2^-8 of it, and the bf16 operands of the tensor-core
products).
"""
import numpy as np
import pytest
import torch

from stereoanywhere_tpu_torch.ops.cuda import vit_attention as port_attn
from stereoanywhere_tpu_torch.ops.cuda import vit_dense as port_dense
from stereoanywhere_tpu_torch.ops.cuda import vit_mlp as port_mlp

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dtype, *shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).cuda().to(getattr(torch, dtype))


def _check(fn, ref, args, dtype):
    launches = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    want = ref(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert scale > 0 and err <= TOL[dtype] * scale, (fn.__name__, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d,f", [(2, 37, 128, 384), (1, 150, 200, 264), (2, 101, 384, 1152), (1, 50, 768, 2304)])
def test_dense_kernels(cuda, dtype, b, t, d, f):
    rng = np.random.default_rng(t)
    x = _rand(rng, dtype, b, t, d)
    g, be = _rand(rng, dtype, d, scale=0.5, shift=1.0), _rand(rng, dtype, d, scale=0.1)
    w, bias = _rand(rng, dtype, f, d, scale=d ** -0.5), _rand(rng, dtype, f, scale=0.1)
    _check(port_dense.ln_dense, port_dense.ln_dense_ref, (x, g, be, w, bias), dtype)
    o, wp = _rand(rng, dtype, b, t, d), _rand(rng, dtype, d, d, scale=d ** -0.5)
    _check(port_dense.dense_scale_residual, port_dense.dense_scale_residual_ref, (x, o, wp, be, g), dtype)
    w2 = _rand(rng, dtype, d, f, scale=f ** -0.5)
    _check(port_mlp.vit_mlp, port_mlp.vit_mlp_ref, (x, g, be, w, bias, w2, be), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,hd", [(2, 37, 2, 64), (1, 200, 3, 128), (1, 64, 1, 64), (2, 101, 6, 64),
                                          (1, 50, 12, 64)])
def test_attention_kernel(cuda, dtype, b, t, heads, hd):
    rng = np.random.default_rng(t)
    qkv = _rand(rng, dtype, b, t, 3 * heads * hd, scale=2.0)
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,hd", [(37, 64), (101, 64), (200, 128)])
def test_attention_kernel_masks_the_key_tail(cuda, dtype, t, hd):
    # every real key scores about -4 * hd^0.5 against every query, while a
    # zero-filled key past T would score 0: without the tail mask the output
    # would collapse towards 0
    rng = np.random.default_rng(t)
    heads = 2
    d = heads * hd
    shift = np.concatenate([np.full(d, 2.0), np.full(d, -2.0), np.zeros(d)]).astype(np.float32)
    qkv = _rand(rng, dtype, 2, t, 3 * d) + torch.from_numpy(shift).cuda().to(getattr(torch, dtype))
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 5, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        port_attn.vit_attention(torch.zeros(1, 5, 192, device="cuda", dtype=torch.float16), 1)
    w = torch.zeros(64, 64, device="cuda")
    with pytest.raises(TypeError):
        port_dense.dense_scale_residual(x, x, w, w[0], w[0])
    with pytest.raises(ValueError):
        port_attn.vit_attention(torch.zeros(1, 5, 96, device="cuda"), 1)  # hd 32
