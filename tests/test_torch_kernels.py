"""The port's ViT kernels K1-K4: plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU) and XLA block.  The
hand-written CUDA kernels are held against these plain versions on the card
in `test_torch_cuda.py`.

Tolerance 1e-5 in f32 on O(1) values: the same arithmetic with sums taken
in another order.  In bf16, max |port - JAX| <= 1e-2 max |JAX|, the card's
bf16 tolerance: both round the output to bf16 (2^-8 of it), and they round
their intermediates at the same points but from f32 values summed in
another order (and, for attention, the JAX kernel sums the rounded P where
the port sums the f32 one), so an intermediate may differ by one bf16 ulp.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.ops.cuda import vit_attention as port_attn
from stereoanywhere_tpu_torch.ops.cuda import vit_dense as port_dense
from stereoanywhere_tpu_torch.ops.cuda import vit_mlp as port_mlp

torch.set_num_threads(2)
ATOL = RTOL = 1e-5


def _inputs(rng, b, t, d, f):
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    g = (1 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    be = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (rng.standard_normal((f, d)) / np.sqrt(d)).astype(np.float32)  # torch (out, in)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    return x, g, be, w, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_ln_dense_plain_matches_pallas(rng):
    from stereoanywhere_tpu.ops.pallas.vit_dense import ln_dense

    x, g, be, w, bias = _inputs(rng, 1, 37, 128, 384)
    want = np.asarray(ln_dense(x, g, be, w.T, bias, block_t=16, interpret=True))
    got = port_dense.ln_dense(*_t(x, g, be, w, bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ln_dense_plain_matches_pallas_bf16(rng):
    """K1 in bf16: LN in f32, its output rounded to bf16 for the product,
    the f32 sum plus bias rounded once; ViT-S's width (D 384, F 3D)."""
    from stereoanywhere_tpu.ops.pallas.vit_dense import ln_dense

    x, g, be, w, bias = _inputs(rng, 2, 37, 384, 1152)
    want = ln_dense(*[jnp.asarray(a, jnp.bfloat16) for a in (x, g, be, w.T, bias)], block_t=16, interpret=True)
    got = port_dense.ln_dense(*[a.bfloat16() for a in _t(x, g, be, w, bias)])
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_scale_residual_plain_matches_pallas(rng, dtype):
    """K3; in bf16 the rounding point the card's kernel keeps: x + gamma y
    in f32 from the f32 product, rounded to bf16 once."""
    from stereoanywhere_tpu.ops.pallas.vit_dense import dense_scale_residual

    x, _, gam, w, bias = _inputs(rng, 1, 37, 128, 128)
    o = rng.standard_normal(x.shape).astype(np.float32)
    if dtype == "float32":
        want = np.asarray(dense_scale_residual(x, o, w.T, bias, gam, block_t=16, interpret=True))
        got = port_dense.dense_scale_residual(*_t(x, o, w, bias, gam)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, o, w.T, bias, gam)]
    want = dense_scale_residual(*jb, block_t=16, interpret=True)
    got = port_dense.dense_scale_residual(*[a.bfloat16() for a in _t(x, o, w, bias, gam)])
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("heads,hd", [(2, 64), (1, 128)])
def test_vit_attention_plain_matches_pallas(rng, heads, hd):
    from stereoanywhere_tpu.ops.pallas.vit_attention import vit_attention

    b, t, d = 1, 37, heads * hd
    qkv = rng.standard_normal((b, t, 3 * d)).astype(np.float32)
    want = np.asarray(vit_attention(jnp.asarray(qkv), heads, interpret=True))
    q, k, v = (jnp.asarray(qkv[..., i * d:(i + 1) * d].reshape(b, t, heads, hd)) for i in range(3))
    xla = np.asarray(jax.nn.dot_product_attention(q, k, v).reshape(b, t, d))
    got = port_attn.vit_attention(torch.from_numpy(qkv), heads).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)


def _bf16_close(got, want, rel=1e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("t", [129, 200])
def test_vit_attention_plain_matches_pallas_across_tiles(rng, t):
    """T past one and two 128-key tiles of the card's kernel (heads 2, hd 64)."""
    from stereoanywhere_tpu.ops.pallas.vit_attention import vit_attention

    heads, hd = 2, 64
    qkv = rng.standard_normal((1, t, 3 * heads * hd)).astype(np.float32)
    want = np.asarray(vit_attention(jnp.asarray(qkv), heads, interpret=True))
    got = port_attn.vit_attention(torch.from_numpy(qkv), heads).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vit_attention_plain_matches_pallas_bf16(rng):
    from stereoanywhere_tpu.ops.pallas.vit_attention import vit_attention

    heads, hd, t = 2, 64, 200
    qkv = (2.0 * rng.standard_normal((2, t, 3 * heads * hd))).astype(np.float32)
    want = vit_attention(jnp.asarray(qkv, jnp.bfloat16), heads, interpret=True)
    got = port_attn.vit_attention(torch.from_numpy(qkv).bfloat16(), heads)
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_mlp_plain_matches_pallas_vit_s(rng, dtype):
    """ViT-S widths (D 384, hidden 1536; 384 is no multiple of the card's
    128-column tile), T = 37 ragged."""
    from stereoanywhere_tpu.ops.pallas.vit_mlp import vit_mlp

    x, g, be, w1, b1 = _inputs(rng, 1, 37, 384, 1536)
    w2 = (rng.standard_normal((384, 1536)) / np.sqrt(1536)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(384)).astype(np.float32)
    args = (x, g, be, w1, b1, w2, b2)
    if dtype == "float32":
        want = np.asarray(vit_mlp(x, g, be, w1.T, b1, w2.T, b2, block_t=16, interpret=True))
        got = port_mlp.vit_mlp(*_t(*args)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, g, be, w1.T, b1, w2.T, b2)]
    want = vit_mlp(*jb, block_t=16, interpret=True)
    got = port_mlp.vit_mlp(*[a.bfloat16() for a in _t(*args)])
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [384, 1024])
def test_layer_norm_rows_plain_matches_flax(rng, dtype, d):
    """The bf16 MLP body's LayerNorm pass: flax LayerNorm(epsilon=1e-6) in
    f32; rounded to bf16, within one bf16 ulp (2^-8 relative) of it."""
    import flax.linen as nn

    x, g, be, _, _ = _inputs(rng, 2, 37, d, 8)
    ln = nn.LayerNorm(epsilon=1e-6)
    want = np.asarray(ln.apply({"params": {"scale": g, "bias": be}}, x))
    got = port_mlp.layer_norm_rows_ref(*_t(x, g, be), 1e-6, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)


def test_vit_mlp_plain_matches_pallas(rng):
    from stereoanywhere_tpu.ops.pallas.vit_mlp import vit_mlp

    x, g, be, w1, b1 = _inputs(rng, 1, 37, 128, 512)
    w2 = (rng.standard_normal((128, 512)) / np.sqrt(512)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(128)).astype(np.float32)
    want = np.asarray(vit_mlp(x, g, be, w1.T, b1, w2.T, b2, block_t=16, interpret=True))
    got = port_mlp.vit_mlp(*_t(x, g, be, w1, b1, w2, b2)).numpy()
    # the Pallas kernel's erf is the A&S polynomial (1.5e-7 abs): same tolerance
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_block_matches_xla_block(rng):
    """A whole port Block (K1-K4 plain versions) against the JAX block's
    XLA path (flax LayerNorm / Dense / dot_product_attention)."""
    from stereoanywhere_tpu.models.dinov2 import Block as JBlock

    from stereoanywhere_tpu_torch.models.dinov2 import Block

    d, heads = 128, 2
    x = rng.standard_normal((1, 37, d)).astype(np.float32)
    jb = JBlock(heads)
    p = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0), x))["params"]
    p = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), p)  # non-trivial norms
    want = np.asarray(jb.apply({"params": p}, x))

    blk = Block(d, heads)
    with torch.no_grad():
        for norm in ("norm1", "norm2"):
            getattr(blk, norm).weight.copy_(torch.from_numpy(p[norm]["scale"]))
            getattr(blk, norm).bias.copy_(torch.from_numpy(p[norm]["bias"]))
        for mod, sub in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            lin = getattr(getattr(blk, mod), sub)
            lin.weight.copy_(torch.from_numpy(p[mod][sub]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(p[mod][sub]["bias"]))
        blk.ls1.gamma.copy_(torch.from_numpy(p["ls1"]["gamma"]))
        blk.ls2.gamma.copy_(torch.from_numpy(p["ls2"]["gamma"]))
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    x, g, be, w, bias = _t(*_inputs(rng, 1, 5, 64, 192))
    before = (port_dense.ln_dense.launches, port_attn.vit_attention.launches)
    qkv = port_dense.ln_dense(x, g, be, w, bias)
    port_attn.vit_attention(qkv, 1)
    assert (port_dense.ln_dense.launches, port_attn.vit_attention.launches) == before
