"""The port's ViT kernels K1-K4: plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU) and XLA block.  The
hand-written CUDA kernels are held against these plain versions on the card
in `test_torch_cuda.py`.

Tolerance 1e-5 in f32 on O(1) values: the same arithmetic with sums taken
in another order.
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


def test_dense_scale_residual_plain_matches_pallas(rng):
    from stereoanywhere_tpu.ops.pallas.vit_dense import dense_scale_residual

    x, _, gam, w, bias = _inputs(rng, 1, 37, 128, 128)
    o = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(dense_scale_residual(x, o, w.T, bias, gam, block_t=16, interpret=True))
    got = port_dense.dense_scale_residual(*_t(x, o, w, bias, gam)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


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
