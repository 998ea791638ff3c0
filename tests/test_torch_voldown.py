"""`vol_downsample`: the model's mono volume and hourglass at 1/2^v of the
quarter-resolution volume, on the CPU, against the JAX package.

`resize_nearest` equals JAX's exactly (the same f32 index rule).  The
model with `vol_downsample=1` at 64 x 64 (the size of JAX's own
`tests/test_serve.py::test_vol_downsample_config`) and 64 x 128: in f32
with 2 iterations within 1e-3 px + 5e-5 rel. (the pipeline tests' bound
and iterations; at 4 iterations the default model already moves past it,
its f32 sums taken in other orders), and its coarse mono disparity and
confidence within 1e-4 + 1e-5 rel.; in bf16 with 4 iterations the port's
output lies at most twice as far from JAX's bf16 output as that lies from
JAX's f32 output, as `tests/test_torch_bf16.py` holds the default model.
Weights: JAX's init, loaded through `compat.from_jax`.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(2)

KEYS = ("disparity", "coarse_dispmono2", "coarse_conf2")


@pytest.mark.parametrize("n,h_in,w_in,h_out,w_out", [(2, 16, 16, 8, 8), (1, 17, 24, 8, 12), (3, 13, 10, 5, 7),
                                                     (2, 8, 6, 16, 9), (1, 1000, 520, 333, 260)])
def test_resize_nearest_matches_jax(n, h_in, w_in, h_out, w_out):
    from stereoanywhere_tpu.ops.interp import resize_nearest as jnearest

    from stereoanywhere_tpu_torch.ops.interp import resize_nearest

    x = np.random.default_rng(h_in).standard_normal((1, n, h_in, w_in)).astype(np.float32)
    got = resize_nearest(torch.from_numpy(x), (h_out, w_out)).numpy()
    want = np.asarray(jnearest(jnp.asarray(x.transpose(0, 2, 3, 1)), (h_out, w_out))).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, want)


def test_vol_downsample_config():
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig

    assert StereoAnywhereConfig().vol_downsample == 0
    with pytest.raises(ValueError):
        StereoAnywhereConfig(vol_downsample=-1)


def _gap(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def weights():
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    z3, z1 = np.zeros((1, 64, 96, 3), np.float32), np.zeros((1, 64, 96, 1), np.float32)
    v = jax.jit(lambda k: JSA(JCfg()).init(k, z3, z3, z1, z1, iters=1, test_mode=True))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


def _jax(cfg, variables, ins, iters):
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    m = JSA(cfg)
    out = jax.jit(lambda v, *a: m.apply(v, *a, iters=iters, test_mode=True))(variables, *ins)
    return {k: np.asarray(out[k], np.float32) for k in KEYS}


def _port(cfg, variables, ins, iters):
    from stereoanywhere_tpu_torch.compat.from_jax import load_stereo_variables
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    model = load_stereo_variables(StereoAnywhere(cfg, device="cpu"), variables)
    out = model(*map(torch.from_numpy, ins), iters=iters)
    return {k: out[k].float().numpy() for k in KEYS}


def _inputs(h, w):
    rng = np.random.default_rng(h + w)
    return tuple(rng.uniform(0, 1, (1, h, w, c)).astype(np.float32) for c in (3, 3, 1, 1))


@pytest.mark.parametrize("h,w", [(64, 64), (64, 128)])
def test_voldown_model_matches_jax(weights, h, w):
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig

    ins = _inputs(h, w)
    want = _jax(JCfg(vol_downsample=1), weights, ins, 2)
    got = _port(StereoAnywhereConfig(vol_downsample=1), weights, ins, 2)
    assert got["disparity"].shape == (1, h, w, 1) and np.isfinite(got["disparity"]).all()
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=5e-5, atol=1e-3)
    for k in ("coarse_dispmono2", "coarse_conf2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)
    # the option changes the function: the default model differs
    plain = _port(StereoAnywhereConfig(), weights, ins, 2)
    assert np.abs(plain["coarse_dispmono2"] - got["coarse_dispmono2"]).max() > 1e-2


def test_voldown_model_bf16_within_twice_jax_gap(weights):
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig

    ins = _inputs(64, 64)
    want32 = _jax(JCfg(vol_downsample=1), weights, ins, 4)
    bf16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32 else a, weights)
    want16 = _jax(JCfg(vol_downsample=1, compute_dtype="bfloat16"), bf16, ins, 4)
    got = _port(StereoAnywhereConfig(vol_downsample=1, compute_dtype="bfloat16"), weights, ins, 4)
    for k in ("disparity", "coarse_dispmono2"):
        assert np.isfinite(got[k]).all()
        assert _gap(got[k], want16[k]) <= 2 * _gap(want16[k], want32[k]), k
