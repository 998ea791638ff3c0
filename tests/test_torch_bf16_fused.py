"""The fused configuration in bf16: the port's `fused_level0="on"` forward
against the JAX package's `fused_level0="interpret"` forward (its Pallas
step kernels run in interpret mode), both in bf16 with the same weights,
on the CPU.

256x128 with 4 iterations: JAX's ConvGRU kernel reads a 10-row halo slab
at each of the cascade's three planes, and the 1/16 plane of a 64-row
image has 4 rows, so JAX's fused forward does not trace below 160 rows
(JAX's own `test_fused_level0_matches_xla_forward`, at 64x64, is marked
xfail).  Tolerance as in `test_torch_bf16.py`: twice JAX's own distance from
its f32 forward, which cannot fuse (JAX's gate fuses bf16 only).  Measured
here: 0.105 against JAX's own 0.145.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat import from_jax

torch.set_num_threads(2)


def test_fused_model_bf16_matches_jax_fused_bf16():
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    rng = np.random.default_rng(12)
    ins = tuple(rng.uniform(0, 1, (1, 256, 128, c)).astype(np.float32) for c in (3, 3, 1, 1))
    sv = jax.tree.map(np.asarray, jax.jit(lambda k: JSA(JCfg()).init(k, *ins, iters=1, test_mode=True))(
        jax.random.PRNGKey(0)))
    sv16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, sv)

    def jax_run(cfg, v):
        m = JSA(cfg)
        return np.asarray(jax.jit(lambda v, *a: m.apply(v, *a, iters=4, test_mode=True)["disparity"])(v, *ins),
                          np.float32)

    want32 = jax_run(JCfg(), sv)
    want16 = jax_run(JCfg(compute_dtype="bfloat16", fused_level0="interpret"), sv16)
    model = from_jax.load_stereo_variables(
        StereoAnywhere(StereoAnywhereConfig(compute_dtype="bfloat16", fused_level0="on"), device="cpu"), sv)
    assert model.fused_step_used((1, 128, 64, 32))
    got = model(*map(torch.from_numpy, ins), iters=4)["disparity"].float().numpy()
    assert got.shape == want16.shape and np.isfinite(got).all()
    gap = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())  # noqa: E731
    assert gap(got, want16) <= 2 * gap(want16, want32)
