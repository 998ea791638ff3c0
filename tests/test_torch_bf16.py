"""The port in bf16 against the JAX package in bf16, on the CPU, with the
same weights: the mono hourglass's dtypes, DAv2 in the pipeline, and the
whole stereo model in its default configuration.  (The fused
configuration: `test_torch_bf16_fused.py`; the kernels' plain versions in
bf16: `test_torch_kernels.py`, `test_torch_fused_step.py`.)

The JAX side runs as `bench.py`'s bf16 pipeline does: its variables cast to
bf16, f32 images.  bf16 rounds at other places in the two frameworks, so a
whole-model comparison is held to JAX's own bf16 error: the port's bf16
output may lie at most twice as far from JAX's bf16 output as that lies
from JAX's f32 output (max |a - b| / max |b| both).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat import from_jax

torch.set_num_threads(2)


def bf16_vars(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


def gap(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).permute(0, 3, 1, 2)


def test_hourglass_bf16_runs_in_f32_past_its_first_gate(rng):
    """A bf16 model's mono hourglass, as the JAX package runs it: its depth
    pyramids stay f32, so the first gate promotes the volume and the rest
    of the network runs in f32; the output is f32.  Tolerance 5e-3 of
    max |JAX|: only `down_layers[0]` (one strided conv, its instance norm)
    runs in bf16, rounding at the same points on both sides, and a one-ulp
    difference there (2^-8 relative) carried through f32 stays below it
    (1.1e-3 to 2.6e-3 over three seeds, where the all-bf16 hourglass read
    1.7e-2 to 2.0e-2, as JAX's own bf16-vs-f32 gap does)."""
    from stereoanywhere_tpu.models.hourglass import Hourglass as JH
    from stereoanywhere_tpu.ops.folded import build_masked_volume_blocked, from_blocks, pick_nb, unfold
    from stereoanywhere_tpu.ops.volume import generate_masks

    from stereoanywhere_tpu_torch.models.hourglass import Hourglass
    from stereoanywhere_tpu_torch.ops.volume import masked_volume

    b, h, w2 = 1, 16, 32
    vol = rng.standard_normal((b, h, w2, w2)).astype(np.float32)
    mde2, mde3 = (rng.uniform(0, 1, (b, h, w2, 1)).astype(np.float32) for _ in range(2))
    fl = [rng.uniform(0, 1, (b, h // 2 ** i, w2 // 2 ** i, 1)).astype(np.float32) for i in range(4)]
    fr = [rng.uniform(0, 1, (b, h // 2 ** i, w2 // 2 ** i, 1)).astype(np.float32) for i in range(4)]
    nb = pick_nb(w2)
    lm, rm = generate_masks(jnp.asarray(mde2), 8), generate_masks(jnp.asarray(mde3), 8)
    jh = JH(8, 8, folded=True, blocked=True)
    v = jax.tree.map(np.asarray, jax.jit(jh.init)(jax.random.PRNGKey(0), build_masked_volume_blocked(
        jnp.asarray(vol), lm, rm, jnp.float32, nb), fl, fr))
    out = jax.jit(jh.apply)(bf16_vars(v), build_masked_volume_blocked(jnp.asarray(vol), lm, rm, jnp.bfloat16, nb),
                            fl, fr)
    assert out.dtype == jnp.float32
    want = np.asarray(unfold(from_blocks(out), 8))  # (B, W3, H, W2, C)

    ph = Hourglass(8, 8)
    wrapped = {col: {"hourglass_mono": tree} for col, tree in v.items()}
    from_jax._load(ph, wrapped, lambda n: from_jax._stereo_rename("hourglass_mono." + n), "test")
    ph = ph.to(torch.bfloat16)
    masked = masked_volume(torch.from_numpy(vol), nchw(np.asarray(lm)), nchw(np.asarray(rm))).to(torch.bfloat16)
    with torch.no_grad():
        got = ph(masked, [nchw(f) for f in fl], [nchw(f) for f in fr])
    assert got.dtype == torch.float32
    assert gap(got.permute(0, 2, 3, 4, 1).numpy(), want) <= 5e-3


@pytest.fixture(scope="module")
def vits():
    """JAX StereoAnywhere and DAv2 ViT-S variables (f32) and a 64x128 pair."""
    from stereoanywhere_tpu.config import MonoConfig as JMono, StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD

    rng = np.random.default_rng(11)
    ins = tuple(rng.uniform(0, 1, (1, 64, 128, c)).astype(np.float32) for c in (3, 3, 1, 1))
    sv = jax.jit(lambda k: JSA(JCfg()).init(k, *ins, iters=1, test_mode=True))(jax.random.PRNGKey(0))
    mv = jax.jit(JD(JMono.for_encoder("vits")).init)(jax.random.PRNGKey(1), np.zeros((1, 56, 56, 3), np.float32))
    return jax.tree.map(np.asarray, sv), jax.tree.map(np.asarray, mv), ins


def test_dav2_bf16_gap_is_within_twice_jax(vits):
    """The pipeline's mono stage (ViT-S at mono_size 56 x 112) in
    bf16.  A chosen deviation, recorded in ROADMAP.md: the port runs DAv2
    in the stereo compute dtype, activations included, where the JAX
    pipeline keeps the image's f32 and rounds only the weights (and, on
    the TPU, the products' operands).  Measured here: the port's depth
    lies 2.3e-2 from JAX's bf16 depth, which lies 2.8e-2 from JAX's f32
    depth (0.80x; 0.50x to 1.49x at other sizes and seeds)."""
    from stereoanywhere_tpu.config import MonoConfig as JMono, StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.serve.pipeline import StereoAnywherePipeline as JPipe

    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline

    sv, mv, (im2, im3, _, _) = vits
    h, w = im2.shape[1:3]

    def jax_depth(mvars, cfg):
        jp = JPipe(sv, mvars, cfg, JMono.for_encoder("vits"), mono_size=(56, 112), two_stage=True)
        mono_stage, _ = jp._build_two_stage(h, w)
        return np.asarray(mono_stage(mvars, jnp.asarray(im2), jnp.asarray(im3)), np.float32)

    want32 = jax_depth(mv, JCfg())
    want16 = jax_depth(bf16_vars(mv), JCfg(compute_dtype="bfloat16"))
    pipe = build_pipeline(StereoAnywhereConfig(compute_dtype="bfloat16"), MonoConfig.for_encoder("vits"),
                          mono_size=(56, 112), device="cpu", stereo_variables=sv, mono_variables=mv)
    got = torch.cat(pipe.mono_stage(im2, im3)).numpy()
    assert got.shape == want16.shape and np.isfinite(got).all()
    assert gap(got, want16) <= 2 * gap(want16, want32)


def test_model_bf16_matches_jax_bf16(vits):
    """StereoAnywhere(compute_dtype="bfloat16"), default configuration, at
    64x128 with 4 iterations, against JAX's bf16 forward (its variables
    cast to bf16); also its coarse mono disparity, which the hourglass and
    its classifiers produce.  Measured here: disparity 8.8e-2 against
    JAX's own 0.126, coarse disparity 1.09e-3 against 1.15e-3."""
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    sv, _, ins = vits
    keys = ("disparity", "coarse_dispmono2")

    def jax_run(cfg, v):
        m = JSA(cfg)
        out = jax.jit(lambda v, *a: m.apply(v, *a, iters=4, test_mode=True))(v, *ins)
        return {k: np.asarray(out[k], np.float32) for k in keys}

    want32 = jax_run(JCfg(), sv)
    want16 = jax_run(JCfg(compute_dtype="bfloat16"), bf16_vars(sv))
    model = from_jax.load_stereo_variables(
        StereoAnywhere(StereoAnywhereConfig(compute_dtype="bfloat16"), device="cpu"), sv)
    out = model(*map(torch.from_numpy, ins), iters=4)
    for k in keys:
        got = out[k].float().numpy()
        assert got.shape == want16[k].shape and np.isfinite(got).all()
        assert gap(got, want16[k]) <= 2 * gap(want16[k], want32[k]), k
