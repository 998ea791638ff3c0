"""The whole slice: the JAX `StereoAnywherePipeline` against the port's, on
the CPU in f32, with the same weights (DAv2 ViT-S at mono_size 56x56,
default stereo widths, 2 GRU iterations).

Shapes: (32, 64), and (32, 672), which is wider than 640 and no multiple of
64, so the width alignment pads it to 704 inside the model.

Disparity tolerance: 1e-3 px plus 5e-5 of its magnitude.  The f32 sums are
taken in another order on the two sides (XLA's banded conv3d and im2col
matmuls against MKL-DNN), and two steps amplify that: the closed-form 2x2
least-squares solve for scale/shift cancels in its determinant, and its
quantile trim can move an element across a threshold.  The random weights
give disparities of 40-180 px, so the relative part dominates.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipelines():
    from stereoanywhere_tpu.config import MonoConfig as JMono, StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD
    from stereoanywhere_tpu.serve.pipeline import StereoAnywherePipeline as JPipe

    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline

    z3, z1 = np.zeros((1, 64, 96, 3), np.float32), np.zeros((1, 64, 96, 1), np.float32)
    sv = jax.jit(lambda k: JSA(JCfg()).init(k, z3, z3, z1, z1, iters=1, test_mode=True))(jax.random.PRNGKey(0))
    mv = jax.jit(JD(JMono.for_encoder("vits")).init)(jax.random.PRNGKey(1), np.zeros((1, 56, 56, 3), np.float32))
    jp = JPipe(sv, mv, JCfg(), JMono.for_encoder("vits"), iters=2, mono_size=(56, 56))
    pp = build_pipeline(
        StereoAnywhereConfig(), MonoConfig.for_encoder("vits"), iters=2, mono_size=(56, 56), device="cpu",
        stereo_variables=jax.tree.map(np.asarray, sv), mono_variables=jax.tree.map(np.asarray, mv),
    )
    return jp, pp


@pytest.mark.parametrize("h,w", [(32, 64), (32, 672)])
def test_pipeline_matches_jax(pipelines, h, w):
    jp, pp = pipelines
    rng = np.random.default_rng(h * 1000 + w)
    im2, im3 = (rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jp(jnp.asarray(im2), jnp.asarray(im3)))
    got = pp(im2, im3).numpy()
    assert got.shape == (1, h, w, 1)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-3)


def test_mono_loaded_pipeline_ignores_callers_depth(pipelines):
    """With the mono model loaded, depth passed by the caller is ignored:
    the JAX pipeline recomputes it, and so does the port."""
    jp, pp = pipelines
    rng = np.random.default_rng(5)
    im2, im3 = (rng.uniform(0, 1, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    mde = rng.uniform(0, 1, (1, 32, 64, 1)).astype(np.float32)
    j_given = np.asarray(jp(jnp.asarray(im2), jnp.asarray(im3), jnp.asarray(mde), jnp.asarray(1 - mde)))
    np.testing.assert_array_equal(j_given, np.asarray(jp(jnp.asarray(im2), jnp.asarray(im3))))
    got = pp(im2, im3, mde, 1 - mde).numpy()
    np.testing.assert_array_equal(got, pp(im2, im3).numpy())
    np.testing.assert_allclose(got, j_given, rtol=5e-5, atol=1e-3)


def test_two_stage_matches_one_graph(pipelines, monkeypatch):
    """`two_stage=True`: `mono_stage`, the depth through host memory, then
    `stereo_stage`; the same answer as the one-call path and as the JAX
    two-stage pipeline."""
    from stereoanywhere_tpu.serve.pipeline import StereoAnywherePipeline as JPipe

    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline

    jp, pp = pipelines
    rng = np.random.default_rng(6)
    im2, im3 = (rng.uniform(0, 1, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    two = StereoAnywherePipeline(pp.stereo, pp.mono, pp.iters, pp.mono_size, "cpu", two_stage=True)
    depths = []
    stage = two.stereo_stage
    monkeypatch.setattr(two, "stereo_stage", lambda a, b, m2, m3: depths.append((m2, m3)) or stage(a, b, m2, m3))
    got = two(im2, im3).numpy()
    assert len(depths) == 1 and all(isinstance(d, np.ndarray) for d in depths[0])  # the host round trip
    one = pp(im2, im3).numpy()
    np.testing.assert_allclose(got, one, rtol=5e-5, atol=1e-3)
    np.testing.assert_allclose(pp.stereo_stage(im2, im3, *pp.mono_stage(im2, im3)).numpy(), one, rtol=0, atol=0)
    jtwo = JPipe(jp.stereo_variables, jp.mono_variables, jp.stereo.cfg, jp.mono.cfg, iters=jp.iters,
                 mono_size=jp.mono_size, two_stage=True)
    np.testing.assert_allclose(got, np.asarray(jtwo(jnp.asarray(im2), jnp.asarray(im3))), rtol=5e-5, atol=1e-3)


def test_http_server_roundtrip():
    """serve_http's request format through the port's server and client,
    on a stereo-only CPU pipeline."""
    import threading

    from stereoanywhere_tpu_torch.serve.client import infer_remote
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline, make_http_server

    pipe = build_pipeline(mono_cfg=None, iters=1, device="cpu")
    server = make_http_server(pipe, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(0)
        im2, im3 = (rng.uniform(0, 1, (30, 50, 3)).astype(np.float32) for _ in range(2))
        disp = infer_remote(f"http://127.0.0.1:{server.server_address[1]}", im2, im3, timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    want = np.clip(pipe(im2[None], im3[None]).numpy()[0, ..., 0] * 256.0, 0, 65535).astype(np.uint16) / 256.0
    assert disp.shape == (30, 50)
    # the answer is quantized to 1/256 px: two runs whose f32 disparities
    # differ in the last bits (oneDNN's thread split differs between the
    # server thread and this one) may round one step apart
    np.testing.assert_allclose(disp, want, rtol=0, atol=1.0 / 256)
