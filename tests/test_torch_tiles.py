"""Row-tiled high-resolution inference: the port's `parallel/tiles.py`
against the JAX package's, on the CPU in f32.

The plan and the blend window are equal exactly; extraction and the
stitch within 1e-6 (the same f32 sums in the same order; XLA may fuse a
multiply into an add).  `TileParallelInference` at (1, 128, 64), 2 tiles
of 96 rows (overlap 32), 2 iterations, default stereo widths: the port's
batched and sequential outputs against JAX's `TileParallelInference` on a
mesh of 2 virtual devices, within 1e-3 px + 5e-5 rel. (the pipeline
tests' bound: the f32 sums are taken in other orders, which the weighted
least squares amplifies).  One instance serves heights whose plans share
a tile height, each from its own program.  Weights: the port's seeded
init, carried to JAX by the JAX package's own converter.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(2)

PLANS = [(128, 1, 0), (128, 2, 32), (256, 4, 32), (480, 3, 64), (1024, 2, 64), (1024, 4, 64),
         (2016, 4, 128), (2016, 2, 96), (3008, 8, 160), (3008, 8, 64), (96, 3, 32)]


@pytest.mark.parametrize("h,n,overlap", PLANS)
def test_plan_row_tiles_matches_jax(h, n, overlap):
    from stereoanywhere_tpu.parallel.tiles import plan_row_tiles as jplan

    from stereoanywhere_tpu_torch.parallel.tiles import plan_row_tiles

    got, want = plan_row_tiles(h, n, overlap), jplan(h, n, overlap)
    assert (got.image_h, got.tile_h, got.overlap, got.starts) == (want.image_h, want.tile_h, want.overlap, want.starts)
    assert got.n_tiles == want.n_tiles == n
    assert got.tile_h % 32 == 0 and got.starts[-1] + got.tile_h == h


def test_booster_preset_plan():
    """The booster preset on Booster's 3008 rows: 8 tiles of 544, stride 352."""
    from stereoanywhere_tpu_torch.parallel.presets import get_preset_for_dataset
    from stereoanywhere_tpu_torch.parallel.tiles import plan_row_tiles

    p = get_preset_for_dataset("booster")
    plan = plan_row_tiles(3008, p.n_tiles, p.overlap)
    assert (plan.tile_h, plan.overlap, plan.starts) == (544, 192, tuple(352 * i for i in range(8)))


@pytest.mark.parametrize("tile_h", [32, 96, 320, 544, 3008])
def test_blend_window_matches_jax(tile_h):
    from stereoanywhere_tpu.parallel.tiles import blend_window as jwin

    from stereoanywhere_tpu_torch.parallel.tiles import blend_window

    got, want = blend_window(tile_h), jwin(tile_h)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,c,n,overlap", [(256, 48, 1, 4, 32), (544, 40, 3, 2, 96), (128, 16, 1, 1, 0)])
def test_extract_and_stitch_match_jax(h, w, c, n, overlap):
    from stereoanywhere_tpu.parallel import tiles as jt

    from stereoanywhere_tpu_torch.parallel import tiles as pt

    rng = np.random.default_rng(h + n)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    plan = pt.plan_row_tiles(h, n, overlap)
    got = pt.extract_row_tiles(torch.from_numpy(x), plan)
    want = jt.extract_row_tiles(jnp.asarray(x), jt.plan_row_tiles(h, n, overlap))
    assert tuple(got.shape) == want.shape == (n, plan.tile_h, w, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the stitch of other values per tile (a tile's rows disagree with its
    # neighbour's over the overlap), and the round trip
    t = rng.standard_normal((n, plan.tile_h, w, c)).astype(np.float32)
    np.testing.assert_allclose(pt.stitch_row_tiles(torch.from_numpy(t), plan).numpy(),
                               np.asarray(jt.stitch_row_tiles(jnp.asarray(t), jt.plan_row_tiles(h, n, overlap))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.stitch_row_tiles(got, plan).numpy(), x, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tiled():
    """The port's model (seeded init) and the same weights in JAX's tree; a
    seeded (1, 128, 64) input; JAX's batched and sequential tiled outputs."""
    from stereoanywhere_tpu.compat.torch_convert import convert_stereo_checkpoint
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.parallel.mesh import make_mesh
    from stereoanywhere_tpu.parallel.tiles import TileParallelInference as JTiles

    from stereoanywhere_tpu_torch.models import StereoAnywhere

    model = StereoAnywhere(device="cpu", generator=torch.Generator().manual_seed(3))
    variables = convert_stereo_checkpoint({k: v.numpy() for k, v in model.state_dict().items()})
    jmodel = JSA(JCfg())

    def apply_fn(v, a, b, c, d, iters):
        return jmodel.apply(v, a, b, c, d, iters=iters, test_mode=True)

    rng = np.random.default_rng(11)
    xs = [rng.uniform(0, 1, (1, 128, 64, c)).astype(np.float32) for c in (3, 3, 1, 1)]
    mesh = make_mesh(data=1, tile=2)
    want = {seq: np.asarray(JTiles(apply_fn, variables, mesh, n_tiles=2, overlap=32, iters=2, sequential=seq)
                            .infer(*map(jnp.asarray, xs))) for seq in (False, True)}
    return model, xs, want


@pytest.mark.parametrize("sequential", [False, True], ids=["batched", "sequential"])
def test_tile_parallel_inference_matches_jax(tiled, sequential):
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    model, xs, want = tiled
    tp = TileParallelInference(model, 2, overlap=32, iters=2, sequential=sequential, device="cpu")
    assert not tp.graphs
    got = tp.infer(*xs).numpy()
    assert got.shape == (1, 128, 64, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want[sequential], rtol=5e-5, atol=1e-3)


def test_batched_and_sequential_tiles_agree(tiled):
    """JAX's own check (`tests/test_parallel.py`): the two modes within 1e-3."""
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    model, xs, _ = tiled
    out = [TileParallelInference(model, 2, overlap=32, iters=2, sequential=s, device="cpu").infer(*xs)
           for s in (False, True)]
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("heights,n,overlap", [((992, 1024), 2, 64), ((1952, 1984), 4, 128), ((128, 160), 2, 32)],
                         ids=["default-1024", "middlebury-1984", "small"])
def test_programs_are_keyed_on_the_whole_plan(tiled, heights, n, overlap):
    """Two heights whose plans share tile_h (with other starts) get a
    program each: a program built for one plan stitches to its height."""
    from stereoanywhere_tpu_torch.parallel.tiles import TileParallelInference, plan_row_tiles

    plans = [plan_row_tiles(h, n, overlap) for h in heights]
    assert plans[0].tile_h == plans[1].tile_h and plans[0].starts != plans[1].starts
    tp = TileParallelInference(tiled[0], n, overlap=overlap, iters=1, device="cpu")
    assert tp._build(plans[0], 64) is not tp._build(plans[1], 64)
    assert tp._build(plans[0], 64) is tp._build(plan_row_tiles(heights[0], n, overlap), 64)


@pytest.mark.parametrize("sequential", [False, True], ids=["batched", "sequential"])
def test_one_instance_serves_heights_sharing_a_tile_height(tiled, sequential):
    """H 160 after H 128 on one instance (both 2 tiles of 96 rows, overlap
    32, starts (0, 32) and (0, 64)): each output has its own height and
    equals a fresh instance's."""
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    model = tiled[0]
    rng = np.random.default_rng(12)
    tp = TileParallelInference(model, 2, overlap=32, iters=2, sequential=sequential, device="cpu")
    for h in (128, 160, 128):
        xs = [rng.uniform(0, 1, (1, h, 64, c)).astype(np.float32) for c in (3, 3, 1, 1)]
        got = tp.infer(*xs)
        assert tuple(got.shape) == (1, h, 64, 1)
        fresh = TileParallelInference(model, 2, overlap=32, iters=2, sequential=sequential, device="cpu").infer(*xs)
        np.testing.assert_array_equal(got.numpy(), fresh.numpy())


def test_tiled_path_refuses_what_it_does_not_take(tiled):
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    model, xs, _ = tiled
    with pytest.raises(ValueError):  # graphs need the card
        TileParallelInference(model, 2, device="cpu", graphs=True)
    tp = TileParallelInference(model, 2, overlap=32, iters=1, device="cpu")
    with pytest.raises(ValueError):  # H no multiple of 32
        tp.infer(*(x[:, :112] for x in xs))
    with pytest.raises(AssertionError):  # one image
        tp.infer(*(np.concatenate([x, x]) for x in xs))


def test_tiled_request_matches_jax():
    """The slice as a whole at (1, 90, 72) (padded to 96 x 96): DAv2 ViT-S
    at mono_size 56 (the pipeline's mono stage), joint min-max, edge pad,
    2 sequential row tiles of 64 (overlap 32), 2 iterations, the stitch,
    unpad; the JAX side composes its pipeline's mono stage, its min-max and
    pad and its `TileParallelInference`.  Within 1e-3 px + 5e-5 rel."""
    from stereoanywhere_tpu.config import MonoConfig as JMono, StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD
    from stereoanywhere_tpu.ops.geometry import joint_minmax_normalize as jminmax
    from stereoanywhere_tpu.parallel.mesh import make_mesh
    from stereoanywhere_tpu.parallel.tiles import TileParallelInference as JTiles
    from stereoanywhere_tpu.serve.pipeline import StereoAnywherePipeline as JPipe, _pad_sizes

    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.parallel.tiles import TileParallelInference
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline

    h, w = 90, 72
    z3, z1 = np.zeros((1, 64, 96, 3), np.float32), np.zeros((1, 64, 96, 1), np.float32)
    sv = jax.tree.map(np.asarray, jax.jit(lambda k: JSA(JCfg()).init(k, z3, z3, z1, z1, iters=1, test_mode=True))(
        jax.random.PRNGKey(0)))
    mv = jax.tree.map(np.asarray, jax.jit(JD(JMono.for_encoder("vits")).init)(
        jax.random.PRNGKey(1), np.zeros((1, 56, 56, 3), np.float32)))
    rng = np.random.default_rng(21)
    im2, im3 = (rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32) for _ in range(2))

    jp = JPipe(sv, mv, JCfg(), JMono.for_encoder("vits"), iters=2, mono_size=(56, 56), two_stage=True)
    mono_stage, _ = jp._build_two_stage(h, w)
    depth = mono_stage(mv, jnp.asarray(im2), jnp.asarray(im3))
    d2, d3 = jminmax([depth[:1], depth[1:]])
    t, b, l, r = _pad_sizes(h, w)
    pad = lambda x: jnp.pad(x, ((0, 0), (t, b), (l, r), (0, 0)), mode="edge")  # noqa: E731
    jmodel = JSA(JCfg())
    jt = JTiles(lambda v, a, b, c, d, iters: jmodel.apply(v, a, b, c, d, iters=iters, test_mode=True), sv,
                make_mesh(data=1, tile=2), n_tiles=2, overlap=32, iters=2, sequential=True)
    want = np.asarray(jt.infer(pad(jnp.asarray(im2)), pad(jnp.asarray(im3)), pad(d2), pad(d3)))[:, t:t + h, l:l + w]

    pipe = build_pipeline(StereoAnywhereConfig(), MonoConfig.for_encoder("vits"), iters=2, mono_size=(56, 56),
                          device="cpu", stereo_variables=sv, mono_variables=mv)
    tp = TileParallelInference(pipe.stereo, 2, overlap=32, iters=2, sequential=True, device="cpu")
    got = tp.stereo_stage(torch.from_numpy(im2), torch.from_numpy(im3), *pipe.mono_stage(im2, im3)).numpy()
    assert got.shape == (1, h, w, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-3)
    # one tile is the plain stereo stage (the blend divides w * x by w)
    one = TileParallelInference(pipe.stereo, 1, overlap=0, iters=2, device="cpu")
    mde = pipe.mono_stage(im2, im3)
    np.testing.assert_allclose(one.stereo_stage(torch.from_numpy(im2), torch.from_numpy(im3), *mde).numpy(),
                               pipe.stereo_stage(im2, im3, *mde).numpy(), rtol=5e-5, atol=1e-3)
