"""Exact row-sharded inference on the CPU over gloo: the port's
`parallel/halo.py`, `mesh.py`, `spatial.py` and `ring_corr.py` against the
unsharded ops, the port's one-process forward and the JAX package.

Ranks are spawned processes on a free localhost port (2, 3 and 4 of them,
one spawn each, all its cases inside, joined with a timeout), each with
one thread.  The JAX side runs in the test process on conftest's virtual
CPU devices.
- `halo_exchange` on 4 ranks equals JAX's under `shard_map` on 4 devices,
  exactly (the cases of `tests/test_parallel.py`, and two more halos).
- The row-aware ops on 2 and 3 ranks with uneven shards (blocks of 8 rows:
  16/8 and 16/16/8): `row_conv` at 3x3, 7x7 stride 2, 1x1 stride 2 and a
  3-D 3x3x3 stride 2, `pool2x`, the instance norm (2-D and 3-D), the
  align-corners resizes (bilinear and trilinear, both row axes), the
  nearest resize, the normals, the soft LRC, the joint min-max, the convex
  upsampling and `weighted_lsq`, each against the op on the whole tensor
  within 1e-6 (the same sums; some taken in another order).
- The whole forward at 128x64 in f32, 2 iterations, default widths (the
  port's seeded init, carried to JAX by its converter): on 2 and 4 ranks,
  on an uneven split (H 96 on 2 ranks: 64/32) and with `vol_downsample=1`
  (64-row blocks, H 128, 2 ranks), against the port's one-process forward
  at JAX's own bound for its row-sharded path against its one-device
  forward (rtol 1e-4, atol 5e-4, `tests/test_parallel.py`); the
  one-process forward against JAX's `model.apply` at that bound too; and
  the sharded forward against JAX: its gap at most the one-process gap
  plus twice the most one rounding of the inputs moves the one-process
  forward (both measured in the run), and within the bound of the port's
  other whole-model comparisons with JAX (1e-3 px + 5e-5 rel.,
  `tests/test_torch_pipeline.py`).  JAX's own bound is too tight for the
  sharded forward against JAX: the one-process forward already comes within
  1.1e-5 px of it on these inputs, and the sharded forward moves as far
  from the one-process one (5e-4 px) as one rounding of the inputs moves
  the one-process forward (the norms' sums are taken in another order, the
  convolutions and the resizes' products run at other shapes, and no one
  of these alone makes the gap), which takes 11 of the 4-rank case's 8192
  pixels up to 1.7e-4 px past it.
- A mesh of one rank runs the plain forward bit for bit.
- `ring_all_pairs_correlation` on 4 ranks against `all_pairs_correlation`
  and JAX's `sharded_correlation_volume` at (1, 4, 32, 16).
- `make_mesh(2, 2)`: each tile group sums only its own row of the grid,
  each data group its column.
- `cli infer --shard-rows 2 --device cpu` writes what `--shard-rows 1`
  writes, within the forward's bound.
- Train mode refuses a row group, and `fused_level0="on"` runs under one
  (its gaps: `tests/test_torch_fused_rowshard.py`); `--shard-rows N` on
  the card refuses with fewer than N cards.
`PYTHONPATH=. python tests/test_torch_rowshard.py` prints the gaps behind
these bounds (`report`).
"""
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TIMEOUT = 240
ITERS = 2
FORWARDS = {  # name -> (ranks, height, vol_downsample)
    "2 ranks": (2, 128, 0),
    "4 ranks": (4, 128, 0),
    "uneven": (2, 96, 0),
    "vol_downsample": (2, 128, 1),
}
OP_HEIGHTS = {2: 24, 3: 40}  # blocks of 8 rows: 16/8 and 16/16/8
HALOS = (1, 2, 4)


def _inputs(h: int, w: int = 64) -> list[np.ndarray]:
    rng = np.random.default_rng(h)
    return [rng.uniform(0, 1, (1, h, w, c)).astype(np.float32) for c in (3, 3, 1, 1)]


def _one_rounding(xs: list[np.ndarray], rng) -> list[np.ndarray]:
    """Every element moved by one rounding: scaled by 1 +- 2^-24 in f64,
    rounded back to f32."""
    return [(x.astype(np.float64) * (1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -24)).astype(np.float32)
            for x in xs]


def _model(vol_downsample: int = 0, **kw):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    return StereoAnywhere(StereoAnywhereConfig(vol_downsample=vol_downsample, **kw), device="cpu",
                          generator=torch.Generator().manual_seed(3))


# ---------------------------------------------------------------------------
# what the ranks run


@torch.no_grad()
def _ops(rank: int, world: int) -> dict:
    """Each row-aware op on this rank's rows of seeded inputs, gathered on
    every rank, against the op on the whole inputs: {name: max |error| /
    max(1, max |whole|)}."""
    import torch.nn as nn

    from stereoanywhere_tpu_torch.models.layers import instance_norm
    from stereoanywhere_tpu_torch.ops.geometry import estimate_normals, joint_minmax_normalize, softlrc
    from stereoanywhere_tpu_torch.ops.interp import (
        pool2x, resize_bilinear_align_corners, resize_nearest, resize_trilinear_align_corners)
    from stereoanywhere_tpu_torch.ops.lsq import weighted_lsq
    from stereoanywhere_tpu_torch.ops.upsample import convex_upsample
    from stereoanywhere_tpu_torch.parallel import halo

    h = OP_HEIGHTS[world]
    plan = halo.plan_rows(h, world, 8)
    group = halo.RowGroup(plan, rank)
    g = torch.Generator().manual_seed(0)
    convs = {"conv 3x3": nn.Conv2d(4, 5, 3, padding=1), "conv 7x7 s2": nn.Conv2d(4, 5, 7, stride=2, padding=3),
             "conv 1x1 s2": nn.Conv2d(4, 5, 1, stride=2), "conv3d 3x3x3 s2": nn.Conv3d(3, 4, 3, stride=2, padding=1)}
    for conv in convs.values():
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
    x = torch.randn(2, 4, h, 12, generator=g)  # (B,C,H,W)
    vol = torch.randn(1, 3, 8, h, 6, generator=g)  # (B,C,W3,H,W2)
    hvol = torch.randn(1, h, 6, 8, generator=g)  # (B,H,W2,W3)
    depth = torch.rand(2, 1, h, 12, generator=g)
    disp2, disp3 = (torch.rand(1, 1, h, 12, generator=g) * 4 for _ in range(2))
    coarse = torch.randn(2, 4, h // 4, 6, generator=g)  # at 1/4 of the rows
    flow, mask = torch.randn(1, 1, h // 4, 6, generator=g), torch.randn(1, 9 * 16, h // 4, 6, generator=g)
    mde, conf = torch.rand(1, 2, h, 12, generator=g), torch.rand(1, 2, h, 12, generator=g)
    rows = lambda t, axis=-2, scale=1: (t, axis, scale)  # noqa: E731  (an input, its row axis and scale)
    cases = {  # name -> (fn, inputs, the output's row axis; None: replicated)
        **{name: (lambda t, c=c: halo.row_conv(c, t), [rows(vol if c.weight.ndim == 5 else x)], -2)
           for name, c in convs.items()},
        "pool2x": (pool2x, [rows(x)], -2),
        "instance norm 2-D": (instance_norm, [rows(x)], -2),
        "instance norm 3-D": (instance_norm, [rows(vol)], -2),
        "bilinear down 2": (lambda t: resize_bilinear_align_corners(t, (t.shape[-2] // 2, 5)), [rows(x)], -2),
        "bilinear down 4": (lambda t: resize_bilinear_align_corners(t, (t.shape[-2] // 4, 12)), [rows(x)], -2),
        "bilinear up 4": (lambda t: resize_bilinear_align_corners(t, (t.shape[-2] * 4, 24)), [rows(coarse, -2, 4)],
                          -2),
        "trilinear rows -2": (lambda t: resize_trilinear_align_corners(t, (4, t.shape[-2] // 2, 3)), [rows(vol)], -2),
        "trilinear rows -3": (lambda t: resize_trilinear_align_corners(t, (t.shape[-3] // 2, 3, 4), row_axis=-3),
                              [rows(hvol, -3)], -3),
        "nearest": (lambda t: resize_nearest(t, (t.shape[-2] // 2, 6)), [rows(x)], -2),
        "normals": (lambda t: estimate_normals(t, 3.0), [rows(depth)], -2),
        "softlrc": (lambda a, b: torch.cat(softlrc(a, b)), [rows(disp2), rows(disp3)], -2),
        "joint min-max": (lambda a, b: torch.cat(joint_minmax_normalize([a, b])), [rows(depth), rows(depth * 2 - 1)],
                          -2),
        "convex upsample": (lambda f, m: convex_upsample(f, m, 2), [rows(flow, -2, 4), rows(mask, -2, 4)], -2),
        "weighted lsq": (lambda a, b, c: torch.cat(weighted_lsq(a, b, c)),
                         [rows(mde), rows(mde * 20 + conf), rows(conf)], None),
    }
    errors = {}
    for name, (fn, inputs, out_axis) in cases.items():
        want = fn(*[t for t, _, _ in inputs])
        with halo.row_group(group):
            got = fn(*[t.narrow(ax, *(lambda a, b: (a, b - a))(*plan.ranges(sc)[rank])) for t, ax, sc in inputs])
            if out_axis is not None:
                got = group.gather_rows(got, out_axis)
        errors[name] = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    return errors


def _forward(rank: int, world: int, name: str) -> np.ndarray | None:
    """The row-sharded forward of FORWARDS[name] on this rank, gathered on
    rank 0."""
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference

    _, h, v = FORWARDS[name]
    rs = RowShardedInference(_model(v), make_mesh(1, world), iters=ITERS)
    shard = rs.infer(*_inputs(h))
    assert (shard.start, shard.stop) == (rs.plan(h).starts[rank], rs.plan(h).stops[rank])
    assert shard.disparity.shape == (1, shard.stop - shard.start, 64, 1)
    full = rs.gather_rows(shard, dst=0)
    return None if full is None else full.numpy()


def _refusals(rank: int) -> dict:
    """Whether a row group refuses train mode and the fused loop: {case:
    the message of its ValueError, or None if it ran}."""
    from stereoanywhere_tpu_torch.parallel import halo
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference

    plan = halo.plan_rows(64, 2, 32)
    a, b = plan.starts[rank], plan.stops[rank]
    xs = [torch.from_numpy(x[:, a:b]) for x in _inputs(64)]

    def under_a_group(model, **kw):
        with halo.row_group(halo.RowGroup(plan, rank)):
            model(*xs, iters=1, **kw)

    cases = {"train mode": lambda: under_a_group(_model(), test_mode=False, generator=torch.Generator()),
             "fused loop": lambda: RowShardedInference(_model(fused_level0="on"), make_mesh(1, 2)).infer(
                 *_inputs(64)),
             "fused forward": lambda: under_a_group(_model(fused_level0="on"))}
    out = {}
    for name, run in cases.items():
        try:
            run()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _mesh_sums(rank: int) -> dict:
    import torch.distributed as dist

    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    out = {"coords": (mesh.coords["data"], mesh.coords["tile"]), "ranks": mesh.ranks}
    for axis in ("data", "tile"):
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t, group=mesh.groups[axis])
        out[axis] = float(t)
    return out


def _rank_main(rank: int, world: int, init_method: str, out_dir: str) -> None:
    import torch.distributed as dist

    from stereoanywhere_tpu_torch.ops.cuda import hourglass3d
    from stereoanywhere_tpu_torch.parallel.halo import halo_exchange
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.ring_corr import sharded_correlation_volume

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        out = {}
        if world in OP_HEIGHTS:
            out["ops"] = _ops(rank, world)
        before = hourglass3d.calls()
        out["forwards"] = {name: _forward(rank, world, name) for name, (n, _, _) in FORWARDS.items() if n == world}
        out["hourglass_calls"] = {k: v - before[k] for k, v in hourglass3d.calls().items()}
        if world == 2:
            out["refusals"] = _refusals(rank)
        if world == 4:
            x = np.random.default_rng(0).standard_normal((2, 16, 8, 3)).astype(np.float32)
            local = torch.from_numpy(x[:, 4 * rank:4 * rank + 4])
            out["halo"] = {k: halo_exchange(local, k, None, spatial_axis=1).numpy() for k in HALOS}
            fl, fr = _ring_features()
            out["ring"] = sharded_correlation_volume(torch.from_numpy(fl), torch.from_numpy(fr),
                                                     make_mesh(1, 4)).numpy()
            out["mesh"] = _mesh_sums(rank)
        torch.save(out, os.path.join(out_dir, f"world{world}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _ring_features():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((1, 4, 32, 16)).astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------------------
# the runs


def _spawn(world: int, out_dir: str):
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    return torch.multiprocessing.start_processes(
        _rank_main, args=(world, f"tcp://127.0.0.1:{free_port()}", out_dir), nprocs=world, join=False,
        start_method="spawn")


def _join(ctx, deadline: float) -> None:
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish within {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _jax_references() -> dict:
    """JAX's halo exchange and ring volume on 4 virtual devices, and its
    forward for each FORWARDS height and configuration."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from stereoanywhere_tpu.compat.torch_convert import convert_stereo_checkpoint
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.parallel.halo import halo_exchange
    from stereoanywhere_tpu.parallel.ring_corr import sharded_correlation_volume

    devices = jax.devices()[:4]
    x = np.random.default_rng(0).standard_normal((2, 16, 8, 3)).astype(np.float32)
    refs = {"halo": {}}
    for k in HALOS:
        fn = shard_map(lambda t, k=k: halo_exchange(t, k, "row", spatial_axis=1),
                       mesh=Mesh(np.array(devices), ("row",)), in_specs=P(None, "row"), out_specs=P(None, "row"))
        refs["halo"][k] = np.asarray(fn(jnp.asarray(x)))
    fl, fr = _ring_features()
    refs["ring"] = np.asarray(sharded_correlation_volume(jnp.asarray(fl), jnp.asarray(fr),
                                                         Mesh(np.array(devices).reshape(1, 4), ("data", "tile"))))
    variables = convert_stereo_checkpoint({k: v.numpy() for k, v in _model().state_dict().items()})
    refs["forwards"] = {}
    for name, (_, h, v) in FORWARDS.items():
        jm = JSA(JCfg(vol_downsample=v))
        run = jax.jit(lambda var, *a: jm.apply(var, *a, iters=ITERS, test_mode=True)["disparity"])
        refs["forwards"][name] = np.asarray(run(variables, *map(jnp.asarray, _inputs(h))))
    return refs


def _runs(out: str):
    """{world: [each rank's results]}, the JAX references, and for each
    forward case the port's one-process forward and the most it moves when
    its inputs take one rounding; the ranks write their results under `out`."""
    deadline = time.monotonic() + TIMEOUT
    ctxs = {world: _spawn(world, out) for world in (2, 3, 4)}
    try:
        refs = _jax_references()
        rng = np.random.default_rng(5)
        plain = {}
        with torch.no_grad():
            for name, (_, h, v) in FORWARDS.items():
                model = _model(v)
                one = model(*map(torch.from_numpy, _inputs(h)), iters=ITERS)["disparity"].numpy()
                moved = model(*map(torch.from_numpy, _one_rounding(_inputs(h), rng)), iters=ITERS)["disparity"]
                plain[name] = (one, float(np.abs(moved.numpy() - one).max()))
    finally:
        for ctx in ctxs.values():
            _join(ctx, deadline)
    ranks = {world: [torch.load(os.path.join(out, f"world{world}.rank{r}.pt"), weights_only=False)
                     for r in range(world)] for world in ctxs}
    return ranks, refs, plain


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("rowshard")))


@pytest.mark.parametrize("halo", HALOS)
def test_halo_exchange_matches_jax(runs, halo):
    ranks, refs, _ = runs
    hl = 4
    for r, res in enumerate(ranks[4]):
        want = refs["halo"][halo][:, r * (hl + 2 * halo):(r + 1) * (hl + 2 * halo)]
        np.testing.assert_array_equal(res["halo"][halo], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("world", sorted(OP_HEIGHTS))
def test_row_aware_ops_match_the_unsharded_ops(runs, world):
    """Every rank's gathered result of every op within 1e-6 of the op on
    the whole tensor (relative to the output's magnitude where it exceeds 1)."""
    ranks, _, _ = runs
    for r, res in enumerate(ranks[world]):
        bad = {k: v for k, v in res["ops"].items() if not v <= 1e-6}
        assert not bad, (world, r, bad)
    assert len(ranks[world][0]["ops"]) == 18


@pytest.mark.parametrize("name", list(FORWARDS))
def test_row_sharded_forward_matches_one_process_and_jax(runs, name):
    ranks, refs, plain = runs
    world = FORWARDS[name][0]
    got = ranks[world][0]["forwards"][name]
    one, moved = plain[name]
    ref = refs["forwards"][name]
    assert all(res["forwards"][name] is None for res in ranks[world][1:])  # gathered on rank 0 only
    assert got.shape == one.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(one, ref, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-3)
    # the sharding's share of the gap to JAX: at most twice what one rounding
    # of the inputs moves the one-process forward
    gap, one_gap = float(np.abs(got - ref).max()), float(np.abs(one - ref).max())
    assert gap <= one_gap + 2 * moved, (gap, one_gap, moved)


def test_a_row_group_runs_the_hourglass_on_its_modules(runs):
    """Every rank's sharded forwards call the hourglass once each, on the
    plain path (`ops/cuda/hourglass3d.py` serves no call in a row group)."""
    ranks, _, _ = runs
    for world, results in ranks.items():
        n = sum(1 for ranks_, _, _ in FORWARDS.values() if ranks_ == world)
        for res in results:
            assert res["hourglass_calls"] == {"fused": 0, "plain": n}, (world, res["hourglass_calls"])


def test_a_mesh_of_one_rank_is_the_plain_forward_bit_for_bit():
    from stereoanywhere_tpu_torch.parallel import halo
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference
    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline

    model = _model()
    xs = [torch.from_numpy(x) for x in _inputs(64)]
    want = model(*xs, iters=ITERS)["disparity"]
    rs = RowShardedInference(model, make_mesh(1, 1), iters=ITERS)
    shard = rs.infer(*xs)
    assert (shard.start, shard.stop) == (0, 64)
    assert torch.equal(rs.gather_rows(shard), want)
    with halo.row_group(halo.RowGroup(halo.plan_rows(64, 1, 32), 0)):
        assert halo.active() is None
        assert torch.equal(model(*xs, iters=ITERS)["disparity"], want)
    plain = StereoAnywherePipeline(model, iters=ITERS, device="cpu")
    sharded = StereoAnywherePipeline(model, iters=ITERS, device="cpu", mesh=make_mesh(1, 1))
    im2, im3 = xs[0][:, :50, :60], xs[1][:, :50, :60]
    assert torch.equal(sharded(im2, im3), plain(im2, im3))
    with pytest.raises(ValueError, match="eagerly"):
        StereoAnywherePipeline(model, device="cpu", graphs=True, mesh=make_mesh(1, 1))


def test_ring_correlation_matches_jax_and_the_volume(runs):
    from stereoanywhere_tpu_torch.ops.volume import all_pairs_correlation

    ranks, refs, _ = runs
    got = np.concatenate([res["ring"] for res in ranks[4]], axis=2)
    fl, fr = (torch.from_numpy(f).permute(0, 3, 1, 2) for f in _ring_features())
    want = all_pairs_correlation(fl, fr).numpy()
    assert got.shape == want.shape == refs["ring"].shape == (1, 4, 32, 32)
    np.testing.assert_allclose(got, refs["ring"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mesh_groups_reach_only_their_axis(runs):
    ranks, _, _ = runs
    for r, res in enumerate(ranks[4]):
        d, t = divmod(r, 2)
        m = res["mesh"]
        assert m["coords"] == (d, t)
        assert m["ranks"] == {"data": (t, t + 2), "tile": (2 * d, 2 * d + 1)}
        assert m["tile"] == (2 * d + 1) + (2 * d + 2)  # rank + 1 summed over the row
        assert m["data"] == (t + 1) + (t + 3)  # over the column


@pytest.mark.parametrize("name", ["train mode", "fused loop", "fused forward"])
def test_a_row_group_refuses_train_mode_and_the_fused_loop(runs, name):
    """Train mode is refused; the fused loop, refused until its kernels ran
    on bands of rows, now runs (through `RowShardedInference` and under a
    bare row group)."""
    ranks, _, _ = runs
    for res in ranks[2]:
        msg = res["refusals"][name]
        if name == "train mode":
            assert msg is not None and "train mode" in msg, msg
        else:
            assert msg is None, msg


def test_plan_rows_deals_blocks_evenly():
    from stereoanywhere_tpu_torch.parallel.halo import plan_rows

    plan = plan_rows(3008, 4, 32)  # Booster: 94 blocks
    assert [b - a for a, b in zip(plan.starts, plan.stops)] == [768, 768, 736, 736]
    assert plan.starts[0] == 0 and plan.stops[-1] == 3008
    assert plan.ranges(4)[1] == (192, 384)
    with pytest.raises(ValueError):
        plan_rows(100, 2, 32)
    with pytest.raises(ValueError):
        plan_rows(64, 3, 32)


def test_cli_infer_shard_rows_writes_what_one_process_writes(tmp_path):
    from PIL import Image

    from stereoanywhere_tpu_torch import cli

    rng = np.random.default_rng(0)
    views = []
    for name in ("left.png", "right.png"):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(tmp_path / name)
        views.append(str(tmp_path / name))
    out = {}
    for n in (1, 2):
        d = tmp_path / f"out{n}"
        assert cli.main(["infer", *views, "-o", str(d), "--device", "cpu", "--iters", str(ITERS),
                         "--shard-rows", str(n)]) is None
        out[n] = np.load(d / "left_disp.npy")
        assert (d / "left_disp.png").exists()
    assert out[2].shape == out[1].shape == (64, 96)
    np.testing.assert_allclose(out[2], out[1], rtol=1e-4, atol=5e-4)


def test_cli_infer_shard_rows_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    """On the card `--shard-rows N` takes N cards, one a rank over NCCL: with
    fewer visible it refuses before spawning (the mesh's check)."""
    from stereoanywhere_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        cli.main(["infer", "left.png", "right.png", "-o", str(tmp_path / "out"), "--shard-rows", "2"])
    assert not (tmp_path / "out").exists()


def report() -> None:
    """The gaps behind the bounds above, printed: for each forward case, the
    sharded forward against the one-process one and against JAX, the
    one-process forward against JAX, each with its excess over JAX's bound
    (atol 5e-4 + rtol 1e-4) and the pixels past it, and the one-process
    forward's move under one rounding of its inputs; each row-aware op's
    error.  `PYTHONPATH=. python tests/test_torch_rowshard.py` from the
    repository's root (JAX on 8 virtual CPU devices, as conftest sets it)."""
    import tempfile

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as out:
        ranks, refs, plain = _runs(out)
    for name, (world, _, _) in FORWARDS.items():
        got, (one, moved), ref = ranks[world][0]["forwards"][name], plain[name], refs["forwards"][name]
        parts = []
        for label, a, b in (("sharded-one", got, one), ("sharded-JAX", got, ref), ("one-JAX", one, ref)):
            d, tol = np.abs(a - b), 5e-4 + 1e-4 * np.abs(b)
            parts.append(f"{label} max {d.max():.3e} (JAX-bound excess {(d - tol).max():.3e}, {(d > tol).sum()} px)")
        print(f"{name}: " + "; ".join(parts) + f"; one-rounding move {moved:.3e} px")
    for world in sorted(OP_HEIGHTS):
        worst = {k: max(r["ops"][k] for r in ranks[world]) for k in ranks[world][0]["ops"]}
        print(f"ops on {world} ranks, max relative error: " + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))


if __name__ == "__main__":
    report()
