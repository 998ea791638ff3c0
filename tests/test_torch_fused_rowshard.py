"""Row sharding of the fused refinement loop and of the aggregation
variant, on the CPU over gloo, against the port's one-process forward.

`fused_level0="on"` under a row group runs each K7, K8 and K9 launch (their
plain versions here) on a band of rows widened by the kernel's radius
(`models/update.py` `on_band`); the pre-step, the tail, the pooling and the
resizes are the row-aware ops of `tests/test_torch_rowshard.py`.  The
stereo-volume aggregation with stacked hourglasses runs its hourglasses
with the same halo'd 3-D convolutions as the mono one.

- The fused forward at 128x64 in f32, 2 iterations, default widths, on 2
  and 4 ranks and on an uneven split (H 96 on 2 ranks: 64/32), against the
  fused one-process forward within the bound `tests/test_torch_rowshard.py`
  holds the unfused sharded forward to (rtol 1e-4, atol 5e-4: JAX's own for
  its row-sharded path), and within twice the most one rounding of the
  inputs moves the one-process forward; the fused one-process forward runs
  the rotated loop (its kernels' plain versions are called) and lies within
  the same bound of the unfused one.
- `use_aggregate_stereo_vol=True, n_additional_hourglass=2` on 2 ranks
  against its one-process forward, the same bounds.
- A group of one rank runs the fused forward bit for bit.
Ranks are spawned processes with one thread each (one spawn of 2 ranks,
one of 4), joined with a timeout.
"""
import os
import time

import numpy as np
import pytest
import torch

from tests.test_torch_rowshard import _inputs, _join, _one_rounding

torch.set_num_threads(2)

TIMEOUT = 300
ITERS = 2
CONFIGS = {
    "fused": dict(fused_level0="on"),
    "variant": dict(use_aggregate_stereo_vol=True, n_additional_hourglass=2),
}
FORWARDS = {  # name -> (ranks, height, configuration)
    "fused 2 ranks": (2, 128, "fused"),
    "fused 4 ranks": (4, 128, "fused"),
    "fused uneven": (2, 96, "fused"),
    "variant 2 ranks": (2, 128, "variant"),
}


def _model(config: str | None = None):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    return StereoAnywhere(StereoAnywhereConfig(**CONFIGS.get(config, {})), device="cpu",
                          generator=torch.Generator().manual_seed(3))


def _counting_fused_calls() -> dict:
    """Wrap the fused step's three kernels (their CPU path) with counters."""
    from stereoanywhere_tpu_torch.models import update

    counts = {}
    for name in ("flow_head", "motion_encoder", "conv_gru"):
        fn = getattr(update, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        setattr(update, name, counted)
    return counts


def _rank_main(rank: int, world: int, init_method: str, out_dir: str) -> None:
    import torch.distributed as dist

    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        counts = _counting_fused_calls()
        out = {"forwards": {}, "calls": {}}
        for name, (n, h, config) in FORWARDS.items():
            if n != world:
                continue
            counts.clear()
            rs = RowShardedInference(_model(config), make_mesh(1, world), iters=ITERS)
            shard = rs.infer(*_inputs(h))
            assert shard.disparity.shape == (1, shard.stop - shard.start, 64, 1)
            full = rs.gather_rows(shard, dst=0)
            out["forwards"][name] = None if full is None else full.numpy()
            out["calls"][name] = dict(counts)
        torch.save(out, os.path.join(out_dir, f"world{world}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _runs(out: str):
    """{world: [each rank's results]} and, for each forward case, the
    one-process forward, the most one rounding of its inputs moves it and
    the unfused one-process forward of the same weights."""
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    deadline = time.monotonic() + TIMEOUT
    ctxs = {world: torch.multiprocessing.start_processes(
        _rank_main, args=(world, f"tcp://127.0.0.1:{free_port()}", out), nprocs=world, join=False,
        start_method="spawn") for world in (2, 4)}
    try:
        rng = np.random.default_rng(5)
        plain = {}
        with torch.no_grad():
            for name, (_, h, config) in FORWARDS.items():
                model = _model(config)
                one = model(*map(torch.from_numpy, _inputs(h)), iters=ITERS)["disparity"].numpy()
                moved = model(*map(torch.from_numpy, _one_rounding(_inputs(h), rng)), iters=ITERS)["disparity"]
                unfused = _model()(*map(torch.from_numpy, _inputs(h)), iters=ITERS)["disparity"].numpy()
                plain[name] = (one, float(np.abs(moved.numpy() - one).max()), unfused)
    finally:
        for ctx in ctxs.values():
            _join(ctx, deadline)
    ranks = {world: [torch.load(os.path.join(out, f"world{world}.rank{r}.pt"), weights_only=False)
                     for r in range(world)] for world in ctxs}
    return ranks, plain


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("fused_rowshard")))


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sharded_forward_matches_one_process(runs, name):
    ranks, plain = runs
    world, h, config = FORWARDS[name]
    got = ranks[world][0]["forwards"][name]
    one, moved, unfused = plain[name]
    assert all(res["forwards"][name] is None for res in ranks[world][1:])  # gathered on rank 0 only
    assert got.shape == one.shape == (1, h, 64, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=5e-4)
    assert float(np.abs(got - one).max()) <= 2 * moved + 1e-6, (float(np.abs(got - one).max()), moved)
    calls = [res["calls"][name] for res in ranks[world]]
    if config == "fused":
        # every rank ran the rotated loop: iters - 1 bodies, K9 at 3 scales
        assert all(c == {"flow_head": ITERS - 1, "motion_encoder": ITERS - 1, "conv_gru": 3 * (ITERS - 1)}
                   for c in calls), calls
        np.testing.assert_allclose(one, unfused, rtol=1e-4, atol=5e-4)
    else:
        assert all(c == {} for c in calls), calls
        assert float(np.abs(one - unfused).max()) > 1e-2  # the variant is another function


def test_fused_group_of_one_is_the_fused_forward_bit_for_bit():
    from stereoanywhere_tpu_torch.parallel import halo
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference

    model = _model("fused")
    xs = [torch.from_numpy(x) for x in _inputs(64)]
    want = model(*xs, iters=3)["disparity"]
    rs = RowShardedInference(model, make_mesh(1, 1), iters=3)
    assert torch.equal(rs.gather_rows(rs.infer(*xs)), want)
    with halo.row_group(halo.RowGroup(halo.plan_rows(64, 1, 32), 0)):
        assert torch.equal(model(*xs, iters=3)["disparity"], want)


def test_on_band_is_the_plain_call_without_a_group():
    from stereoanywhere_tpu_torch.models.update import on_band

    x = torch.randn(1, 5, 4, 3)
    assert on_band(lambda t: t * 2, 3, x).equal(x * 2)
