"""Data-parallel training on the CPU over gloo: two ranks, each stepping on
half of a global batch, against one process stepping on the whole batch
(the JAX package's one SPMD program over the global batch), and `cli train`
over two processes.

Two ranks (spawned, a free port on localhost) and the one-process
reference (run by rank 0 before it joins the group) start from the same
seeded weights; a global batch of 4 at 32x64, 2 iterations, f32, 2 steps.  The loss, every log, `grad_norm`, every
parameter and BatchNorm's running statistics must agree to 1e-6 relative:
- with unequal valid-pixel counts on the two ranks (the global masked
  means; a mean of the ranks' means, built here as plain gradient
  averaging does it, misses the bound);
- with the right gt valid on one rank only while gt-as-mono fires (the
  global condition);
- with the "noise" and "zero" volume corruptions forced (the global draw
  and the global max);
- with batch-statistic BatchNorm (`freeze_bn=False`).
A resumed two-rank run equals an unbroken one; a stop flag raised on one
rank stops both at the same step and rank 0 alone writes `stopped.pt`;
`cli train --multihost` under torchrun's environment and `cli train
--data-parallel 2 --device cpu` each run 2 steps.  Every spawn is joined
with a timeout, so no test waits more than 240 s.
"""
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

B, H, W, ITERS, STEPS, WORLD = 4, 32, 64, 2, 2, 2
TIMEOUT = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case -> (model config, train config) keyword overrides; the batches are _batches(case)
CASES = {
    "unequal_valid": ({}, {}),
    "right_gt_on_one_rank": ({}, {"gt_mono_prob": 1.0}),
    "forced_corruption": ({"volume_corruption_prob": 1.0}, {}),
    "batch_statistics": ({"freeze_bn": False}, {"things_to_freeze": ()}),
}
# Adam's first steps move an entry by about lr in the sign of its gradient,
# whatever its size: a gradient that is zero up to rounding (a zero-initialised
# bias's, a sum that cancels) steps by lr either way, and two summation orders
# of one function then part by 2 lr there.  An eps above the gradients'
# entries makes the update linear in the gradient, so that the parameters
# carry the gradients' agreement.
ADAM_EPS = 1.0
FORCED = [(1, 1, 3), (5, 2, 5)]  # (branch, mask index, shift) at steps 0 and 1: stereo noise, mono zero


def _batches(case: str) -> list[dict]:
    """The global batches of a case, from a seed.  Rank 0 holds samples 0-1,
    rank 1 samples 2-3."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        b = {k: rng.uniform(0, 1, (B, H, W, c)).astype(np.float32)
             for k, c in (("im2_aug", 3), ("im3_aug", 3), ("mono2", 1), ("mono3", 1))}
        b["gt"] = rng.uniform(1, 8, (B, H, W, 1)).astype(np.float32)
        b["gt_right"] = rng.uniform(1, 8, (B, H, W, 1)).astype(np.float32)
        # rank 0's samples 90% valid, rank 1's 20%: unequal counts in every case
        density = np.array([0.9, 0.9, 0.2, 0.2], np.float32)[:, None, None, None]
        b["validgt"] = (rng.uniform(0, 1, (B, H, W, 1)) < density).astype(np.float32)
        b["validgt_right"] = (rng.uniform(0, 1, (B, H, W, 1)) < density).astype(np.float32)
        if case == "right_gt_on_one_rank":
            b["validgt_right"][2:] = 0.0
        out.append(b)
    return out


_base = {}


def _base_model():
    """The seeded model every run starts from (built once a process)."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    if "model" not in _base:
        _base["model"] = StereoAnywhere(StereoAnywhereConfig(), device="cpu",
                                        generator=torch.Generator().manual_seed(3), param_dtype=torch.float32)
    return _base["model"]


def _trainer(case: str, checkpoint_dir=None):
    import dataclasses

    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    model_kw, train_kw = CASES.get(case, CASES["unequal_valid"])
    model = copy.deepcopy(_base_model())
    model.cfg = dataclasses.replace(model.cfg, **{"volume_corruption_prob": 0.0, **model_kw})
    tc = TrainConfig(train_iters=ITERS, adam_eps=ADAM_EPS, **{"gt_mono_prob": 0.0, **train_kw})
    return Trainer(model.cfg, tc, 20, device="cpu", checkpoint_dir=checkpoint_dir, model=model)


def _shard(batch: dict, rank: int, world: int) -> dict:
    n = B // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _run(case: str, rank: int, world: int, order=None) -> dict:
    """2 steps of a case on this rank's shard (of the global batch's samples
    taken in `order`): each step's logs, the first step's gradient, and
    every parameter and buffer after the steps."""
    from stereoanywhere_tpu_torch.models import stereoanywhere as sa

    tr = _trainer(case)
    forced = iter(FORCED)
    real = sa.draw_corruption
    if case == "forced_corruption":
        sa.draw_corruption = lambda *a: next(forced)
    logs, grads = [], None
    try:
        for b in _batches(case):
            if order is not None:
                b = {k: v[order] for k, v in b.items()}
            logs.append({k: float(v) for k, v in tr.step(_shard(b, rank, world)).items()})
            if grads is None:  # the first step's global gradient, as the optimizer took it (clipped)
                grads = torch.cat([p.grad.reshape(-1) for p in tr.params])
    finally:
        sa.draw_corruption = real
    return {"logs": logs, "grads": grads, "state": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}


def _mean_of_means(rank: int, world: int) -> dict:
    """The trap: each rank's loss over its own valid pixels and the
    gradients averaged over the ranks (plain DDP)."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.train import loss, trainer

    saved = loss.all_reduce_sum, trainer.all_reduce_sum
    loss.all_reduce_sum = lambda t: t
    trainer.all_reduce_sum = lambda t: mh.all_reduce_sum(t) / world
    try:
        return _run("unequal_valid", rank, world)
    finally:
        loss.all_reduce_sum, trainer.all_reduce_sum = saved


def _resumed(rank: int, world: int, ckpt: str) -> dict:
    """4 steps unbroken, and 2 steps + save + a new trainer restored + 2
    steps, with corruption and gt-as-mono at p 0.5: both final states."""
    import dataclasses

    from stereoanywhere_tpu_torch.parallel import multihost as mh

    batches = _batches("unequal_valid") * 2

    def trainer(ckpt_dir=None):
        tr = _trainer("unequal_valid", ckpt_dir)
        tr.model.cfg = dataclasses.replace(tr.model.cfg, volume_corruption_prob=0.5)
        tr.cfg = dataclasses.replace(tr.cfg, gt_mono_prob=0.5)
        return tr

    unbroken = trainer()
    for b in batches:
        unbroken.step(_shard(b, rank, world))
    first = trainer(ckpt)
    for b in batches[:2]:
        first.step(_shard(b, rank, world))
    first.save("latest")
    mh.barrier()  # rank 0 wrote it
    resumed = trainer(ckpt)
    resumed.restore("latest")
    for b in batches[2:]:
        resumed.step(_shard(b, rank, world))
    state = lambda tr: {k: v.detach().clone() for k, v in tr.model.state_dict().items()}  # noqa: E731
    return {"unbroken": state(unbroken), "resumed": state(resumed)}


def _same_as_rank0(result: dict) -> bool:
    """Whether this rank's logs and state equal rank 0's, bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([torch.tensor([v for step in result["logs"] for v in step.values()], dtype=torch.float64)]
                     + [v.reshape(-1).double() for v in result["state"].values() if v.is_floating_point()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return torch.equal(flat, ref)


def _rank_main(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank of the trainer-level runs.  Rank 0 first runs the cases as
    one process on the whole batch (no group yet; rank 1 waits at the
    rendezvous) and keeps them, so that the comparisons run here and only
    their numbers are written (rank<r>.pt), not parameters or gradients."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh

    reference = {}
    if rank == 0:
        reference = {case: _run(case, 0, 1) for case in CASES}
        reference["reordered"] = _run("batch_statistics", 0, 1, order=[2, 3, 0, 1])
    mh.initialize_distributed("cpu", rank=rank, world_size=world, init_method=init_method)
    try:
        summary = {"same_as_rank0": {}, "gaps": {}}
        for case in [*CASES, "mean_of_means"]:
            result = _mean_of_means(rank, world) if case == "mean_of_means" else _run(case, rank, world)
            summary["same_as_rank0"][case] = _same_as_rank0(result)
            if rank == 0:
                summary["gaps"][case] = _gaps(result, reference["unequal_valid" if case == "mean_of_means" else case])
        if rank == 0:
            summary["gaps"]["reordered"] = _gaps(reference["reordered"], reference["batch_statistics"])
            start = _base_model().state_dict()
            summary["stats_moved"] = sum(not torch.equal(v, start[k])
                                         for k, v in reference["batch_statistics"]["state"].items()
                                         if k.endswith("running_var"))
        resume = _resumed(rank, world, os.path.join(out_dir, "ckpt"))
        summary["resume_equal"] = all(torch.equal(resume["resumed"][k], v) for k, v in resume["unbroken"].items())
        torch.save(summary, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mh.destroy_distributed()


def _spawn(fn, *args):
    """Start WORLD ranks of fn(rank, WORLD, init_method, *args); returns the
    context to `_join`."""
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    return torch.multiprocessing.start_processes(
        fn, args=(WORLD, f"tcp://127.0.0.1:{free_port()}", *args), nprocs=WORLD, join=False, start_method="spawn")


def _join(ctx, deadline: float) -> None:
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish within {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' summaries (`_rank_main`)."""
    out = tmp_path_factory.mktemp("dp")
    _join(_spawn(_rank_main, str(out)), time.monotonic() + TIMEOUT)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _gaps(got: dict, want: dict) -> dict[str, float]:
    """The relative gaps between two runs, by part: the logs of each step
    but `grad_norm`, each over its magnitude; `grad_norm`; the first
    step's gradient (when `got` holds it) and the parameters after the
    run, each norm-wise over all of them (an entry whose gradient cancels
    to round-off is round-off in either run, so a ratio per entry measures
    nothing); each running statistic over its largest entry."""
    gaps = dict.fromkeys(("logs", "grad_norm", "grads", "params", "stats"), 0.0)
    for g, w in zip(got["logs"], want["logs"]):
        assert g.keys() == w.keys()
        for k in w:
            part = "grad_norm" if k == "grad_norm" else "logs"
            gaps[part] = max(gaps[part], abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
    if got.get("grads") is not None:
        gaps["grads"] = float((got["grads"] - want["grads"]).norm() / want["grads"].norm())
    num = den = 0.0
    for k, w in want["state"].items():
        g = got["state"][k]
        if k.endswith(("running_mean", "running_var")):
            gaps["stats"] = max(gaps["stats"], float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12))
        elif w.is_floating_point():
            num, den = num + float(((g - w) ** 2).sum()), den + float((w ** 2).sum())
        else:
            assert torch.equal(g, w), k
    gaps["params"] = (num / den) ** 0.5
    return gaps


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process_on_the_global_batch(runs, case):
    """Both ranks hold the one-process result to 1e-6 relative (rank 1
    holds rank 0's bit for bit): the loss, every log and `grad_norm` at
    both steps, the first step's gradient, every parameter and running
    statistic after the steps.  With batch statistics the gradient of the
    context encoder's first layers carries f32 round-off amplified through
    its 33 batch-statistic BatchNorms (whichever variance formula), beyond
    1e-6 for any two summation orders: there the gradient and
    `grad_norm` are held to twice the gap between the one-process step and
    the same step on its batch's samples in another order, and the rest to
    1e-6."""
    bound = dict.fromkeys(("logs", "grad_norm", "grads", "params", "stats"), 1e-6)
    if case == "batch_statistics":
        own = runs[0]["gaps"]["reordered"]
        for part in ("grads", "grad_norm"):
            bound[part] = max(1e-6, 2 * own[part])
        assert runs[0]["stats_moved"] > 10  # the running statistics moved, and the test sees them
    gaps = runs[0]["gaps"][case]
    assert all(gaps[k] <= bound[k] for k in gaps), (case, gaps, bound)
    assert runs[1]["same_as_rank0"][case]


def test_a_mean_of_the_ranks_means_misses_the_bound(runs):
    """Each rank's loss over its own valid pixels with the gradients
    averaged (what plain gradient averaging computes) is another function
    when the ranks hold different numbers of valid pixels: far outside
    the bound the global denominators meet."""
    gaps = runs[0]["gaps"]["mean_of_means"]
    assert gaps["logs"] > 1e-2 and gaps["grads"] > 1e-2, gaps


def test_resumed_two_rank_run_equals_an_unbroken_one(runs):
    assert [r["resume_equal"] for r in runs] == [True] * WORLD


# ---------------------------------------------------------------------------
# cli train over two processes


def _flyingthings(root, n=4, h=40, w=72):
    from stereoanywhere_tpu_torch.data.frame_utils import write_mono16, write_pfm

    rng = np.random.default_rng(0)
    for side in ("left", "right"):
        for sub in (f"image_clean/{side}", f"image_clean/{side}_DAv2", f"disparity/{side}"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, f"image_clean/{side}/{i:04d}.png"))
            write_mono16(os.path.join(root, f"image_clean/{side}_DAv2/{i:04d}.png"), rng.uniform(0, 1, (h, w)))
            d = rng.uniform(1, 8, (h, w)).astype(np.float32)
            write_pfm(os.path.join(root, f"disparity/{side}/{i:04d}.pfm"), -d if side == "left" else d)
    os.makedirs(os.path.join(root, "empty"), exist_ok=True)
    return f"{root};{os.path.join(root, 'empty')};{os.path.join(root, 'empty')}"


def _train_argv(path, savedir, *extra):
    return ["train", "--dataset", "sceneflow", "--datapath", path, "--device", "cpu", "--crop-h", "32",
            "--crop-w", "64", "--batch-size", "2", "--iters", "2", "--log-every", "1", "--save-every", "100",
            "--mono-precomputed", "DAv2", "--savedir", str(savedir), "--loader-threads", "0", *extra]


def _multihost_main(rank: int, world: int, init_method: str, path: str, out_dir: str) -> None:
    """One rank of `cli train --multihost --num-steps 6` under torchrun's
    environment, in which rank 1 alone raises its stop flag during step 2.
    Records the step count and the checkpoints this rank wrote."""
    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.train import trainer as trainer_mod

    host, port = init_method.removeprefix("tcp://").split(":")
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR=host,
                      MASTER_PORT=port)
    written = []
    real_save, real_step = torch.save, trainer_mod.Trainer.step
    trainer_mod.torch.save = lambda obj, f, *a, **k: (written.append(os.path.basename(str(f))),
                                                      real_save(obj, f, *a, **k))[1]

    def step(self, batch):
        if rank == 1 and self.step_count == 1:
            self._stop_requested = True
        return real_step(self, batch)

    trainer_mod.Trainer.step = step
    tr = cli.main(_train_argv(path, os.path.join(out_dir, "run"), "--multihost", "--num-steps", "6"))
    trainer_mod.torch.save = real_save
    real_save({"steps": tr.step_count, "written": written}, os.path.join(out_dir, f"cli{rank}.pt"))


@pytest.fixture(scope="module")
def multihost_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    path = _flyingthings(str(root / "ft"))
    deadline = time.monotonic() + TIMEOUT
    _join(_spawn(_multihost_main, path, str(root)), deadline)
    return root, [torch.load(root / f"cli{r}.pt", weights_only=False) for r in range(WORLD)]


def test_cli_train_multihost_under_torchrun_environment(multihost_run):
    """`cli train --multihost` with RANK / LOCAL_RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT set: both ranks run 2 steps (until the stop
    below), rank 0 logging both."""
    root, ranks = multihost_run
    assert [r["steps"] for r in ranks] == [2, 2]
    assert [json.loads(line)["step"] for line in open(root / "run" / "metrics.jsonl")] == [1, 2]


def test_a_stop_on_one_rank_stops_both_at_one_step(multihost_run):
    """Rank 1 alone raises its stop flag during step 2: both ranks leave
    the loop after it, and rank 0 alone writes `stopped.pt` (no `final`)."""
    root, ranks = multihost_run
    assert torch.load(root / "run" / "stopped.pt", weights_only=False)["step"] == 2
    assert not (root / "run" / "final.pt").exists()
    assert ranks[1]["written"] == [] and ranks[0]["written"] == ["stopped.pt.tmp"]


def test_cli_train_data_parallel_two_ranks_on_the_cpu(tmp_path):
    """`python -m stereoanywhere_tpu_torch.cli train --data-parallel 2
    --device cpu`, as a user runs it: two gloo processes, 2 steps of a
    global batch of 2, `final` at step 2 and the metric log of rank 0."""
    path = _flyingthings(str(tmp_path / "ft"))
    save = tmp_path / "run"
    argv = _train_argv(path, save, "--data-parallel", "2", "--num-steps", "2")
    out = subprocess.run([sys.executable, "-m", "stereoanywhere_tpu_torch.cli", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "2 ranks" in out.stdout and "step 2/2" in out.stdout
    assert torch.load(save / "final.pt", weights_only=False)["step"] == 2
    rows = [line for line in open(save / "metrics.jsonl")]
    assert len(rows) == 2
