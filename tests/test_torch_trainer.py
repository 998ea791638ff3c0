"""The port's trainer: its optimizer against optax (the JAX package's
`make_optimizer` and train step) on a small parameter tree, and the
`Trainer` and `cli train` on the CPU at a tiny size (freeze groups,
gt-as-mono, the gradient census, validation with best-checkpoint
selection, save / restore, a resumed run equal to an unbroken one, the
graceful stop, mixed precision against JAX's bf16 gradients, the
refusals)."""
import json
import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from PIL import Image

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# optimizer and schedule


@pytest.mark.parametrize("total", [10, 1000])
def test_schedule_matches_jax_at_every_step(total):
    """The lr of every step, from the schedule and from the optimizer the
    LambdaLR drives, against the JAX package's optax schedule: 1e-6
    relative (optax evaluates it in f32)."""
    from stereoanywhere_tpu.config import TrainConfig as JTrain
    from stereoanywhere_tpu.train.trainer import make_optimizer as jmake

    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import make_optimizer, onecycle_schedule

    _, jsched = jmake(JTrain(), total, {"a": jnp.zeros(2)})
    sched = onecycle_schedule(TrainConfig(), total)
    p = torch.zeros(2, requires_grad=True)
    opt, lr_sched = make_optimizer([p], TrainConfig(), total)
    for k in range(total + 3):
        want = float(jsched(k))
        np.testing.assert_allclose(sched(k), want, rtol=1e-6)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=1e-6)
        opt.step()
        lr_sched.step()
    assert sched(total) == pytest.approx(1e-4 / 1e4, rel=1e-5) and sched(0) == pytest.approx(1e-4 / 25, rel=1e-5)


def test_optimizer_matches_optax():
    """AdamW + the schedule + nan_to_num + global-norm clip + the fnet
    freeze, five steps on a small tree, against the JAX train step's
    optax chain: every trainable leaf to 1e-6 of the leaves' scale (about
    1) after each step (step 2's gradients are large enough to clip; step
    3's hold a NaN and an Inf, whose square overflows the norm, so every
    gradient clips to 0), the frozen leaf unchanged, `grad_norm` as
    optax.global_norm over the trainable leaves."""
    from stereoanywhere_tpu.config import TrainConfig as JTrain
    from stereoanywhere_tpu.train.trainer import make_optimizer as jmake

    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import apply_gradients, make_optimizer

    rng = np.random.default_rng(0)
    shapes = {"fnet": {"w": (3, 4)}, "update_block": {"w": (5, 6), "b": (6,)}, "cnet": {"w": (2, 7)}}
    params = {top: {k: rng.standard_normal(s).astype(np.float32) for k, s in sub.items()}
              for top, sub in shapes.items()}
    total = 40
    tx, _ = jmake(JTrain(lr=1e-2, weight_decay=1e-2), total, params)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    torch_params = {(top, k): torch.tensor(v, requires_grad=top != "fnet") for top, sub in params.items()
                    for k, v in sub.items()}
    trainable = [p for (top, _), p in torch_params.items() if top != "fnet"]
    opt, sched = make_optimizer(trainable, TrainConfig(lr=1e-2, weight_decay=1e-2), total)
    for step in range(5):
        scale = 50.0 if step == 2 else 0.05
        grads = {top: {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in sub.items()}
                 for top, sub in shapes.items()}
        if step == 3:
            grads["update_block"]["w"][0, 0] = np.nan
            grads["cnet"]["w"][1, 2] = np.inf
        jgrads = jax.tree.map(lambda g: jnp.nan_to_num(jnp.asarray(g)), grads)
        jgrads["fnet"] = jax.tree.map(jnp.zeros_like, jgrads["fnet"])  # the JAX step's stop_gradient
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (top, k), p in torch_params.items():
            if top != "fnet":
                p.grad = torch.from_numpy(grads[top][k].copy())
        norm = apply_gradients(opt, sched, trainable, 1.0)
        jnorm = float(optax.global_norm(jax.tree.map(lambda g: g, {k: v for k, v in jgrads.items() if k != "fnet"})))
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-6)
        assert (jnorm > 1.0) == (step in (2, 3)), (step, jnorm)
        for (top, k), p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[top][k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {top}/{k}")
        np.testing.assert_array_equal(torch_params["fnet", "w"].detach().numpy(), params["fnet"]["w"])


# ---------------------------------------------------------------------------
# the Trainer, port only, at 32x64


def _batch(seed, b=1, h=32, w=64):
    rng = np.random.default_rng(seed)
    return {
        "im2_aug": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im3_aug": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "mono2": rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32),
        "mono3": rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32),
        "gt": rng.uniform(1, 8, (b, h, w, 1)).astype(np.float32),
        "validgt": np.ones((b, h, w, 1), np.float32),
        "gt_right": rng.uniform(1, 8, (b, h, w, 1)).astype(np.float32),
        "validgt_right": np.ones((b, h, w, 1), np.float32),
    }


def _trainer(tmp_path=None, freeze=("fnet",), corruption=0.0, gt_mono=0.0, compute_dtype="float32", **kw):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(train_iters=1, valid_iters=1, things_to_freeze=tuple(freeze), gt_mono_prob=gt_mono, **kw)
    return Trainer(StereoAnywhereConfig(volume_corruption_prob=corruption, compute_dtype=compute_dtype), tc, 20,
                   device="cpu", checkpoint_dir=None if tmp_path is None else str(tmp_path))


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("freeze", [("fnet",), ("cnet", "monoagg"), ()])
def test_freeze_groups(freeze):
    """A frozen group's parameters do not require grad, stay out of the
    optimizer and come out of a step bit-identical; every other parameter
    with a gradient moves."""
    from stereoanywhere_tpu_torch.train.trainer import frozen_tops

    tr = _trainer(freeze=freeze)
    before = _state(tr.model)
    logs = tr.step(_batch(0))
    assert np.isfinite(float(logs["loss/total"])) and tr.step_count == 1
    tops = frozen_tops(freeze)
    in_opt = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    for name, p in tr.model.named_parameters():
        frozen = name.split(".")[0] in tops
        assert p.requires_grad != frozen and (id(p) in in_opt) != frozen, name
        if frozen:
            assert torch.equal(p.detach(), before[name]), name
        elif p.grad is not None and p.grad.abs().max() > 0:
            assert not torch.equal(p.detach(), before[name]), name


def test_gt_as_mono(monkeypatch):
    """With probability 1 the gt pair stands in for the mono pair (seen by
    the model after the joint min-max), unless no right gt is valid."""
    tr = _trainer(gt_mono=1.0)
    seen = []
    real = tr.model.forward
    monkeypatch.setattr(tr.model, "forward", lambda *a, **k: (seen.append(a[2].clone()), real(*a, **k))[1])
    batch = _batch(1)
    assert float(tr.step(batch)["mono_source/gt"]) == 1.0
    gt = torch.from_numpy(batch["gt"])
    lo, hi = float(torch.min(gt.min(), torch.from_numpy(batch["gt_right"]).min())), None
    assert torch.allclose(seen[0], (gt - lo) / (float(max(gt.max(), batch["gt_right"].max())) - lo + 1e-4), atol=1e-6)
    assert float(tr.step({**batch, "validgt_right": batch["validgt_right"] * 0})["mono_source/gt"]) == 0.0


def test_debug_grad_census(tmp_path):
    """`debug_grad`: a parameter whose gradient holds a NaN and one with an
    Inf are named in nan_params.json / inf_params.json, with their counts."""
    tr = _trainer(tmp_path, debug_grad=True)
    w1, w2 = tr.model.update_block.flow_head.conv1.weight, tr.model.update_block.mask[2].bias
    w1.register_hook(lambda g: torch.where(torch.arange(g.numel()).view(g.shape) < 3, torch.nan, g))
    w2.register_hook(lambda g: torch.where(torch.arange(g.numel()) == 0, torch.inf, g))
    tr.step(_batch(2))
    nan = json.load(open(tmp_path / "nan_params.json"))
    inf = json.load(open(tmp_path / "inf_params.json"))
    assert nan == {"step": 0, "params": {"update_block.flow_head.conv1.weight": 3}}
    assert inf == {"step": 0, "params": {"update_block.mask.2.bias": 1}}
    assert torch.isfinite(w1).all() and torch.isfinite(w2).all()


def _middlebury(root, rng, scenes=2, h=64, w=96):
    from stereoanywhere_tpu_torch.data.frame_utils import write_mono16, write_pfm

    for s in range(scenes):
        d = root / f"scene{s}"
        d.mkdir(parents=True)
        for name in ("im0", "im1"):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{name}.png")
            write_mono16(str(d / f"{name}_DAv2.png"), rng.uniform(0, 1, (h, w)))
        write_pfm(str(d / "disp0GT.pfm"), rng.uniform(1, 30, (h, w)).astype(np.float32))
        Image.fromarray(rng.choice(np.array([0, 128, 255], np.uint8), (h, w))).save(d / "mask0nocc.png")
    return root


def test_validate_selects_the_best_checkpoint(tmp_path):
    """`validate` runs the eval harness on the test-mode forward: its
    metrics; the first score saves `best`; a worse one leaves it."""
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset

    ds = fetch_dataset("middlebury", str(_middlebury(tmp_path / "mb", np.random.default_rng(0))), mono="DAv2")
    tr = _trainer(tmp_path / "run")
    first = tr.validate(ds, max_samples=2)
    assert {"bad 2.0", "avgerr", "is_best"} <= set(first) and first["is_best"] == 1.0
    best = tmp_path / "run" / "best.pt"
    assert best.exists() and torch.load(best, weights_only=False)["step"] == 0
    stamp = os.stat(best).st_mtime_ns
    tr._best_val = first["bad 2.0"] - 1.0  # as if a better score had been seen
    second = tr.validate(ds, max_samples=2)
    assert second["is_best"] == 0.0 and os.stat(best).st_mtime_ns == stamp
    assert second["bad 2.0"] == first["bad 2.0"]


def test_save_restore_round_trip(tmp_path):
    tr = _trainer(tmp_path, gt_mono=0.5)
    for i in range(2):
        tr.step(_batch(i))
    tr.save("latest")
    other = _trainer(tmp_path, gt_mono=0.5)
    other.restore("latest")
    assert other.step_count == 2 and other.lr == tr.lr
    a, b = tr.model.state_dict(), other.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = tr.optimizer.state_dict(), other.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k])
    assert tr._host_rng.getstate() == other._host_rng.getstate()


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    """Four steps with the volume corruption (p 0.5) and gt-as-mono (p 0.5)
    on: 2 steps, save, a new trainer restored, 2 more steps, ends bit for
    bit where 4 unbroken steps end."""
    batches = [_batch(10 + i) for i in range(4)]
    unbroken = _trainer(corruption=0.5, gt_mono=0.5)
    for b in batches:
        unbroken.step(b)
    first = _trainer(tmp_path, corruption=0.5, gt_mono=0.5)
    for b in batches[:2]:
        first.step(b)
    first.save("latest")
    resumed = _trainer(tmp_path, corruption=0.5, gt_mono=0.5)
    resumed.restore("latest")
    for b in batches[2:]:
        resumed.step(b)
    a, b = unbroken.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_corruption_draws_depend_on_seed_and_step_only():
    from stereoanywhere_tpu_torch.train.trainer import step_seed

    assert step_seed(1338, 5) == step_seed(1338, 5) != step_seed(1338, 6)
    assert step_seed(1338, 5) != step_seed(1339, 5)


def test_sigterm_requests_a_stop(tmp_path):
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        for sig in old:
            tr = _trainer(tmp_path)
            assert not tr.stop_requested
            os.kill(os.getpid(), sig)
            assert tr.stop_requested
    finally:
        for s, h in old.items():
            signal.signal(s, h)


# ---------------------------------------------------------------------------
# mixed precision


B, H, W, ITERS = 1, 32, 64, 2


@pytest.fixture(scope="module")
def bf16_case():
    """JAX's loss gradient (fnet frozen) at f32 parameters, with
    compute_dtype float32 and bfloat16, on one seeded input."""
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg, TrainConfig as JTrain
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.train.loss import stereoanywhere_loss as jloss
    from stereoanywhere_tpu.train.trainer import freeze_mask

    rng = np.random.default_rng(31)
    ins = [rng.uniform(0, 1, (B, H, W, c)).astype(np.float32) for c in (3, 3, 1, 1)]
    gt = [rng.uniform(0.5, 12, (B, H, W, 1)).astype(np.float32), np.ones((B, H, W, 1), np.float32),
          rng.uniform(0.5, 12, (B, H, W, 1)).astype(np.float32), np.ones((B, H, W, 1), np.float32)]
    v = jax.tree.map(np.asarray, jax.jit(lambda k: JSA(JCfg()).init(k, *ins, iters=1, test_mode=True))(
        jax.random.PRNGKey(2)))
    grads = {}
    for dtype in ("float32", "bfloat16"):
        model = JSA(JCfg(volume_corruption_prob=0.0, compute_dtype=dtype))

        def loss_fn(params):
            mask = freeze_mask(params, ("fnet",))
            params = jax.tree.map(lambda p, t: p if t else jax.lax.stop_gradient(p), params, mask)
            out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *ins, iters=ITERS,
                                 test_mode=False, train=True, mutable=["batch_stats"])
            return jloss(out, *gt, ins[2], ins[3], JTrain())[0]

        grads[dtype] = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(v["params"]))
    return dict(v=v, ins=ins, gt=gt, grads=grads)


def _flat_grads(grads, names) -> np.ndarray:
    """A JAX gradient tree flattened in the order of the port's parameter names."""
    from stereoanywhere_tpu_torch.compat import from_jax

    out = []
    for name in names:
        path, kind = from_jax._stereo_rename(name)
        if kind == "bn":
            path, kind = path[:-1] + [{"weight": "scale", "bias": "bias"}[path[-1]]], "raw"
        out.append(from_jax._TO_TORCH[kind](from_jax._get(grads, tuple(path))).reshape(-1))
    return np.concatenate(out)


def test_bf16_mixed_precision_gradients_match_jax(bf16_case):
    """`compute_dtype="bfloat16"`: the trainer's forward on bf16 casts of
    its f32 masters (the hourglass and classifiers on the masters, cast at
    use), its loss in f32, the gradient reaching the masters, against
    JAX's bf16 gradient at f32 parameters: norm-wise over the trainable
    parameters, within twice JAX's own gap between its bf16 and f32
    gradients (ROADMAP's rule for bf16, as for DAv2)."""
    from stereoanywhere_tpu_torch.compat import from_jax
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere
    from stereoanywhere_tpu_torch.train.loss import stereoanywhere_loss
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    case = bf16_case
    cfg = StereoAnywhereConfig(volume_corruption_prob=0.0, compute_dtype="bfloat16")
    model = from_jax.load_stereo_variables(StereoAnywhere(cfg, device="cpu", param_dtype=torch.float32), case["v"])
    tr = Trainer(cfg, TrainConfig(train_iters=ITERS), 10, device="cpu", model=model)
    ins = [torch.from_numpy(a) for a in case["ins"]]
    out = tr._forward(*ins, iters=ITERS, test_mode=False)
    total, _ = stereoanywhere_loss({k: v.float() for k, v in out.items()}, *map(torch.from_numpy, case["gt"]),
                                   ins[2], ins[3], TrainConfig())
    total.backward()
    names = [n for n, _ in tr.named_trainable]
    got = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1) for p in tr.params]).numpy()
    assert all(p.grad.dtype == torch.float32 for p in tr.params if p.grad is not None)
    want, f32 = (_flat_grads(case["grads"][d], names) for d in ("bfloat16", "float32"))
    own = np.linalg.norm(want - f32) / np.linalg.norm(f32)
    gap = np.linalg.norm(got - want) / np.linalg.norm(f32)
    assert 0 < own and gap <= 2 * own, (gap, own)


def test_bf16_step_keeps_f32_masters_and_validates_on_a_bf16_copy(tmp_path):
    """A mixed-precision step: the masters stay f32 and move; validation
    runs a bf16 copy whose parameters are the masters rounded, refreshed
    in place at each validation; the checkpoint holds the f32 masters."""
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset

    tr = _trainer(tmp_path / "run", compute_dtype="bfloat16")
    before = _state(tr.model)
    assert np.isfinite(float(tr.step(_batch(4))["loss/total"]))
    params = dict(tr.model.named_parameters())
    # the module holds the optimizer's f32 leaves again, none of the step's casts
    assert {id(p) for p in params.values()} == {id(p) for g in tr.optimizer.param_groups for p in g["params"]} | {
        id(p) for n, p in params.items() if n.startswith("fnet.")}
    assert all(p.dtype == torch.float32 and p.grad_fn is None for p in params.values())
    assert not torch.equal(params["update_block.flow_head.conv1.weight"], before["update_block.flow_head.conv1.weight"])
    ds = fetch_dataset("middlebury", str(_middlebury(tmp_path / "mb", np.random.default_rng(1))), mono="DAv2")
    for _ in range(2):
        assert np.isfinite(tr.validate(ds, max_samples=1)["avgerr"])
        copy_params = dict(tr._eval_model.named_parameters())
        assert all(copy_params[n].dtype == torch.bfloat16 and torch.equal(copy_params[n], p.to(torch.bfloat16))
                   for n, p in params.items())
        tr.step(_batch(5))
    saved = torch.load(tmp_path / "run" / "best.pt", weights_only=False)["model"]
    assert all(v.dtype == torch.float32 for v in saved.values() if v.is_floating_point())


def test_training_refuses_master_weights_in_the_compute_dtype():
    """The trainer's optimizer steps f32 masters: a model holding bf16
    parameters (an inference model) is refused."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    cfg = StereoAnywhereConfig(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="f32 master"):
        Trainer(cfg, TrainConfig(), 10, device="cpu", model=StereoAnywhere(cfg, device="cpu"))


# ---------------------------------------------------------------------------
# cli train


def _flyingthings(root, rng, n=3, h=72, w=136):
    from stereoanywhere_tpu_torch.data.frame_utils import write_mono16, write_pfm

    for i in range(n):
        for side in ("left", "right"):
            for sub in ("image_clean", f"image_clean/{side}_DAv2", "disparity"):
                os.makedirs(root / sub / side if sub != f"image_clean/{side}_DAv2" else root / sub, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"image_clean/{side}/{i:04d}.png")
            write_mono16(str(root / f"image_clean/{side}_DAv2/{i:04d}.png"), rng.uniform(0, 1, (h, w)))
            d = rng.uniform(1, 12, (h, w)).astype(np.float32)
            write_pfm(str(root / f"disparity/{side}/{i:04d}.pfm"), -d if side == "left" else d)
    return root


@pytest.fixture(scope="module")
def train_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    ft = _flyingthings(root / "ft", rng)
    (root / "empty").mkdir()
    mb = _middlebury(root / "mb", rng)
    return f"{ft};{root / 'empty'};{root / 'empty'}", str(mb), root


def _train_argv(path, savedir, *extra):
    return ["train", "--dataset", "sceneflow", "--datapath", path, "--device", "cpu", "--crop-h", "64",
            "--crop-w", "128", "--batch-size", "1", "--iters", "2", "--log-every", "2", "--save-every", "2",
            "--mono-precomputed", "DAv2", "--savedir", str(savedir), "--loader-threads", "0", *extra]


def test_cli_train_runs_validates_saves_and_resumes(train_dirs, capsys):
    """`cli train --device cpu` as a user runs it: 4 steps with validation
    every 2 (K5's plain version on the CPU), `latest` every 2, `final` at
    the end, metrics.jsonl and config.json; then `--resume latest` for 2
    more continues the step counter."""
    from stereoanywhere_tpu_torch import cli

    path, mb, root = train_dirs
    save = root / "run"
    tr = cli.main(_train_argv(path, save, "--num-steps", "4", "--val-datapath", mb, "--val-every", "2",
                              "--val-samples", "1"))
    out = capsys.readouterr().out
    assert tr.step_count == 4 and "starting at 0" in out and "val @ 2" in out and "val @ 4" in out
    for name in ("final.pt", "latest.pt", "best.pt", "metrics.jsonl", "config.json"):
        assert (save / name).exists(), name
    rows = [json.loads(line) for line in open(save / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss/total" in r] == [2, 4]
    assert all(np.isfinite(r["loss/total"]) for r in rows if "loss/total" in r)
    tr2 = cli.main(_train_argv(path, save, "--num-steps", "6", "--resume", "latest"))
    assert tr2.step_count == 6 and "starting at 4" in capsys.readouterr().out


def test_cli_train_stops_on_sigterm(train_dirs, monkeypatch):
    """A SIGTERM during a step: the loop ends after it and saves `stopped`."""
    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    path, _, root = train_dirs
    real = Trainer.step
    old = signal.getsignal(signal.SIGTERM)

    def step(self, batch):
        if self.step_count == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, batch)

    monkeypatch.setattr(Trainer, "step", step)
    try:
        tr = cli.main(_train_argv(path, root / "stopped", "--num-steps", "6"))
    finally:
        signal.signal(signal.SIGTERM, old)
    assert tr.step_count == 2 and (root / "stopped" / "stopped.pt").exists()
    assert not (root / "stopped" / "final.pt").exists()


def test_cli_train_refusals(train_dirs, monkeypatch):
    """No card: `train` raises unless --device cpu.  --data-parallel and
    --multihost together are refused, and so are more ranks on the card
    than there are cards (the JAX package's mesh message)."""
    from stereoanywhere_tpu_torch import cli

    path, _, root = train_dirs
    with pytest.raises(SystemExit):
        cli.main(_train_argv(path, root / "x", "--data-parallel", "2", "--multihost"))
    argv = _train_argv(path, root / "x", "--data-parallel", "2")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(ValueError, match=f"mesh 2x1 needs 2 devices, have {torch.cuda.device_count()}"):
        cli.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _train_argv(path, root / "y", "--num-steps", "1")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
