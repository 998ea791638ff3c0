"""Trainer: AdamW with the JAX package's one-cycle schedule, global-norm
clipping, frozen parameter groups, periodic validation, checkpoints and a
graceful stop: the JAX package's `train/trainer.py` in PyTorch idiom.

- The schedule is the JAX package's (`make_optimizer`), not torch's
  OneCycleLR: max(int(total * pct_start), 1) warm-up steps, linear from
  lr/25 to lr, then linear down to lr/1e4; step k takes the schedule's
  value at k (optax reads its count before it increments it).  It runs as
  a `LambdaLR`.
- AdamW(betas (0.9, 0.999), eps, weight decay) is optax.adamw's decoupled
  decay.  A trainable parameter that got no gradient takes a zero one, as
  optax treats it (momentum decays and weight decay applies).
- Gradients go through `nan_to_num`, then `optax.clip_by_global_norm`:
  g * max / |g| when |g| >= max (not `clip_grad_norm_`'s 1e-6 guard).
  `grad_norm` logs |g| over all gradients.
- Freeze groups (reference freeze_for_finetuning): fnet | cnet with the
  context_zqr convs | monoagg (the mono hourglass and classifiers).
  Frozen parameters do not require grad and stay out of the optimizer.
- The mono inputs go through nan_to_num, a joint min-max normalisation and
  are detached inside the step; with probability gt_mono_prob (host
  `random.Random(seed + 2)`) the gt disparity pair stands in for them when
  some right gt is valid (reference train.py:253-268).
- The volume corruption draws from a host generator seeded from (seed + 1,
  step), so a resumed run draws what an unbroken one draws.
- The step is eager and returns its logs as device tensors: reading them
  (`float`) is the caller's sync, so the host need not wait every step.
- Mixed precision (`compute_dtype="bfloat16"`): the optimizer holds f32
  master parameters, and the forward runs on bf16 casts of them through
  `torch.func.functional_call`, with autograd through the cast, as the
  JAX package's layers cast their f32 kernels at use.  The mono
  hourglass and its classifiers get the masters uncast: their layers cast
  at use (`conv_in_dtype`), so the part that runs in f32 past the
  hourglass's first gate runs on f32 weights, as in JAX.  The loss runs
  in f32.  Validation runs a bf16 copy of the model (what inference
  holds), refreshed from the masters in place.
- Over several ranks (`parallel/multihost.py`, each rank stepping on its
  slice of the global batch) the step computes the one-process step on
  the whole batch: the loss's denominators, BatchNorm's statistics and the
  volume corruption are the global batch's (`train/loss.py`,
  `models/stereoanywhere.py`); after the backward the gradients are
  summed over the ranks in one flat buffer, before the NaN guard, the
  global norm and the clip; the gt-as-mono condition is the global batch's.
  Rank 0 alone writes checkpoints; every rank restores.
- `validate` runs the test-mode forward (K5 on the card) through the eval
  harness on `eval/programs.py`'s graphs, which read the parameters in
  place; the fused loop's packed weights are packed anew first.
- `save` / `restore`: `torch.save` of the step, the model (f32 masters and
  BatchNorm's running statistics), optimizer and scheduler state and the
  host generators, as `<savedir>/<tag>.pt`.
- SIGTERM / SIGUSR1 set `stop_requested`; the caller saves `stopped`.
"""
from __future__ import annotations

import copy
import json
import os
import random
import signal
from typing import Any

import numpy as np
import torch

from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
from stereoanywhere_tpu_torch.device import resolve_device, torch_dtype
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
from stereoanywhere_tpu_torch.ops.geometry import joint_minmax_normalize
from stereoanywhere_tpu_torch.parallel.multihost import all_reduce_sum, any_rank, distributed, rank_and_world
from stereoanywhere_tpu_torch.train.loss import stereoanywhere_loss
from stereoanywhere_tpu_torch.utils.profiling import span

FREEZE_GROUPS = {
    "fnet": ("fnet",),
    "cnet": ("cnet", "context_zqr_convs"),
    "monoagg": ("hourglass_mono", "classifier_mono", "classifier_monoconf"),
}
BATCH_KEYS = ("im2_aug", "im3_aug", "mono2", "mono3", "gt", "validgt", "gt_right", "validgt_right")
# the modules whose layers cast their weights to their input's dtype at use
# (`conv_in_dtype`): in mixed precision they take the f32 masters uncast
CAST_AT_USE = ("hourglass_mono", "classifier_mono", "classifier_monoconf")


def frozen_tops(things_to_freeze) -> set[str]:
    """The top-level module names the freeze groups cover."""
    tops = set()
    for g in things_to_freeze:
        if g not in FREEZE_GROUPS:
            raise ValueError(f"unknown freeze group {g!r}; use {sorted(FREEZE_GROUPS)}")
        tops.update(FREEZE_GROUPS[g])
    return tops


def onecycle_schedule(cfg: TrainConfig, total_steps: int):
    """The JAX package's schedule: step -> lr (optax.join_schedules of two
    optax.linear_schedule pieces, in optax's f32 arithmetic)."""
    total = max(total_steps, 2)
    warmup = max(int(total * cfg.pct_start), 1)
    rest = max(total - warmup, 1)

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        frac = np.float32(1) - np.float32(count) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    def lr_at(step: int) -> float:
        if step < warmup:
            return linear(cfg.lr / 25.0, cfg.lr, warmup, step)
        return linear(cfg.lr, cfg.lr / 1e4, rest, step - warmup)

    return lr_at


def make_optimizer(params, cfg: TrainConfig, total_steps: int):
    """(AdamW over `params`, the LambdaLR that gives step k the schedule's
    lr at k): the JAX package's `make_optimizer` without its masks (frozen
    parameters are simply left out of `params`)."""
    optimizer = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=cfg.adam_eps,
                                  weight_decay=cfg.weight_decay)
    schedule = onecycle_schedule(cfg, total_steps)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda k: schedule(k) / cfg.lr)


def apply_gradients(optimizer, scheduler, params, grad_clip: float) -> torch.Tensor:
    """One optimizer step on the gradients in `params`' `.grad`: a missing
    gradient taken as zero (as optax sees it), nan_to_num, clip to global
    norm `grad_clip` as `optax.clip_by_global_norm` does, the AdamW step
    and the schedule's step.  Returns the global norm before clipping (a
    device tensor)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    for g in grads:
        torch.nan_to_num_(g)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < grad_clip, g, g / norm * grad_clip))
    optimizer.step()
    scheduler.step()
    return norm


def step_seed(seed: int, step: int) -> int:
    """A 64-bit seed from (seed, step), as `jax.random.fold_in` keys a step."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def _normalized_mono(m2: torch.Tensor, m3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """nan_to_num, joint min-max over both views (NHWC), detached."""
    m2, m3 = (torch.nan_to_num(m, posinf=0.0, neginf=0.0).permute(0, 3, 1, 2) for m in (m2, m3))
    m2, m3 = joint_minmax_normalize([m2, m3])
    return m2.permute(0, 2, 3, 1).detach(), m3.permute(0, 2, 3, 1).detach()


class Trainer:
    """Holds the model, the optimizer and the schedule; `step(batch)` runs
    one training step.  `device` defaults to the card and raises without
    one unless "cpu" is asked for; the model's weights are random from
    `train_cfg.seed` unless `model` is given (its parameters in f32: the
    masters).  Inside an initialized process group the trainer is one rank
    of a data-parallel run, and `step` takes this rank's slice of each
    global batch."""

    def __init__(
        self,
        model_cfg: StereoAnywhereConfig,
        train_cfg: TrainConfig,
        total_steps: int,
        device: str | torch.device = "cuda",
        checkpoint_dir: str | None = None,
        model: StereoAnywhere | None = None,
    ):
        self.device = resolve_device(device)
        self.cfg = train_cfg
        self.checkpoint_dir = checkpoint_dir
        self.rank = rank_and_world()[0]
        self.model = model if model is not None else StereoAnywhere(
            model_cfg, device=self.device, generator=torch.Generator().manual_seed(train_cfg.seed),
            param_dtype=torch.float32)
        if any(p.dtype != torch.float32 for p in self.model.parameters()):
            raise ValueError("the trainer's model holds the f32 master parameters: build it with "
                             "param_dtype=torch.float32")
        cdt = torch_dtype(self.model.cfg.compute_dtype)
        # the dtype each parameter enters the forward in (None: f32 throughout)
        self._forward_dtypes = None if cdt == torch.float32 else {
            name: torch.float32 if name.split(".")[0] in CAST_AT_USE else cdt
            for name, _ in self.model.named_parameters()}
        self._eval_model = self.model if cdt == torch.float32 else None
        tops = frozen_tops(train_cfg.things_to_freeze)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name.split(".")[0] not in tops)
        self.named_trainable = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named_trainable]
        self.optimizer, self.scheduler = make_optimizer(self.params, train_cfg, total_steps)
        self.step_count = 0
        self._host_rng = random.Random(train_cfg.seed + 2)
        self._stop_requested = False
        self._best_val = float("inf")
        self._val_programs: dict[int, Any] = {}
        if checkpoint_dir:
            self._install_signal_handlers()

    @property
    def lr(self) -> float:
        """The learning rate the next step takes."""
        return self.optimizer.param_groups[0]["lr"]

    # -- stepping --------------------------------------------------------
    @staticmethod
    def _has_valid_right(batch: dict) -> bool:
        """Right-gt validity for the gt-as-mono branch, over the global
        batch: on the host for the loader's numpy batches, so that no step
        waits for the device."""
        v = batch["validgt_right"]
        return any_rank(bool(np.any(v > 0)) if isinstance(v, np.ndarray) else bool((v > 0).any()))

    def _tensor(self, x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return t.to(self.device, torch.float32, non_blocking=True)

    def step(self, batch: dict) -> dict[str, torch.Tensor]:
        """One training step on a batch of NHWC arrays (BATCH_KEYS); mono2 /
        mono3 may be raw mono depth.  Returns the logs as device tensors."""
        cfg = self.cfg
        used_gt_mono = 0.0
        if cfg.gt_mono_prob > 0 and self._host_rng.random() < cfg.gt_mono_prob and self._has_valid_right(batch):
            # the gt-as-mono robustness branch (reference train.py:253-260)
            batch = {**batch, "mono2": batch["gt"], "mono3": batch["gt_right"]}
            used_gt_mono = 1.0
        b = {k: self._tensor(batch[k]) for k in BATCH_KEYS}
        generator = torch.Generator().manual_seed(step_seed(cfg.seed + 1, self.step_count))
        with span("sa.train.forward"):
            m2, m3 = _normalized_mono(b["mono2"], b["mono3"])
            outputs = self._forward(b["im2_aug"], b["im3_aug"], m2, m3, iters=cfg.train_iters, test_mode=False,
                                    generator=generator)
        with span("sa.train.loss"):
            if self._forward_dtypes is not None:
                outputs = {k: v.float() for k, v in outputs.items()}
            total, logs = stereoanywhere_loss(outputs, b["gt"], b["validgt"], b["gt_right"], b["validgt_right"],
                                              m2, m3, cfg)
        with span("sa.train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span("sa.train.optimizer"):
            if distributed():
                self._sum_gradients()
            if cfg.debug_grad:
                self._dump_grad_census()
            norm = apply_gradients(self.optimizer, self.scheduler, self.params, cfg.grad_clip)
        self.step_count += 1
        logs = {k: v.detach() for k, v in logs.items()}
        logs["grad_norm"] = norm
        logs["mono_source/gt"] = torch.tensor(used_gt_mono)
        return logs

    def _forward(self, *args, **kwargs) -> dict[str, torch.Tensor]:
        """The train-mode forward; in mixed precision on the masters cast to
        the dtypes the forward takes them in (autograd through the casts)."""
        if self._forward_dtypes is None:
            return self.model(*args, **kwargs)
        params = {n: p.to(self._forward_dtypes[n]) for n, p in self.model.named_parameters()}
        # without tying: a residual block's norm3 is also its downsample.1 (one
        # module, two names), and tying would swap it twice and restore the cast
        return torch.func.functional_call(self.model, params, args, kwargs, tie_weights=False)

    def _sum_gradients(self) -> None:
        """Every trainable gradient summed over the ranks, in one flat
        buffer (a missing gradient as zeros, as optax sees it), copied back
        into tensors of their own: a reduction over a view at an odd
        offset of the buffer could vectorize, and so round, otherwise."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        for p, g, summed in zip(self.params, grads, flat.split([p.numel() for p in self.params])):
            p.grad = g.copy_(summed.view_as(g))

    def _dump_grad_census(self) -> None:
        """Per-parameter NaN / Inf gradient counts, the nonzero ones, into
        nan_params.json / inf_params.json of the checkpoint directory
        (reference --debug_grad, train.py:391-418).  Syncs with the device."""
        counts = {kind: {} for kind in ("nan", "inf")}
        for name, p in self.named_trainable:
            if p.grad is None:
                continue
            for kind, test in (("nan", torch.isnan), ("inf", torch.isinf)):
                n = int(test(p.grad).sum())
                if n:
                    counts[kind][name] = n
        out_dir = self.checkpoint_dir or "."
        os.makedirs(out_dir, exist_ok=True)
        for kind, m in counts.items():
            if m:
                with open(os.path.join(out_dir, f"{kind}_params.json"), "w") as f:
                    json.dump({"step": self.step_count, "params": m}, f, indent=2)

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested

    # -- validation ------------------------------------------------------
    def validate(self, samples, iters: int | None = None, metric: str = "bad 2.0", save_best_tag: str = "best",
                 mono_fn=None, dataset_name: str = "middlebury", max_samples: int | None = None) -> dict:
        """Periodic validation with best-checkpoint selection by `metric`
        (reference train.py:583-639).  `samples`: dataset samples with
        im2/im3, precomputed mono (im2_mono/im3_mono) unless `mono_fn` is
        given, and gt/validgt.  Returns the mean metrics and `is_best`;
        saves `save_best_tag` when `metric` improves."""
        from stereoanywhere_tpu_torch.eval.harness import Evaluator
        from stereoanywhere_tpu_torch.eval.programs import EvalPrograms

        iters = self.cfg.valid_iters if iters is None else iters
        if self._eval_model is None:
            # mixed precision: a copy holding the compute dtype, as inference does
            self._eval_model = copy.deepcopy(self.model).to(torch_dtype(self.model.cfg.compute_dtype))
        if self._eval_model is not self.model:
            with torch.no_grad():
                for dst, src in zip(self._eval_model.state_dict().values(), self.model.state_dict().values()):
                    dst.copy_(src)
        if iters not in self._val_programs:
            # one program set an iteration count: their graphs read the
            # parameters in place, so they follow every optimizer step
            self._val_programs[iters] = EvalPrograms(self._eval_model, None, iters=iters, device=self.device)
        # the fused loop's packs are copies of the parameters: pack them anew
        self._eval_model.update_block.refresh_fused_weights()
        ev = Evaluator(self._val_programs[iters].stereo_fn, mono_fn=mono_fn, dataset_name=dataset_name)
        means = ev.run(samples, max_samples=max_samples).mean()
        score = means.get(metric, float("nan"))
        if np.isfinite(score) and score < self._best_val:
            self._best_val = score
            self.save(save_best_tag)
        means["is_best"] = float(score <= self._best_val)
        return means

    # -- checkpoints -----------------------------------------------------
    def _install_signal_handlers(self):
        def handler(signum, frame):
            # finish the step; the caller then saves `stopped` (reference train.py:507-511)
            self._stop_requested = True

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass  # not the main thread

    def checkpoint_path(self, tag: str) -> str:
        return os.path.join(self.checkpoint_dir or ".", f"{tag}.pt")

    def save(self, tag: str = "latest") -> None:
        """Write the state as `<checkpoint_dir>/<tag>.pt` (rank 0 alone)."""
        if not self.checkpoint_dir or self.rank != 0:
            return
        path = self.checkpoint_path(tag)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        state = {"step": self.step_count, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "scheduler": self.scheduler.state_dict(), "host_rng": self._host_rng.getstate(),
                 "best_val": self._best_val}
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore(self, tag: str = "latest") -> None:
        """Load a `save`d state in place (a graph that reads the parameters
        keeps reading them).  Read to the host: the optimizer moves its
        moments to the parameters' device and keeps its step counts on the
        host, where reading them costs no device sync."""
        state = torch.load(self.checkpoint_path(tag), map_location="cpu", weights_only=False)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self._host_rng.setstate(state["host_rng"])
        self._best_val = state["best_val"]
        self.step_count = int(state["step"])
