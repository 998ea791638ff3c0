"""Profiling helpers: the port's counterpart of the JAX package's
`utils/profiling.py`.

- `trace(logdir)`: `torch.profiler` around a block, written as a Chrome
  trace (the JAX package's `jax.profiler` trace for perfetto);
- `chained_timer`: a call's latency from `n_chain` calls chained through a
  data dependency and one sync at the end, so that a runtime whose sync
  returns before the device is done, or a host that issues calls faster
  than the device runs them, cannot shorten it.  On the card it times the
  card (the calls queue on its stream, the one sync waits for the last); on
  the CPU it times the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the host and, where there is a card, its kernels)
    and write `logdir/trace_<pid>_<ms>.json` (Chrome trace format; open it
    in perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def _tensor_leaves(out) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensor_leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensor_leaves(v)


def _perturb(a, eps: torch.Tensor):
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a + eps.to(a.dtype)
    return a


def chained_timer(
    fn: Callable,
    *args,
    n_chain: int = 8,
    repeats: int = 3,
    const_args=(),
    return_samples: bool = False,
):
    """Median seconds a call of `fn(*const_args, *args)`, from `repeats`
    runs of `n_chain` serial calls each.

    Every floating-point tensor of `args` is perturbed before each call by
    `acc * 1e-12`, where `acc` is a scalar on the arguments' device that
    carries the sum of the means of every earlier call's output tensors: a
    call cannot start before the one before it ended, and none can be
    skipped or hoisted (the JAX version's lesson: perturbing only one input
    let the compiler move the branches that did not read it out of the
    chain).  Numpy float arrays among `args` become tensors first, on the
    device of the first tensor argument (the CPU without one).  `const_args`
    go first and unperturbed (weights, say).  Each run ends in one sync (a
    read of `acc` on the host); the round trip of a sync after a trivial op
    on that device (the median of 3) is subtracted.  With
    `return_samples=True` returns `(median, samples)`, the corrected
    per-call seconds of each run.
    """
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    args = tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) and a.dtype.kind == "f" else a
                 for a in args)

    def chained() -> float:
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n_chain):
            eps = acc * 1e-12
            out = fn(*const_args, *(_perturb(a, eps) for a in args))
            acc = acc + sum(leaf.float().mean() for leaf in _tensor_leaves(out))
        return float(acc)

    def trivial() -> float:
        return float(torch.zeros((), device=device) + 1)

    trivial()
    chained()  # the warm-up: first calls, cuDNN's search, captures

    rtts = []
    for _ in range(3):
        t0 = time.perf_counter()
        trivial()
        rtts.append(time.perf_counter() - t0)
    rtt = float(np.median(rtts))

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        chained()
        times.append(time.perf_counter() - t0)
    samples = [max(t - rtt, 0.0) / n_chain for t in times]
    median = max(float(np.median(times)) - rtt, 0.0) / n_chain
    if return_samples:
        return median, samples
    return median
