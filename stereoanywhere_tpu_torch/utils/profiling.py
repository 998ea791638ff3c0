"""Profiling helpers: the port's counterpart of the JAX package's
`utils/profiling.py`.

- `trace(logdir)`: `torch.profiler` around a block, written as a Chrome
  trace (the JAX package's `jax.profiler` trace for perfetto);
- `span(name, args)`: a named span of the port's own, recorded while a
  profiler records and nothing otherwise; `spans_of` and `device_by_span`
  read them back from a finished profile;
- `chained_timer`: a call's latency from `n_chain` calls chained through a
  data dependency and one sync at the end, so that a runtime whose sync
  returns before the device is done, or a host that issues calls faster
  than the device runs them, cannot shorten it.  On the card it times the
  card (the calls queue on its stream, the one sync waits for the last); on
  the CPU it times the CPU.

The port's spans, on the host's timeline of any `torch.profiler` profile
(`device_by_span` puts each kernel or copy under the innermost span open
when the host launched it):

- `sa.request`: all of `StereoAnywherePipeline.__call__`; its args carry
  the request's number `n`, from 0;
- `sa.to_device`: the request's views to f32 on the device
  (`GraphOwner._tensor`: the numpy copy and the H2D upload);
- `sa.warmup`, `sa.capture`: a program's first call, run eagerly, and its
  CUDA-graph capture;
- `sa.stage_inputs`, `sa.replay`, `sa.copy_out`: a replay's copy of the
  request into the graph's static inputs, `graph.replay()`, the copy of
  the graph's output handed to the caller;
- `sa.mono.resize_in`: both views concatenated, the cubic resize to the
  DAv2 size, ImageNet normalisation; `sa.mono.vit`: DAv2's ViT
  (`DepthAnythingV2.pretrained`) with its input's cast; `sa.mono.dpt`: the
  DPT head; `sa.mono.resize_out`: the depth resized back;
- `sa.stereo.prepare`: the pipeline's `normalize_and_pad`, then a second
  span in the forward: the channels-last copies, the width pad, the [-1, 1]
  scaling, the quarter-size mono depth and the normals;
- `sa.stereo.context`: the context encoder and the zqr convolutions;
  `sa.stereo.features`: the feature encoder on both views;
- `sa.stereo.volumes`: the hourglass's depth pyramids, both all-pairs
  volumes, the masks, `vol_downsample`'s resizes;
- `sa.stereo.aggregate` (the stereo-volume variant): its hourglasses,
  classifier and coarse disparities;
- `sa.stereo.hourglass`: the mono hourglass, its stack, the classifiers
  (and `vol_downsample`'s resize back);
- `sa.stereo.coarse`: coarse disparities and confidences, soft LRC,
  `weighted_lsq`, the mirror truncation, both correlation pyramids and
  `DualPyramid`;
- `sa.stereo.loop`: every refinement schedule;
- `sa.stereo.upsample`: convex upsampling and the width crop, then a
  second span in the pipeline: its unpad;
- `sa.train.forward`, `sa.train.loss`, `sa.train.backward`,
  `sa.train.optimizer`: `Trainer.step`'s phases.

The stage spans (`sa.mono.*`, `sa.stereo.*`) run wherever the Python
runs: an eager call, the warm-up, the capture.  A replay runs no Python,
so its kernels fall under `sa.replay`.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch
from torch.autograd import DeviceType

_USER_SCOPE = int(torch._C._profiler.RecordScope.USER_SCOPE)


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


_OFF = contextlib.nullcontext()


def span(name: str, args: dict | None = None):
    """A span named `name` while a profiler records, with `args` (names to
    numbers or strings) among the event's inputs (shown in its Chrome trace
    when the profiler records shapes); the one shared null context
    otherwise, so that a span costs one check when nobody profiles.

    A function-scope record function (the one torch's compiled kernels
    use), not `record_function`'s user scope: the profiler copies a user
    scope's range onto the device's timeline (`gpu_user_annotation`), where
    a reader of the kernels would count it as one more; a function scope
    stays on the host, and `device_by_span` finds each kernel's span
    through its launch."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, [], args or {})


def spans_of(events, prefix: str = "sa.") -> dict[str, list[tuple[float, float]]]:
    """The host intervals (profiler us) of the spans whose name starts with
    `prefix`, by name, from a finished profile's `events()`."""
    out: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(prefix):
            out.setdefault(e.name, []).append((float(e.time_range.start), float(e.time_range.end)))
    return out


def device_by_span(events, prefix: str = "sa.") -> dict[str, list[tuple[str, float, float]]]:
    """Every device event of a finished profile (kernel, copy or set:
    name, start, end in us) by the innermost span whose name starts with
    `prefix` that was open when the host launched it, on any thread (the
    autograd engine launches the backward from its own); "" for launches
    outside every such span.  A device event and its launch (`cudaLaunch*`,
    `cudaMemcpyAsync`, `cudaGraphLaunch`: each kernel of a replay) share
    the profiler's correlation id; the device copies of user-scope ranges
    (`record_function`) are left out."""
    events = list(events)
    user = {e.name for e in events if e.device_type == DeviceType.CPU and e.scope == _USER_SCOPE}
    launches = {e.id: float(e.time_range.start) for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    spans = sorted((s, -e, name) for name, lst in spans_of(events, prefix).items() for s, e in lst)
    starts = [s for s, _, _ in spans]
    out: dict[str, list[tuple[str, float, float]]] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in user or e.id not in launches:
            continue
        t, owner = launches[e.id], ""
        for s, neg_end, name in reversed(spans[: bisect.bisect_right(starts, t)]):
            if t <= -neg_end:  # the latest-starting span that still holds the launch is the innermost
                owner = name
                break
        out.setdefault(owner, []).append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


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
