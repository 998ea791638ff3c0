"""Reading the profiler's trace: device intervals, busy time, kernels inside
spans, ranges wrapped around the port's parts for an eager pass, and each
kernel under the port's own `sa.*` span that launched it.

Copies of `chip_smoke.py`'s `busy_us`, `kernels_within` and
`module_ranges`, and of `stereoanywhere_tpu_torch/utils/profiling.py`'s
`device_by_span`, kept here so that the yardstick does not move with that
script or with the program.  Times are the profiler's microseconds.
"""
from __future__ import annotations

import bisect
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function

SPAN_PREFIX = "sa."  # the port's own spans (`utils/profiling.span`)
_USER_SCOPE = int(torch._C._profiler.RecordScope.USER_SCOPE)


@dataclass
class Segment:
    """One traced stretch: the device's kernels (name, start, end), the
    benchmark's host spans by name, the ranges' device spans by name, and
    the kernels by the port's innermost `sa.*` span open at their launch
    ("" for launches outside every such span)."""

    kernels: list[tuple[str, float, float]] = field(default_factory=list)
    host: dict[str, list[tuple[float, float]]] = field(default_factory=dict)
    ranges: dict[str, list[tuple[float, float]]] = field(default_factory=dict)
    spans: dict[str, list[tuple[str, float, float]]] = field(default_factory=dict)
    pairs: int = 0


def busy_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def clipped(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def kernels_within(kernels, spans) -> float:
    """Busy us of the kernels that lie inside one of the spans (which do not
    overlap one another)."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    inside = []
    for _, s, e in kernels:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= spans[i][1]:
            inside.append((s, e))
    return busy_us(inside)


def segment(prof, host_names, range_names=()) -> Segment:
    """The Segment of a finished `torch.profiler.profile`: device kernels
    (memory copies left out: they count as idle), the CPU spans named in
    `host_names`, the device spans of the ranges in `range_names`, and
    `spans`: each of those kernels under the innermost port span open
    when the host launched it (`span_owner`)."""
    events = list(prof.events())
    seg = Segment(host={n: [] for n in host_names}, ranges={n: [] for n in range_names})
    owner = span_owner(events)
    for e in events:
        span = (float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name in seg.ranges:
                seg.ranges[e.name].append(span)
            elif e.name not in seg.host and not e.name.startswith("Memcpy"):  # a host span's shadow, a copy
                seg.kernels.append((e.name, *span))
                name = owner(e)
                if name is not None:
                    seg.spans.setdefault(name, []).append((e.name, *span))
        elif e.name in seg.host:
            seg.host[e.name].append(span)
    return seg


def span_owner(events):
    """`owner(device_event)`: the innermost span whose name starts with
    `SPAN_PREFIX` that was open, on any thread, when the host launched the
    event; "" for a launch outside every such span; None where the event
    is a user-scope range's device copy or no launch shares its
    correlation id.  A device event and its launch (`cudaLaunch*`,
    `cudaMemcpyAsync`, `cudaGraphLaunch`: each kernel of a replay) share
    the profiler's correlation id (`id`)."""
    user = {e.name for e in events if e.device_type == DeviceType.CPU and e.scope == _USER_SCOPE}
    launches = {e.id: float(e.time_range.start) for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    spans = sorted((float(e.time_range.start), -float(e.time_range.end), e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX))
    starts = [s for s, _, _ in spans]

    def owner(e) -> str | None:
        if e.name in user or e.id not in launches:
            return None
        t = launches[e.id]
        for _, neg_end, name in reversed(spans[: bisect.bisect_right(starts, t)]):
            if t <= -neg_end:  # the latest-starting span that still holds the launch is the innermost
                return name
        return ""
    return owner


@contextmanager
def ranges(parts: dict):
    """Wrap each (owner, attribute) of `parts` (a range name -> its pairs)
    in a `record_function` range of that name; restored after."""
    saved = []
    for name, pairs in parts.items():
        for owner, attr in pairs:
            fn = getattr(owner, attr)

            def ranged(*a, _fn=fn, _name=name, **k):
                with record_function(_name):
                    return _fn(*a, **k)
            saved.append((owner, attr, attr in vars(owner), fn))
            setattr(owner, attr, ranged)
    try:
        yield
    finally:
        for owner, attr, own, fn in reversed(saved):
            if own:
                setattr(owner, attr, fn)
            else:  # a module's forward: back to its class's
                delattr(owner, attr)


def port_parts(pipe) -> dict:
    """The ranges of the eager pass: the port's modules and functions that
    the per-layer metrics read, by the names the readers use."""
    from stereoanywhere_tpu_torch.models import dinov2 as port_dinov2
    from stereoanywhere_tpu_torch.models import stereoanywhere as port_model

    return {
        "mono.pretrained": [(pipe.mono.pretrained, "forward")],
        "mono.depth_head": [(pipe.mono.depth_head, "forward")],
        "vit_attention": [(port_dinov2, "vit_attention")],
        "hourglass": [(pipe.stereo.hourglass_mono, "forward"), (port_model, "conv_in_dtype")],
        "loop": [(port_model, n) for n in ("update_nets", "refinement_step", "fused_refinement_step",
                                           "refinement_tail")],
    }


def longest_gaps(seg: Segment, n: int = 10) -> list[tuple[str, float]]:
    """The n longest stretches with no kernel running inside the traced
    pairs, each named by the benchmark's host span open at its start."""
    lo = min(s for s, _ in seg.host["pair"])
    hi = max(e for _, e in seg.host["pair"])
    gaps, end = [], lo
    for _, s, e in sorted(seg.kernels, key=lambda k: k[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    spans = sorted((s, e, name) for name, lst in seg.host.items() if name != "pair" for s, e in lst)

    def label(t: float) -> str:
        inside = [name for s, e, name in spans if s <= t < e]
        return inside[-1] if inside else "between requests"

    gaps.sort(key=lambda g: g[0] - g[1])
    return [(label(s), (e - s) / 1e6) for s, e in gaps[:n]]
