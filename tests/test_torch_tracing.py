"""The port's spans and counters (`utils/profiling.py` `span`, `spans_of`,
`device_by_span`; `serve/pipeline.py`'s request spans and `_Program`'s
counts), on the CPU: a tiny pipeline's eager request under `torch.profiler`
names its phases and stages once each, inside its `sa.request`, on the
clock of an enclosing `record_function`; with no profiler a span is the one
shared null context; the counts follow a program's warm-up, capture and
replays (the capture stubbed: CUDA graphs exist only on the card); and the
benchmark's existing readers read the same from a trace with the spans as
without them, since a span leaves no copy on the device's timeline."""
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from port_bench import harness
from port_bench import trace as bench_trace
from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.serve.pipeline import GraphOwner, _Program, build_pipeline
from stereoanywhere_tpu_torch.utils import profiling

torch.set_num_threads(2)

MONO = ("sa.mono.resize_in", "sa.mono.vit", "sa.mono.dpt", "sa.mono.resize_out")
STEREO = ("sa.stereo.prepare", "sa.stereo.context", "sa.stereo.features", "sa.stereo.volumes",
          "sa.stereo.aggregate", "sa.stereo.hourglass", "sa.stereo.coarse", "sa.stereo.loop", "sa.stereo.upsample")
TWO_PARTS = ("sa.stereo.prepare", "sa.stereo.upsample")  # the pipeline's part and the forward's


def _views(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (1, 32, 64, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module", params=[False, True], ids=["default", "aggregate_stereo"])
def pipe(request):
    return build_pipeline(StereoAnywhereConfig(use_aggregate_stereo_vol=request.param), MonoConfig.for_encoder("vits"),
                          iters=1, mono_size=(56, 56), device="cpu")


def _profiled(fn, record_shapes: bool = False):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        fn()
    return prof.events()


def test_a_request_is_one_sa_request_with_its_number(pipe):
    im2, im3 = _views()
    first = pipe.requests
    events = _profiled(lambda: [pipe(im2, im3) for _ in range(2)], record_shapes=True)
    requests = sorted((e for e in events if e.name == "sa.request"), key=lambda e: e.time_range.start)
    assert [e.kwinputs for e in requests] == [{"n": first}, {"n": first + 1}]
    assert pipe.requests == first + 2
    assert len(profiling.spans_of(events)["sa.to_device"]) == 2


def test_every_stage_span_once_inside_the_request(pipe):
    im2, im3 = _views(1)

    def pair():
        with record_function("pair"):
            pipe(im2, im3)

    events = _profiled(pair)
    spans = profiling.spans_of(events)
    expected = MONO + tuple(n for n in STEREO if n != "sa.stereo.aggregate" or pipe.stereo.cfg.use_aggregate_stereo_vol)
    stages = {n: v for n, v in spans.items() if n.startswith(("sa.mono.", "sa.stereo."))}
    assert set(stages) == set(expected)
    assert all(len(v) == (2 if n in TWO_PARTS else 1) for n, v in stages.items()), stages
    (req_s, req_e), = spans["sa.request"]
    (pair_s, pair_e), = [(e.time_range.start, e.time_range.end) for e in events if e.name == "pair"]
    assert pair_s <= req_s and req_e <= pair_e  # one time base: the request inside the caller's range
    ordered = sorted((s, e, n) for n, v in stages.items() for s, e in v)
    assert all(req_s <= s and e <= req_e for s, e, _ in ordered)
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(ordered, ordered[1:]))  # one after another
    # in the order of the stages, each two-part span's parts in a row
    assert [n for _, _, n in ordered] == [n for n in expected for _ in range(2 if n in TWO_PARTS else 1)]
    # function scope: the profiler makes no copy of a span on the device's timeline
    assert all(e.scope != int(torch._C._profiler.RecordScope.USER_SCOPE) for e in events if e.name.startswith("sa."))


def test_no_profiler_no_record_function(monkeypatch, pipe):
    def refuse(*a, **k):
        raise AssertionError("a record function made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("sa.request", {"n": 0}) is profiling.span("sa.replay") is profiling._OFF
    im2, im3 = _views(2)
    assert pipe(im2, im3).shape == (1, 32, 64, 1)


@contextmanager
def _capture_stub(graph, pool=None):
    yield


class _Graph:
    def replay(self):
        pass


@pytest.mark.parametrize("capture_at", [1, 2])
def test_program_counts_and_the_owner_sums_them(monkeypatch, capture_at):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _capture_stub)
    owner = GraphOwner("cpu", False)
    program = owner._program(lambda x: x + 1, capture_at)
    other = owner._program(lambda x: x * 2, capture_at)
    n = 5
    for _ in range(n):
        assert torch.equal(program(torch.zeros(3)), torch.ones(3))
    other(torch.ones(2))
    c = program.counts
    assert (c["calls"], c["warmups"], c["captures"], c["replays"]) == (n, 1, 1, n - 1)  # capture_at=2 captures and replays at once
    assert c["capture_ms"] == program.capture_ms > 0
    assert other.counts["warmups"] == 1 and other.counts["captures"] == (capture_at == 1)
    owner.requests = 7
    assert owner.counters() == {"requests": 7, "calls": n + 1, "warmups": 2,
                                "captures": 1 + (capture_at == 1), "replays": n - 1,
                                "capture_ms": program.capture_ms + other.counts["capture_ms"]}


def test_program_spans_name_each_phase(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _capture_stub)
    program = _Program(lambda x: x + 1, pool=None)
    first = profiling.spans_of(_profiled(lambda: program(torch.zeros(3))))
    later = profiling.spans_of(_profiled(lambda: program(torch.zeros(3))))
    assert sorted(first) == ["sa.capture", "sa.warmup"]
    assert sorted(later) == ["sa.copy_out", "sa.replay", "sa.stage_inputs"]


def test_a_failed_capture_counts_no_capture(monkeypatch):
    @contextmanager
    def failing(graph, pool=None):
        yield
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", failing)
    program = _Program(lambda x: x + 1, pool=None)
    with pytest.raises(RuntimeError, match="capturing"):
        program(torch.zeros(3))
    assert program.counts == {"calls": 1, "warmups": 1, "captures": 0, "replays": 0, "capture_ms": 0}


def test_an_eager_pipeline_counts_requests_and_no_program_call():
    pipe = build_pipeline(mono_cfg=None, iters=1, device="cpu")
    im2, im3 = _views(3)
    pipe(im2, im3)
    pipe(im2, im3)
    assert pipe.counters() == {"requests": 2, "calls": 0, "warmups": 0, "captures": 0, "replays": 0,
                               "capture_ms": 0}


# ---------------------------------------------------------------------------
# reading spans back, and the benchmark's readers beside them


def _ev(name, device, start, end, id=0, scope=0):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end), id=id,
                           scope=scope)


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
USER = int(torch._C._profiler.RecordScope.USER_SCOPE)


def test_device_by_span_follows_each_launch_to_its_innermost_span():
    events = [
        _ev("pair", CPU, 0, 100, id=1, scope=USER), _ev("pair", CUDA, 20, 95, id=1),  # a user range, its copy
        _ev("sa.request", CPU, 1, 60, id=2), _ev("sa.to_device", CPU, 2, 5, id=3),
        _ev("cudaMemcpyAsync", CPU, 3, 4, id=11), _ev("Memcpy HtoD (Pageable -> Device)", CUDA, 20, 22, id=11),
        _ev("sa.replay", CPU, 10, 12, id=4), _ev("cudaGraphLaunch", CPU, 10.5, 11, id=12),
        _ev("k_a", CUDA, 30, 40, id=12), _ev("k_b", CUDA, 40, 50, id=12),  # a replay's kernels, one launch
        _ev("aten::add", CPU, 13, 15, id=12),  # an op whose id is also a launch's: no launch, not counted
        _ev("cudaLaunchKernel", CPU, 14, 15, id=13), _ev("k_c", CUDA, 50, 55, id=13),  # in sa.request only
        _ev("cudaLaunchKernel", CPU, 70, 71, id=14), _ev("k_d", CUDA, 90, 95, id=14),  # outside every span
    ]
    got = profiling.device_by_span(events)
    assert got == {"sa.to_device": [("Memcpy HtoD (Pageable -> Device)", 20, 22)],
                   "sa.replay": [("k_a", 30, 40), ("k_b", 40, 50)], "sa.request": [("k_c", 50, 55)],
                   "": [("k_d", 90, 95)]}
    assert profiling.spans_of(events) == {"sa.request": [(1, 60)], "sa.to_device": [(2, 5)], "sa.replay": [(10, 12)]}


def _trace(with_spans: bool):
    """A profile's events as the card gives them: two graph pairs in the
    benchmark's `pair` / `request.call` / `request.to_host` ranges (user
    scope: each with its copy on the device), kernels and copies; with the
    port's spans, their host events too (function scope: no copy)."""
    events = []
    for p in range(2):
        t = 1000.0 * p
        for name, s, e in (("pair", 0, 900), ("request.call", 1, 500), ("request.to_host", 500, 900)):
            events += [_ev(name, CPU, t + s, t + e, scope=USER), _ev(name, CUDA, t + s + 50, t + e - 10)]
        events += [_ev("Memcpy HtoD (Pageable -> Device)", CUDA, t + 40, t + 60),
                   _ev("Memcpy DtoH (Device -> Pageable)", CUDA, t + 820, t + 850)]
        events += [_ev(f"kernel_{i % 7}", CUDA, t + 100 + 80 * i, t + 160 + 80 * i) for i in range(9)]
        if with_spans:
            events += [_ev(n, CPU, t + s, t + e) for n, s, e in (
                ("sa.request", 2, 499), ("sa.to_device", 3, 70), ("sa.stage_inputs", 71, 90),
                ("sa.replay", 91, 110), ("sa.copy_out", 111, 120))]
    return events


def _eager_trace(with_spans: bool, parts):
    """Two eager pairs with the benchmark's ranges (user scope, with device
    copies) around the port's parts, and the port's stage spans."""
    events = []
    names = list(parts)
    for p in range(2):
        t = 10000.0 * p
        events += [_ev("pair", CPU, t, t + 9000, scope=USER), _ev("pair", CUDA, t + 100, t + 8900)]
        for i, name in enumerate(names):
            s = t + 200 + 1500 * i
            events += [_ev(name, CPU, s - 150, s + 900, scope=USER), _ev(name, CUDA, s, s + 1000)]
            events += [_ev(f"k{i}_{j}", CUDA, s + 100 * j, s + 100 * j + 70) for j in range(10)]
            if with_spans:
                events += [_ev(f"sa.stereo.stage{i}", CPU, s - 160, s + 950)]
    return events


def test_the_benchmark_readers_read_the_same_beside_the_spans():
    bench = harness.load_benchmark()
    cfg = harness.config_of(bench, "sa_vitl")
    mix = harness.traffic_of("oakd400p_closed1")
    parts = ("mono.pretrained", "mono.depth_head", "vit_attention", "hourglass", "loop")

    def context(with_spans: bool):
        ctx = harness.RunContext(cfg, mix, latencies_s=[0.06, 0.061], window_s=1.0, setup_s=20.0, peak_bytes=2 ** 31,
                                 pool_bytes=2 ** 30)
        ctx.graph = bench_trace.segment(SimpleNamespace(events=lambda: _trace(with_spans)), harness.HOST_SPANS)
        ctx.graph.pairs = 2
        ctx.eager = bench_trace.segment(SimpleNamespace(events=lambda: _eager_trace(with_spans, parts)), ("pair",),
                                        dict.fromkeys(parts))
        ctx.eager.pairs = 2
        return ctx

    plain, spanned = context(False), context(True)
    readers = [m["name"] for m in bench["per_layer"]]
    assert {"kernels_per_pair", "idle_share", "request_host_ms", "mono_device_ms", "loop_device_ms"} <= set(readers)
    for name in readers:
        read = harness.load_reader(name)
        want = read(plain)
        assert want is not None, name
        assert read(spanned) == want, name
    assert harness.load_reader("kernels_per_pair")(plain) == 9  # copies and the ranges' copies left out
    # a user-scope span would leak: its device copy counts as one more kernel
    leaky = context(True)
    leaky.graph.kernels.append(("sa.request", 52.0, 489.0))
    assert harness.load_reader("kernels_per_pair")(leaky) != harness.load_reader("kernels_per_pair")(plain)
