"""The metric arithmetic: latencies and rates over every request, the
kernels' FLOP and byte counts against the bounds that PERF.md's kernel
table records, the shares of a peak below 105% on recorded card times,
the model's FLOPs a pair as counted before a configuration could name its
reference, and each kernel of a synthetic trace under the port's span
that launched it."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench import flops, harness, trace
from port_bench.trace import Segment

READERS = {m: harness.load_reader(m) for m in ("pair_ms_p50", "pair_ms_p95", "pairs_per_s", "idle_share",
                                               "kernels_per_pair", "request_host_ms", "pair_mfu",
                                               "extractor_device_ms")}
BENCH = harness.load_benchmark()
VIT_L = dict(d=1024, heads=16, hidden=4096)
# PERF.md section 6, K1-K4 at B = 2: (bound ms, device ms) at T = 1370 and 4552
RECORDS = {
    "K1": ((0.0174, 0.0348), (0.0579, 0.1156)),
    "K2": ((0.0155, 0.0477), (0.1716, 0.3950)),
    "K3": ((0.0058, 0.0120), (0.0193, 0.0418)),
    "K4": ((0.0465, 0.0912), (0.1544, 0.2829)),
}


def ctx(latencies, window):
    c = harness.RunContext({}, {})
    c.latencies_s, c.window_s = list(latencies), window
    return c


def test_latency_and_rate_over_all_requests():
    steady = [0.1] * 100
    base = ctx(steady, 10.0)
    assert READERS["pair_ms_p50"](base) == pytest.approx(100.0)
    assert READERS["pair_ms_p95"](base) == pytest.approx(100.0)
    assert READERS["pairs_per_s"](base) == pytest.approx(10.0)
    # six stalled requests of 2 s among them: the tail and the rate move, the median does not
    stalled = ctx(steady[:94] + [2.0] * 6, 9.4 + 12.0)
    assert READERS["pair_ms_p50"](stalled) == pytest.approx(100.0)
    assert READERS["pair_ms_p95"](stalled) > 1000.0
    assert READERS["pairs_per_s"](stalled) == pytest.approx(100 / 21.4)


def kernel_counts(t: int):
    d, heads, hidden = VIT_L["d"], VIT_L["heads"], VIT_L["hidden"]
    return {"K1": flops.ln_dense(2, t, d), "K2": flops.attention_core(2, t, heads, d // heads),
            "K3": flops.dense_residual(2, t, d), "K4": flops.mlp(2, t, d, hidden)}


@pytest.mark.parametrize("i,t", [(0, 1370), (1, 4552)])
def test_kernel_bounds_match_the_record(i, t):
    for k, (f, m) in kernel_counts(t).items():
        bound, device_ms = RECORDS[k][i]
        assert round(flops.least_ms(f, m), 4) == bound, k
        assert 100.0 * flops.least_ms(f, m) / device_ms < 105.0, k


def test_vit_least_time_sums_the_kernels():
    t = flops.tokens(375, 1242)
    assert t == 4552
    per_block = sum(flops.least_ms(*c) for c in kernel_counts(t).values())
    assert flops.vit_least_ms(2, t, 1024, 16, 24, "mlp") == pytest.approx(24 * per_block)
    recorded_vit_ms = 21.83  # PERF.md section 6, device ms of the ViT at 375x1242 before the benchmark
    assert 100.0 * flops.vit_least_ms(2, t, 1024, 16, 24, "mlp") / recorded_vit_ms < 105.0


def test_pair_mfu_below_the_peak_on_recorded_requests():
    # warm graph requests recorded before the benchmark (PERF.md section 6):
    # ViT-L 131.5 ms at 375x1242, 56.5 ms at 512x512
    cfg = harness.config_of(BENCH, "sa_vitl")
    for (h, w), ms in (((375, 1242), 131.5), ((512, 512), 56.5)):
        work = flops.pair_flops(cfg, h, w)
        seg = Segment(host={"pair": [(0.0, ms * 1e3)]})
        c = harness.RunContext(cfg, {"height": h, "width": w})
        c.graph = seg
        mfu = READERS["pair_mfu"](c)
        assert mfu == pytest.approx(100.0 * work / (ms * 1e-3 * flops.PEAK_BF16_FLOPS))
        assert 0.0 < mfu < 105.0
    assert 16e12 < flops.pair_flops(cfg, 375, 1242) < 20e12


# `flops.pair_flops(encoder, h, w, 32)` before a configuration could name
# its reference (the default `StereoAnywhere()` under DAv2 at 518)
PREVIOUS_FLOPS = {("sa_vitl", 375, 1242): 17974097301328.0, ("sa_vitl", 400, 640): 7772577582848.0,
                  ("sa_vitg", 375, 1242): 43998876683088.0, ("sa_vitg", 400, 640): 18680613325568.0}


@pytest.mark.parametrize("config,h,w", list(PREVIOUS_FLOPS))
def test_pair_flops_as_before(config, h, w):
    assert flops.pair_flops(harness.config_of(BENCH, config), h, w) == PREVIOUS_FLOPS[config, h, w]


def test_trace_readers():
    # two pairs of 10 ms each; kernels busy 6 ms of the first and 8 of the second
    seg = Segment(kernels=[("k", 0.0, 6000.0), ("k", 10000.0, 14000.0), ("k", 13000.0, 18000.0)],
                  host={"pair": [(0.0, 10000.0), (10000.0, 20000.0)]}, pairs=2)
    c = harness.RunContext({}, {})
    c.graph = seg
    assert READERS["kernels_per_pair"](c) == 1.5
    assert READERS["idle_share"](c) == pytest.approx(30.0)
    assert READERS["request_host_ms"](c) == pytest.approx(3.0)
    c.graph = None
    assert READERS["idle_share"](c) is None


USER = trace._USER_SCOPE


def event(name, start, end, device=DeviceType.CPU, id=0, scope=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=device, id=id,
                           scope=scope)


def kernel(name, start, id):
    return event(name, start, start + 5.0, DeviceType.CUDA, id)


class Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_kernels_under_the_innermost_port_span():
    events = [
        event("pair", 0.0, 200.0, scope=USER), event("bench.range", 0.0, 200.0, scope=USER),
        event("sa.request", 0.0, 100.0),
        event("sa.stereo.features", 10.0, 40.0), event("sa.stereo.context", 50.0, 60.0),
        event("sa.stereo.hourglass", 60.0, 90.0), event("sa.inner", 70.0, 80.0),
        event("aten::conv2d", 11.0, 30.0),  # an operator: no launch
        event("cudaLaunchKernel", 15.0, 16.0, id=1), kernel("k_features", 100.0, 1),
        event("cudaLaunchKernel", 45.0, 46.0, id=2), kernel("k_request", 110.0, 2),
        event("cuLaunchKernelEx", 55.0, 56.0, id=3), kernel("k_context", 120.0, 3),
        event("cudaLaunchKernel", 75.0, 76.0, id=4), kernel("k_inner", 130.0, 4),
        event("cudaLaunchKernel", 85.0, 86.0, id=5), kernel("k_hourglass", 140.0, 5),
        event("cudaLaunchKernel", 150.0, 151.0, id=6), kernel("k_outside", 160.0, 6),
        kernel("k_no_launch", 170.0, 7),
        event("cudaMemcpyAsync", 20.0, 21.0, id=8), kernel("Memcpy HtoD (Pageable -> Device)", 175.0, 8),
        event("cudaLaunchKernel", 25.0, 26.0, id=9), kernel("bench.range", 180.0, 9),  # a user range's copy
        kernel("pair", 0.0, 10),
    ]
    seg = trace.segment(Profile(events), ("pair",))
    assert [k[0] for k in seg.kernels] == ["k_features", "k_request", "k_context", "k_inner", "k_hourglass",
                                           "k_outside", "k_no_launch", "bench.range"]
    assert {name: [k[0] for k in ks] for name, ks in seg.spans.items()} == {
        "sa.stereo.features": ["k_features"], "sa.request": ["k_request"], "sa.stereo.context": ["k_context"],
        "sa.inner": ["k_inner"], "sa.stereo.hourglass": ["k_hourglass"], "": ["k_outside"]}
    assert seg.spans["sa.stereo.features"] == [("k_features", 100.0, 105.0)]
    assert seg.host["pair"] == [(0.0, 200.0)]


def test_extractor_device_ms():
    c = harness.RunContext({}, {})
    assert READERS["extractor_device_ms"](c) is None
    c.eager = Segment(kernels=[("k", 0.0, 9000.0)], spans={"sa.stereo.loop": [("k", 0.0, 9000.0)]}, pairs=2)
    assert READERS["extractor_device_ms"](c) == 0.0
    c.eager.spans.update({"sa.stereo.context": [("k", 0.0, 2000.0), ("k", 10000.0, 12000.0)],
                          "sa.stereo.features": [("k", 2000.0, 5000.0), ("k", 12000.0, 15000.0)]})
    assert READERS["extractor_device_ms"](c) == pytest.approx(5.0)
