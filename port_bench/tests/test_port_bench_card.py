"""On the card: one short run of a cell is correct and reports every
end-to-end metric, a short traced run every per-layer one, the control, on
one seed at the cell's own size, reads above the cell's limit, and the
eager pass's kernels filed under the port's `sa.*` spans add up to its
busy time and agree with the benchmark's ranges.  Skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import check, harness, traffic
from port_bench.tests import tiny
from port_bench.trace import busy_us

pytestmark = pytest.mark.cuda
CELL = "vitl_oakd400p"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels run only on the card)")


@pytest.mark.parametrize("traced", [0, 1])
def test_short_run_is_correct(card, traced):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL, "--seed",
                          str(2 ** 31 + 901 + traced), "--seconds", "3", "--trace", str(traced)], cwd=tiny.REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    names = {m["name"] for m in harness.metrics_of(harness.load_benchmark(), CELL, bool(traced))}
    assert set(result["metrics"]) == names
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if traced:
        assert result["metrics"]["extractor_device_ms"]["value"] > 0


def test_spans_cover_the_eager_pass(card):
    from stereoanywhere_tpu_torch.ops.cuda import build

    bench, dev, seed = harness.load_benchmark(), torch.device("cuda"), 2 ** 31 + 903
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg, mix = harness.config_of(bench, cell["config"]), harness.traffic_of(cell["traffic"])
    build.build()
    pipe = harness.build_program(cfg, dev, seed)
    pool = traffic.make_pool(mix, seed, dev)
    pipe(*pool[0]).cpu()  # the shape's eager call and capture, as a run's set-up makes them
    seg = harness.trace_eager(pipe, pool, mix["eager_trace_pairs"], dev)
    busy = busy_us((s, e) for _, s, e in seg.kernels)
    by_span = {name: busy_us((s, e) for _, s, e in ks) for name, ks in seg.spans.items()}
    print({name: round(us / 1e3 / seg.pairs, 4) for name, us in sorted(by_span.items())})
    assert abs(sum(by_span.values()) - busy) <= 0.005 * busy
    ctx = harness.RunContext(cfg, mix)
    ctx.eager = seg
    ranged = harness.load_reader("hourglass_device_ms")(ctx)
    spanned = by_span["sa.stereo.hourglass"] / 1e3 / seg.pairs
    assert abs(ranged - spanned) <= 0.03 * spanned, (ranged, spanned)


def test_control_fails_the_limit(card):
    out = subprocess.run([sys.executable, "port_bench/calibrate.py", "--workload", CELL, "--seeds",
                          str(2 ** 31 + 902), "--requests", "8", "--control"], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    limit = check.load_limits(CELL)["epe_bf16_units"]
    assert summary["program_max"] <= limit < summary["control_min"]
