"""On the card: a short traced run of the aggregation variant's cell is
correct and reads its branch under the port's `sa.stereo.aggregate` span,
at a share of the branch's least time that a measurement can give.  Skips
without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

pytestmark = pytest.mark.cuda
CELL = "vitl_agg_kitti"


def test_traced_run_reads_the_branch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels run only on the card)")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL, "--seed", str(2 ** 31 + 911),
                          "--seconds", "3", "--trace", "1"], cwd=tiny.REPO, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    names = {m["name"] for m in harness.metrics_of(harness.load_benchmark(), CELL, True)}
    assert set(result["metrics"]) == names
    assert result["metrics"]["aggregate_device_ms"]["value"] > 0
    assert 0 < result["metrics"]["aggregate_roofline"]["value"] <= 100
