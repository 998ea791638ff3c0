"""On the card: one short run of a cell is correct and reports every
end-to-end metric, and the control, on one seed at the cell's own size,
reads above the cell's limit.  Skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import check, harness
from port_bench.tests import tiny

pytestmark = pytest.mark.cuda
CELL = "vitl_oakd400p"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels run only on the card)")


def test_short_run_is_correct(card):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL, "--seed", str(2 ** 31 + 901),
                          "--seconds", "3", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    names = {m["name"] for m in harness.metrics_of(harness.load_benchmark(), CELL, False)}
    assert set(result["metrics"]) == names
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


def test_control_fails_the_limit(card):
    out = subprocess.run([sys.executable, "port_bench/calibrate.py", "--workload", CELL, "--seeds",
                          str(2 ** 31 + 902), "--requests", "8", "--control"], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    limit = check.load_limits(CELL)["epe_bf16_units"]
    assert summary["program_max"] <= limit < summary["control_min"]
