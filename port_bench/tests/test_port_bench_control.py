"""The output check refuses what it must, at a size a CPU test holds.

A run of the tiny cell (ViT-S, 4 iterations, 64x160; `tiny.py`) on the
CPU, with the harness's look for a card skipped, is correct with the
program as it is, and not correct (1) with the control, the f32 reference
with every product's operands rounded to float8 e4m3, in the program's
place, and (2) with the timed path broken underneath so that each request
is answered with the previous request's disparity (an output buffer read
before its replay).  On this seed the program reads 2.39 bf16 units, the
control 11.5 and the stale answers 52.5; over 10 seeds at this size on the
CPU the program read 0.59-4.05 and the control 8.17-29.8, and the tiny
limit, 6.0, lies between them; the cells' own limits come from the card
(`PERF.md`).
"""
from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.reference import arith
from port_bench.tests import tiny

SEED = 2 ** 31 + 3
TINY_LIMIT = 6.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.copy_benchmark(tmp_path_factory.mktemp("bench"))
    tiny.add_tiny_cell(root, TINY_LIMIT)
    return root


def control(pipe, cfg, mix, seed):
    ref = harness.build_reference(cfg, torch.device("cpu"), seed)

    def call(left, right):
        with torch.no_grad(), arith.strict_f32(), arith.rounded_operands(torch.float8_e4m3fn):
            return ref(torch.from_numpy(left), torch.from_numpy(right))
    return call


def stale_answers(pipe, cfg, mix, seed):
    last = {}

    def call(left, right):
        out = pipe(left, right)
        previous = last.get("out", out)
        last["out"] = out
        return previous
    return call


def run(root, patch=None) -> dict:
    torch.manual_seed(0)
    return harness.run_cell(tiny.CELL, SEED, 4.0, False, device="cpu", root=root, patch=patch)


def test_program_is_correct(root):
    result = run(root)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 3


@pytest.mark.parametrize("patch", [control, stale_answers], ids=["fp8_control", "stale_answers"])
def test_check_refuses(root, patch):
    result = run(root, patch)
    assert not result["correct"], result["check"]
    assert result["check"]["epe_bf16_units"]["value"] > TINY_LIMIT
