"""A model variant is added as new files and entries only: a configuration
that names a reference module of its own, that module, a cell and a
per-layer metric on `ctx.eager.spans` (`tiny.add_variant`), in a copy of
the benchmark.  A traced run of its cell on the CPU, with the harness's
look for a card skipped, builds the variant's own reference for the check,
is correct, and reports the span metric (0 kernels on the CPU, whose
profile holds no device events; the card test reads the real spans)."""
from __future__ import annotations

import sys

import pytest
import torch

from port_bench import flops, harness
from port_bench.tests import tiny

SEED = 2 ** 31 + 3
LIMIT = 6.0  # the tiny cell's (test_port_bench_control.py)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.copy_benchmark(tmp_path_factory.mktemp("bench"))
    tiny.add_tiny_cell(root, LIMIT)
    before = tiny.digests(root)
    tiny.add_variant(root, LIMIT)
    after = tiny.digests(root)
    assert {p for p in before if before[p] != after[p]} == {root.joinpath("BENCHMARK.json").relative_to(root)}
    return root


def test_variant_cell_runs_with_its_own_reference(root):
    torch.manual_seed(0)
    result = harness.run_cell(tiny.VARIANT_CELL, SEED, 2.0, True, device="cpu", root=root)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"] == {tiny.VARIANT_METRIC: {"value": 0.0, "unit": "kernels"}}
    # the last reference built (the bf16 yardstick's) came from the variant's module
    assert sys.modules["port_bench_reference_tiny_variant"].BUILT == ["sa_vits_tiny_variant"]


def test_variant_flops_count_its_reference(root):
    bench = harness.load_benchmark(root)
    variant = harness.config_of(bench, "sa_vits_tiny_variant", root)
    work = flops.pair_flops(variant, 64, 160, root)
    assert sys.modules["port_bench_reference_tiny_variant"].BUILT == ["sa_vits_tiny_variant"]
    assert work == flops.pair_flops(harness.config_of(bench, "sa_vits_tiny", root), 64, 160, root) > 0
