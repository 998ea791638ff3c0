"""Nothing that a run or the reference loads is JAX or the JAX package
(top-level module names compared whole: `stereoanywhere_tpu_torch` begins
with `stereoanywhere_tpu` and is allowed), the reference loads nothing of
the port, and a run without a card, or in a directory holding only the
benchmark, exits non-zero with no result."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "stereoanywhere_tpu"}
BENCH = tiny.REPO / "port_bench"


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def loaded_after(code: str) -> set[str]:
    """Top-level names in sys.modules after `code` runs in a fresh
    interpreter from the repository's root."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=tiny.REPO, capture_output=True, text=True, check=True, env={**os.environ, "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "stereoanywhere_tpu_torch" not in top_level_imports(path), path


def test_harness_loads_no_jax():
    code = ("import port_bench.harness as h, port_bench.run, port_bench.calibrate\n"
            "b = h.load_benchmark()\n"
            "[h.load_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "import stereoanywhere_tpu_torch.serve.pipeline\n")
    loaded = loaded_after(code)
    assert "stereoanywhere_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    loaded = loaded_after("import port_bench.reference.pipeline, port_bench.reference.arith")
    assert not loaded & (FORBIDDEN | {"stereoanywhere_tpu_torch"})


def run_cli(cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload", "vitl_oakd400p", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("on the card this is a benchmark run: test_port_bench_card.py covers it")
    out = run_cli(tiny.REPO)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
