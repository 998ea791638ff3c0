"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric are added as new files and entries only, in a
copy, and the harness lists and validates them without a change to any
file that was there; malformed names and units are refused."""
from __future__ import annotations

import hashlib
import json

import pytest

from port_bench import harness
from port_bench.tests import tiny


def digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def root(tmp_path):
    return tiny.copy_benchmark(tmp_path)


def add_metric(root, name="tiny_dummy_ms", unit="ms"):
    (root / "port_bench/metrics" / f"{name}.py").write_text("def read(ctx):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": name, "unit": unit, "better": "lower", "source": "program_span",
                               "layer": "serve pipeline", "moves": "pair_ms_p50", "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_and_entries_only(root):
    before = digests(root)
    tiny.add_tiny_cell(root, 0.4)
    add_metric(root)
    after = digests(root)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {root.joinpath("BENCHMARK.json").relative_to(root)}
    bench = harness.load_benchmark(root)
    assert harness.validate(bench, root)[-1] == tiny.CELL
    assert [m["name"] for m in harness.metrics_of(bench, tiny.CELL, True)][-1] == "tiny_dummy_ms"
    assert harness.load_reader("tiny_dummy_ms", root)(None) == 1.0
    assert harness.config_of(bench, "sa_vits_tiny", root)["mono"]["encoder"] == "vits"
    # the BENCHMARK.json entries that were there are unchanged
    old = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(old[key])] == old[key]


def test_repository_benchmark_validates():
    assert harness.validate(harness.load_benchmark()) == ["vitl_kitti", "vitg_kitti", "vitl_oakd400p"]


@pytest.mark.parametrize("name,unit,fault", [
    ("bad name", "ms", "a name is"), ("bad/name", "ms", "a name is"), ("-lead", "ms", "a name is"),
    ("x" * 65, "ms", "a name is"), ("ok_name", "tokens per s", "unit"), ("ok_name", "x" * 17, "unit"),
    ("ok_name", "\u00b5s", "unit")])
def test_malformed_names_and_units_refused(root, name, unit, fault):
    if harness.NAME.match(name):
        (root / "port_bench/metrics" / f"{name}.py").write_text("def read(ctx):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": name, "unit": unit, "better": "lower", "source": "program_span",
                               "layer": "serve pipeline", "moves": "pair_ms_p50"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match=fault):
        harness.validate(harness.load_benchmark(root), root)


def test_unknown_traffic_and_missing_reader_refused(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "vitl_nowhere", "config": "sa_vitl", "traffic": "nowhere", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "no_reader_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "serve pipeline", "moves": "pair_ms_p50"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="nowhere.*no_reader_ms|no_reader_ms.*nowhere"):
        harness.validate(harness.load_benchmark(root), root)
