"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric are added as new files and entries only, in a
copy, and the harness lists and validates them without a change to any
file that was there; malformed names and units are refused, and so is a
configuration's stereo key that its reference does not model."""
from __future__ import annotations

import json

import pytest

from port_bench import harness
from port_bench.tests import tiny


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
    before = tiny.digests(root)
    tiny.add_tiny_cell(root, 0.4)
    add_metric(root)
    after = tiny.digests(root)
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


def write_config(root, name, cfg):
    (root / "port_bench/configs" / f"{name}.json").write_text(json.dumps(cfg))


@pytest.mark.parametrize("key,value", [("use_aggregate_stereo_vol", True), ("n_additional_hourglass", 1),
                                       ("vol_downsample", 1), ("use_truncate_vol", True)])
def test_unmodelled_stereo_key_refused(root, key, value):
    cfg = json.loads((root / "port_bench/configs/sa_vitl.json").read_text())
    cfg["stereo"][key] = value
    write_config(root, "sa_vitl", cfg)
    with pytest.raises(ValueError, match=f"config sa_vitl: stereo key '{key}' is not modelled by its reference "
                                         "'shipped'"):
        harness.validate(harness.load_benchmark(root), root)


def test_switches_and_the_named_default_validate(root):
    cfg = json.loads((root / "port_bench/configs/sa_vitl.json").read_text())
    cfg["stereo"]["lookup_impl"] = "auto"
    cfg["reference"] = "shipped"
    write_config(root, "sa_vitl", cfg)
    assert harness.validate(harness.load_benchmark(root), root) == ["vitl_kitti", "vitg_kitti", "vitl_oakd400p"]


def test_missing_reference_refused(root):
    cfg = json.loads((root / "port_bench/configs/sa_vitg.json").read_text())
    cfg["reference"] = "nowhere"
    write_config(root, "sa_vitg", cfg)
    with pytest.raises(ValueError, match="config sa_vitg: no reference module port_bench/reference/nowhere.py"):
        harness.validate(harness.load_benchmark(root), root)
