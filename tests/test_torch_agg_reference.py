"""The port's stereo-volume aggregation and stacked hourglasses against their
own plain reference, `port_bench/reference/sa_vitl_agg.py`, on the CPU: the
shipped model's benchmark configuration with the branch, the stacks or both
switched on, at the settings of `port_bench/tests/test_port_bench_reference.py`
(DAv2 ViT-S, f32, 96x320, 3 iterations) and the benchmark's seeded weights.
Both hold the same parameters, one draw fills both alike, the disparities
agree, and a reference with the branch's volume or its stacked hourglasses
taken out is told apart, so the comparison can fail.  The benchmark's
`validate` accepts the variant's configuration `sa_vitl_agg` and its cell,
and still refuses the branch's keys on the shipped model's; the branch's
readers count its work on the reference and read 0 without the branch."""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch
import torch.nn as nn

from port_bench import flops, harness, reference, traffic
from port_bench import trace as bench_trace
from port_bench.tests import tiny
from port_bench.weights import spec

torch.set_num_threads(4)

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")
MIX = {"name": "cpu", "height": 96, "width": 320, "pool_pairs": 1, "loop": "closed", "clients": 1, "batch": 1,
       "min_shift": 8, "max_shift": 32, "check_pairs": 1, "trace_pairs": 1, "eager_trace_pairs": 1, "why": "test"}
# f32 round-off through the hourglasses and three refinement steps: the two
# agree to about 1e-4 px (5.5e-5 to 8.8e-5 over the cases on this seed); the
# branch's volume left out moves the map by 10 px, the stacked hourglasses
# left out by 2.4 px
TOL_PX = 2e-3
# (use_aggregate_stereo_vol, n_additional_hourglass); of a stack's n + 1
# entries the first n run, the first an identity, so n = 2 is the least count
# at which a stacked hourglass runs and n = 3 runs two in a row
CASES = {"branch_and_stack2": (True, 2), "branch_alone": (True, 0), "mono_stack2_alone": (False, 2),
         "branch_and_stack3": (True, 3)}
MAIN = "branch_and_stack2"


def config(aggregate: bool = True, n: int = 2) -> dict:
    """`sa_vitl_agg` with the variant's keys as given, at a CPU test's size:
    ViT-S, f32, 3 iterations."""
    cfg = harness.config_of(harness.load_benchmark(), "sa_vitl_agg")
    cfg.update(name="sa_vits_agg_f32", iters=3, graphs=False)
    cfg["stereo"].update(compute_dtype="float32", use_aggregate_stereo_vol=aggregate, n_additional_hourglass=n)
    cfg["weights"]["dtype"] = "float32"
    if not aggregate:  # the configuration's scales may name the branch's classifier
        cfg["weights"]["stereo_scales"].pop("classifier_stereo.weight", None)
    cfg["mono"] = {"encoder": "vits", "embed_dim": 384, "depth": 12, "num_heads": 6, "ffn": "mlp",
                   "mlp_hidden": 1536, "features": 64, "out_channels": [48, 96, 192, 384], "input_size": 140}
    return cfg


@functools.cache
def built(case: str):
    """The program, the reference, the pair and the reference's disparity."""
    cfg = config(*CASES[case])
    program = harness.build_program(cfg, CPU, SEED)
    ref = harness.build_reference(cfg, CPU, SEED)
    left, right = traffic.make_pool(MIX, SEED, CPU)[0]
    with torch.no_grad():
        want = ref(*(torch.from_numpy(v) for v in (left, right))).numpy()
    return program, ref, (left, right), want


@pytest.mark.parametrize("case", CASES)
def test_same_parameters_filled_alike(case):
    program, ref, _, _ = built(case)
    aggregate, n = CASES[case]
    port_model, ref_model = program.stereo, ref.stereo
    assert [s[:2] for s in spec(port_model, 1.0, {})] == [s[:2] for s in spec(ref_model, 1.0, {})]
    names = {name for name, _ in ref_model.named_parameters()}
    assert ("classifier_stereo.weight" in names) == aggregate
    assert any(name.startswith("hourglass_stereo.") for name in names) == aggregate
    for which, built_here in (("mono", True), ("stereo", aggregate)):
        # entry 0 is the identity, the never-run entry n is not built
        for i in range(n + 1):
            runs = built_here and 0 < i < n
            assert any(name.startswith(f"hourglass_{which}_stack.{i}.") for name in names) == runs, (which, i)
    port_params = dict(port_model.named_parameters())
    for name, p in ref_model.named_parameters():
        assert torch.equal(port_params[name], p), name


@pytest.mark.parametrize("case", CASES)
def test_disparity_agrees(case):
    program, _, (left, right), want = built(case)
    got = program(left, right).numpy()
    assert got.shape == want.shape == (1, 96, 320, 1)
    assert np.abs(got - want).max() < TOL_PX


def _raw_stereo_volume(monkeypatch, stereo):
    monkeypatch.setattr(stereo, "aggregate_stereo", False)


def _no_stacked_hourglass(monkeypatch, stereo):
    for which in ("mono", "stereo"):
        monkeypatch.setattr(stereo, f"hourglass_{which}_stack", nn.ModuleList([nn.Identity()]))


@pytest.mark.parametrize("mutate", [_raw_stereo_volume, _no_stacked_hourglass],
                         ids=["raw_stereo_volume_in_the_loop", "no_stacked_hourglass"])
def test_a_mutated_reference_is_told_apart(monkeypatch, mutate):
    _, ref, (left, right), want = built(MAIN)
    mutate(monkeypatch, ref.stereo)
    with torch.no_grad():
        mutated = ref(*(torch.from_numpy(v) for v in (left, right))).numpy()
    assert np.abs(mutated - want).max() > 10 * TOL_PX


def test_the_branch_with_vol_downsample_is_refused_by_both():
    cfg = config()
    cfg["stereo"]["vol_downsample"] = 1
    with pytest.raises(ValueError, match="vol_downsample"):
        reference.build(cfg)
    with pytest.raises(ValueError, match="vol_downsample"):
        harness.build_program(cfg, CPU, SEED)


def test_the_benchmark_validates_the_variant_and_its_cell():
    bench = harness.load_benchmark()
    assert harness.validate(bench)[-1] == "vitl_agg_kitti"
    cell = next(w for w in bench["workloads"] if w["name"] == "vitl_agg_kitti")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("sa_vitl_agg", "kitti_closed1", 1)
    cfg = harness.config_of(bench, "sa_vitl_agg")
    assert reference.name_of(cfg) == "sa_vitl_agg"
    assert cfg["stereo"]["use_aggregate_stereo_vol"] and cfg["stereo"]["n_additional_hourglass"] == 2
    # every width and setting of the shipped model's configuration, but the branch's keys and its weight law
    shipped = harness.config_of(bench, "sa_vitl")
    assert {k: v for k, v in cfg["stereo"].items() if k in shipped["stereo"]} == shipped["stereo"]
    assert (cfg["mono"], cfg["iters"], cfg["graphs"]) == (shipped["mono"], shipped["iters"], shipped["graphs"])
    # the limit lies between the program's worst reading and the fp8 control's least
    limit = json.loads((tiny.REPO / "port_bench/checks/vitl_agg_kitti.json").read_text())["numbers"]["epe_bf16_units"]
    assert limit["lower"] < limit["limit"] < limit["upper"]


def _eager(spans: dict) -> bench_trace.Segment:
    kernels = [k for ks in spans.values() for k in ks]
    return bench_trace.Segment(kernels=kernels, spans=spans, pairs=2)


def _context(config: str, eager) -> harness.RunContext:
    bench = harness.load_benchmark()
    ctx = harness.RunContext(harness.config_of(bench, config), harness.traffic_of("kitti_closed1"))
    ctx.eager = eager
    return ctx


def test_the_branch_work_counts_its_3d_convolutions():
    """At the KITTI pair's padded 384x1280: the stereo hourglass and its one
    stacked hourglass (each three stride-2 and seven stride-1 3x3x3 convs
    and two 1x1x1 ones, 8..48 channels, from an 8x320x96x320 volume) and the
    8 -> 1 classifier: 25 convolutions."""
    cfg = harness.config_of(harness.load_benchmark(), "sa_vitl_agg")
    work, moved = harness.load_reader("aggregate_roofline").__globals__["branch_work"](cfg, 375, 1242)
    assert work == 303818342400.0 and moved == 4042218672.0
    assert flops.least_ms(work, moved) == pytest.approx(1.20663, abs=1e-5)  # bound by bytes


@pytest.mark.parametrize("config,spans,want_ms", [
    ("sa_vitl", {"sa.stereo.hourglass": [("k", 0.0, 5000.0)]}, 0.0),  # no branch
    ("sa_vitl_agg", {"sa.stereo.hourglass": [("k", 0.0, 5000.0)]}, 0.0),  # nothing launched under the span
    ("sa_vitl_agg", {"sa.stereo.aggregate": [("a", 0.0, 30000.0), ("b", 20000.0, 87000.0)],
                     "sa.stereo.hourglass": [("k", 90000.0, 95000.0)]}, 43.5),
], ids=["no_branch", "no_launch", "two_pairs"])
def test_the_branch_readers(config, spans, want_ms):
    ctx = _context(config, _eager(spans))
    assert harness.load_reader("aggregate_device_ms")(ctx) == want_ms
    share = harness.load_reader("aggregate_roofline")(ctx)
    assert share == (pytest.approx(100 * 1.2066324394029853 / want_ms) if want_ms else 0.0)


@pytest.mark.parametrize("key,value", [("use_aggregate_stereo_vol", True), ("n_additional_hourglass", 2)])
def test_the_shipped_reference_still_refuses_the_keys(tmp_path, key, value):
    root = tiny.copy_benchmark(tmp_path)
    path = root / "port_bench/configs/sa_vitl.json"
    cfg = json.loads(path.read_text())
    cfg["stereo"][key] = value
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=f"config sa_vitl: stereo key '{key}' is not modelled by its reference "
                                         "'shipped'"):
        harness.validate(harness.load_benchmark(root), root)
