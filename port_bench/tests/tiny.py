"""A tiny cell for the CPU tests: a copy of the benchmark in a temporary
root with one more configuration (ViT-S, 4 iterations, DAv2 at 140), traffic
mix (64x160, a pool of 2 pairs) and cell, added as new files and entries only;
and a model variant on it, added the same way: a configuration that names a
reference module of its own, that module, a cell and a per-layer metric that
reads the port's spans."""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny_cpu"
VARIANT_CELL = "tiny_cpu_variant"
VARIANT_METRIC = "tiny_span_kernels"
# the variant's reference: the shipped model's, declaring one more stereo
# key, which the shipped model computes with its default (truncation on)
VARIANT_REFERENCE = '''"""A variant's plain reference for the CPU tests."""
from port_bench.reference import shipped

STEREO_KEYS = shipped.STEREO_KEYS | {"use_truncate_vol"}
BUILT = []  # the configurations this module built, in order


def build(cfg):
    if not cfg["stereo"]["use_truncate_vol"]:
        raise ValueError("this reference truncates the mirror volume")
    BUILT.append(cfg["name"])
    return shipped.build(cfg)
'''
VARIANT_READER = '''"""Kernels a pair that the eager pass filed under the port's spans."""


def read(ctx):
    seg = ctx.eager
    return None if seg is None else sum(len(k) for k in seg.spans.values()) / seg.pairs
'''


def copy_benchmark(tmp: Path) -> Path:
    """BENCHMARK.json and port_bench/ (without caches) under tmp."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "port_bench", root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    return root


def digests(root: Path) -> dict[Path, str]:
    """Each file under root (relative) -> its SHA-1."""
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def add_tiny_cell(root: Path, limit: float) -> None:
    """The tiny configuration, mix, limits and cell, as new files and
    entries."""
    cfg = json.loads((root / "port_bench/configs/sa_vitl.json").read_text())
    cfg.update(name="sa_vits_tiny", iters=4)
    cfg["mono"] = {"encoder": "vits", "embed_dim": 384, "depth": 12, "num_heads": 6, "ffn": "mlp",
                   "mlp_hidden": 1536, "features": 64, "out_channels": [48, 96, 192, 384], "input_size": 140}
    (root / "port_bench/configs/sa_vits_tiny.json").write_text(json.dumps(cfg, indent=1))
    mix = json.loads((root / "port_bench/traffic/kitti_closed1.json").read_text())
    mix.update(name="tiny_closed1", height=64, width=160, pool_pairs=2, check_pairs=2, min_shift=2, max_shift=8,
               why="a CPU test's size")
    (root / "port_bench/traffic/tiny_closed1.json").write_text(json.dumps(mix, indent=1))
    (root / f"port_bench/checks/{CELL}.json").write_text(json.dumps(
        {"workload": CELL, "numbers": {"epe_bf16_units": {"limit": limit}}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sa_vits_tiny", "source": "https://github.com/bartn8/stereoanywhere",
                             "file": "port_bench/configs/sa_vits_tiny.json", "reduced": ["mono", "iters"],
                             "why": "a CPU test's size"})
    bench["workloads"].append({"name": CELL, "config": "sa_vits_tiny", "traffic": "tiny_closed1", "chips": 1,
                               "why": "a CPU test's size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def add_variant(root: Path, limit: float) -> None:
    """After `add_tiny_cell`: the tiny configuration with its own reference
    module (`reference/tiny_variant.py`) and one more stereo key, its cell
    on the tiny mix, and a per-layer metric on `ctx.eager.spans`, as new
    files and entries."""
    cfg = json.loads((root / "port_bench/configs/sa_vits_tiny.json").read_text())
    cfg.update(name="sa_vits_tiny_variant", reference="tiny_variant")
    cfg["stereo"]["use_truncate_vol"] = True
    (root / "port_bench/configs/sa_vits_tiny_variant.json").write_text(json.dumps(cfg, indent=1))
    (root / "port_bench/reference/tiny_variant.py").write_text(VARIANT_REFERENCE)
    (root / f"port_bench/metrics/{VARIANT_METRIC}.py").write_text(VARIANT_READER)
    (root / f"port_bench/checks/{VARIANT_CELL}.json").write_text(json.dumps(
        {"workload": VARIANT_CELL, "numbers": {"epe_bf16_units": {"limit": limit}}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sa_vits_tiny_variant", "source": "https://github.com/bartn8/stereoanywhere",
                             "file": "port_bench/configs/sa_vits_tiny_variant.json", "reduced": ["mono", "iters"],
                             "why": "a CPU test's variant"})
    bench["workloads"].append({"name": VARIANT_CELL, "config": "sa_vits_tiny_variant", "traffic": "tiny_closed1",
                               "chips": 1, "why": "a CPU test's variant"})
    bench["per_layer"].append({"name": VARIANT_METRIC, "unit": "kernels", "better": "lower",
                               "source": "program_span", "layer": "stereo stage", "moves": "pair_ms_p50",
                               "workloads": [VARIANT_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
