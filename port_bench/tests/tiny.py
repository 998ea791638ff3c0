"""A tiny cell for the CPU tests: a copy of the benchmark in a temporary
root with one more configuration (ViT-S, 4 iterations, DAv2 at 140), traffic
mix (64x160, a pool of 2 pairs) and cell, added as new files and entries only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny_cpu"


def copy_benchmark(tmp: Path) -> Path:
    """BENCHMARK.json and port_bench/ (without caches) under tmp."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "port_bench", root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    return root


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
