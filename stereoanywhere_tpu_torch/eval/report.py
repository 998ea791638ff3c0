"""Result reporting, a copy of the JAX package's `eval/report.py`: the
repeatability loop (mean and std over tries), LaTeX-style rows and the CSV
appender of the reference's `test.py:287-403`.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Sequence

import numpy as np


def run_tries(run_once: Callable[[], dict], tries: int = 1) -> tuple[dict, dict]:
    """Run an evaluation `tries` times; returns (mean, std) per metric
    (reference --tries loop, test.py:287-392)."""
    results = [run_once() for _ in range(tries)]
    keys = results[0].keys()
    mean = {k: float(np.mean([r[k] for r in results])) for k in keys}
    std = {k: float(np.std([r[k] for r in results])) for k in keys}
    return mean, std


def latex_row(metrics: dict, keys: Sequence[str], scale_pct: Sequence[bool] | None = None,
              precision: int = 2) -> str:
    """`&`-joined LaTeX-ready metric row (reference test.py:367-392)."""
    if scale_pct is None:
        scale_pct = ["bad" in k for k in keys]
    cells = []
    for k, pct in zip(keys, scale_pct):
        v = metrics.get(k, float("nan"))
        if pct:
            v = v * 100
        cells.append(f"{v:.{precision}f}")
    return " & ".join(cells) + r" \\"


def append_csv(path: str, row: dict) -> None:
    """CSV appender with run-config columns (reference test.py:251-274)."""
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            w.writeheader()
        w.writerow(row)


BENCHMARK_HEADLINE_KEYS = {
    # the per-benchmark headline metrics from the paper tables
    "middlebury": ("bad 2.0", "noc bad 2.0", "occ bad 2.0", "avgerr"),
    "middlebury2021": ("bad 2.0", "avgerr"),
    "eth3d": ("bad 1.0", "avgerr"),
    "kitti2012": ("bad 3.0", "avgerr"),
    "kitti2015": ("bad 3.0", "avgerr"),
    "booster": ("bad 2.0", "bad 4.0", "bad 6.0", "bad 8.0", "avgerr"),
    "layeredflow": ("bad 1.0", "bad 3.0", "bad 5.0", "avgerr"),
}
