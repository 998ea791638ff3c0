"""The comparison that decides `correct`.

Each answer compared is a served disparity map (1, H, W, 1) on the host,
held against the plain reference's map for the same pair and the same
weights (f32, TF32 off).  Its gap is the mean over the pixels of
|served - reference|, in px.  How large a gap rounding alone makes
depends on the seed's random weights (the card's readings ranged over
4x from seed to seed, for the program and the control alike), so the
number compared is the gap in units of the yardstick's: the reference run
again with every product's operands rounded to bfloat16, the
configurations' serving dtype.  `epe_bf16_units` is that ratio, worst
over every answer of the pairs drawn for the check.  Its limit is the
cell's, from `checks/<workload>.json`, set from the program's readings
over a dozen seeds and more and the control's (the reference with float8
e4m3 operands): see `PERF.md`.  A run is correct when no request failed,
every pair drawn for the check was answered, and every number is within
its limit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# the least yardstick gap a ratio is taken over (px): a seed whose map
# rounding does not move at all would otherwise divide by ~0
FLOOR_PX = 0.01


def load_limits(workload: str, root: Path = REPO) -> dict[str, float]:
    """{number: limit} of a cell, from the checkout at `root`."""
    data = json.loads((root / "port_bench" / "checks" / f"{workload}.json").read_text())
    return {name: float(entry["limit"]) for name, entry in data["numbers"].items()}


def epe_px(served: np.ndarray, reference: np.ndarray) -> float:
    """Mean |served - reference| over the pixels, in px (a wrong shape or a
    NaN anywhere: infinite)."""
    if served.shape != reference.shape:
        return float("inf")
    gap = np.abs(served.astype(np.float64) - reference.astype(np.float64))
    return float(gap.mean()) if np.isfinite(gap).all() else float("inf")


def compare(answers: dict[int, list[np.ndarray]], references: dict[int, np.ndarray],
            yardsticks: dict[int, np.ndarray]) -> dict[str, float]:
    """The numbers of a run: `epe_bf16_units`, worst over every answer of
    every pair drawn for the check (infinite if one of them was never
    answered)."""
    worst = 0.0
    for pair, ref in references.items():
        got = answers.get(pair) or []
        if not got:
            return {"epe_bf16_units": float("inf")}
        unit = max(epe_px(yardsticks[pair], ref), FLOOR_PX)
        worst = max(worst, *(epe_px(a, ref) / unit for a in got))
    return {"epe_bf16_units": worst}


def verdict(numbers: dict[str, float], limits: dict[str, float], failed: int) -> bool:
    return failed == 0 and set(numbers) == set(limits) and all(numbers[k] <= limits[k] for k in limits)
