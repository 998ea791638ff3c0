"""Training observability and image dumps, a copy of the JAX package's
`utils/logging.py` (the reference's tensorboardX scalars and images, args.json
and source backup, reference train.py:524-529, 566-579; utils.py:215-223):

- MetricLogger: JSONL scalars, one line a logged step;
- dump_images: PNGs of predictions for visual QA (the eval's `--save-images`);
- save_run_provenance: the configs as JSON and a snapshot of the package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Mapping

import numpy as np
from PIL import Image

from stereoanywhere_tpu_torch.utils.visualization import colorize_disparity


def dump_images(outdir: str, step: int, images: Mapping[str, np.ndarray]):
    """Save HxW or HxWx3 arrays as PNGs (disparity maps get colorized)."""
    os.makedirs(outdir, exist_ok=True)
    for name, arr in images.items():
        arr = np.asarray(arr)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.ndim == 2:
            rgb = colorize_disparity(arr)
        elif arr.dtype == np.uint8:
            rgb = arr
        else:
            rgb = np.clip(arr * 255, 0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(outdir, f"{step:08d}_{name}.png"))


class MetricLogger:
    """Scalars appended to `<logdir>/metrics.jsonl`, one JSON line a call."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def log(self, step: int, scalars: Mapping[str, Any]):
        row = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")

    def close(self):
        self._f.close()


def save_run_provenance(run_dir: str, configs: Mapping[str, Any]):
    """`config.json` (each config as a dict) and `code_snapshot/`, a copy of
    the package's source (reference train.py:526-529, utils.py:215-223)."""
    os.makedirs(run_dir, exist_ok=True)
    blob = {name: dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else cfg for name, cfg in configs.items()}
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(blob, f, indent=2, default=str)
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(run_dir, "code_snapshot")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
