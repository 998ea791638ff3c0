"""Qualitative image dumps, a copy of the JAX package's
`utils/logging.py` `dump_images` (the eval's `--save-images`)."""
from __future__ import annotations

import os
from typing import Mapping

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
