"""Disparity visualisation, a copy of the JAX package's
`utils/visualization.py` `colorize_disparity` (numpy only)."""
from __future__ import annotations

import numpy as np


def colorize_disparity(disp: np.ndarray, vmax: float | None = None) -> np.ndarray:
    """Turbo-like colormap for disparity maps, (H,W) -> (H,W,3) uint8."""
    vmax = float(disp.max()) if vmax is None else vmax
    x = np.clip(disp / max(vmax, 1e-6), 0, 1)
    # simple spectral ramp: blue -> cyan -> green -> yellow -> red
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
