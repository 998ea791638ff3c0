"""Disparity colormaps and error maps, numpy only: a copy of the JAX
package's `utils/visualization.py` (the reference's `utils.py:273-348`
colorizers without matplotlib)."""
from __future__ import annotations

import numpy as np

# KITTI disparity-error colormap (reference utils.py:273-305 LC table)
_KITTI_LC = np.array(
    [
        [0.0, 0.1875, 49, 54, 149],
        [0.1875, 0.375, 69, 117, 180],
        [0.375, 0.75, 116, 173, 209],
        [0.75, 1.5, 171, 217, 233],
        [1.5, 3.0, 224, 243, 248],
        [3.0, 6.0, 254, 224, 144],
        [6.0, 12.0, 253, 174, 97],
        [12.0, 24.0, 244, 109, 67],
        [24.0, 48.0, 215, 48, 39],
        [48.0, float("inf"), 165, 0, 38],
    ],
    dtype=np.float64,
)


def kitti_error_colormap(disp: np.ndarray, gt: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(H,W) arrays -> (H,W,3) uint8 error visualization."""
    err = np.abs(disp - gt)
    rel = err / np.maximum(np.abs(gt), 1e-6)
    # KITTI convention: scale by min(err/3, 20*rel)
    val = np.minimum(err / 3.0, 20.0 * rel) * 3.0
    out = np.zeros((*disp.shape, 3), np.uint8)
    for lo, hi, r, g, b in _KITTI_LC:
        sel = (val >= lo) & (val < hi)
        out[sel] = (r, g, b)
    out[valid == 0] = 0
    return out


def colorize_disparity(disp: np.ndarray, vmax: float | None = None) -> np.ndarray:
    """Turbo-like colormap for disparity maps, (H,W) -> (H,W,3) uint8."""
    vmax = float(disp.max()) if vmax is None else vmax
    x = np.clip(disp / max(vmax, 1e-6), 0, 1)
    # simple spectral ramp: blue -> cyan -> green -> yellow -> red
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def bad_tau_map(disp: np.ndarray, gt: np.ndarray, valid: np.ndarray, tau: float = 2.0) -> np.ndarray:
    """Binary bad-pixel map (reference guided_visualize, utils.py:308-348)."""
    err = np.abs(disp - gt)
    out = np.zeros((*disp.shape, 3), np.uint8)
    out[(err > tau) & (valid > 0)] = (255, 0, 0)
    out[(err <= tau) & (valid > 0)] = (0, 255, 0)
    return out
