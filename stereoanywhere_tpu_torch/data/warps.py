"""Host-side reprojection utilities: the port's copy of the JAX package's
`data/warps.py`, vectorised numpy forms of the reference's numba kernels
(reference utils.py:89-117 z-buffer splats, :227-270 KITTI-style background
infill, :119-182 point-cloud reprojection).

Data-preparation tools, not on the model's path.  The warps and the infill
take the native library (`stereoanywhere_tpu_torch.native`, the counterpart
of the reference's numba JIT) where it is built, and the numpy forms
otherwise.
"""
from __future__ import annotations

import numpy as np

from stereoanywhere_tpu_torch import native


def fast_warp_depth(depth: np.ndarray, disparity: np.ndarray) -> np.ndarray:
    """Forward-splat a left depth map into the right view with a z-buffer
    (reference _fast_warp_depth, utils.py:89-108): each pixel lands at
    x - disp; nearest (smallest depth) wins."""
    if native.available():
        return native.warp_depth(depth, disparity)
    h, w = depth.shape
    ys, xs = np.nonzero(depth > 0)
    tx = np.round(xs - disparity[ys, xs]).astype(np.int64)
    keep = (tx >= 0) & (tx < w)
    ys, tx, z = ys[keep], tx[keep], depth[ys, xs][keep]
    out = np.full((h, w), np.inf, np.float32)
    np.minimum.at(out, (ys, tx), z)
    out[~np.isfinite(out)] = 0
    return out


def fast_warp_disparity(disparity: np.ndarray) -> np.ndarray:
    """Forward-splat a left disparity into the right view; larger disparity
    (nearer) wins (reference _fast_warp_disparity, utils.py:110-117)."""
    if native.available():
        return native.warp_disparity(disparity)
    h, w = disparity.shape
    ys, xs = np.nonzero(disparity > 0)
    d = disparity[ys, xs]
    tx = np.round(xs - d).astype(np.int64)
    keep = (tx >= 0) & (tx < w)
    ys, tx, d = ys[keep], tx[keep], d[keep]
    out = np.zeros((h, w), np.float32)
    np.maximum.at(out, (ys, tx), d)
    return out


def interpolate_background(disparity: np.ndarray) -> np.ndarray:
    """KITTI-style background infill of disparity holes (reference
    _interpolate_background, utils.py:227-270): each hole row-span takes the
    min (farther) of its left/right valid neighbors; remaining holes take the
    nearest valid value in the row, then column."""
    if native.available():
        return native.interpolate_background(disparity)
    d = disparity.astype(np.float32).copy()
    h, w = d.shape
    for y in range(h):
        row = d[y]
        valid = row > 0
        if not valid.any():
            continue
        idx = np.arange(w)
        # previous valid index per position
        prev = np.where(valid, idx, -1)
        prev = np.maximum.accumulate(prev)
        # next valid index per position
        nxt = np.where(valid, idx, w)
        nxt = np.minimum.accumulate(nxt[::-1])[::-1]
        holes = ~valid
        both = holes & (prev >= 0) & (nxt < w)
        d[y, both] = np.minimum(row[prev[both]], row[nxt[both]])
        left_only = holes & (prev >= 0) & (nxt >= w)
        d[y, left_only] = row[prev[left_only]]
        right_only = holes & (prev < 0) & (nxt < w)
        d[y, right_only] = row[nxt[right_only]]
    return d


def disparity_to_pointcloud(
    disparity: np.ndarray,
    focal: float,
    baseline: float,
    cx: float | None = None,
    cy: float | None = None,
) -> np.ndarray:
    """(H,W) disparity -> (N,3) metric points (reference pcd utilities,
    utils.py:119-182)."""
    h, w = disparity.shape
    cx = w / 2 if cx is None else cx
    cy = h / 2 if cy is None else cy
    ys, xs = np.nonzero(disparity > 0)
    z = focal * baseline / disparity[ys, xs]
    x = (xs - cx) * z / focal
    y = (ys - cy) * z / focal
    return np.stack([x, y, z], axis=1).astype(np.float32)


def resize_disparity_3d(
    disparity: np.ndarray, out_hw: tuple[int, int], focal_scale: float | None = None
) -> np.ndarray:
    """Geometry-aware disparity resize: nearest resample + value scaling by
    the width ratio (reference resize_3d reprojection, utils.py:119-182)."""
    h, w = disparity.shape
    oh, ow = out_hw
    iy = np.clip((np.arange(oh) * h / oh).astype(np.int64), 0, h - 1)
    ix = np.clip((np.arange(ow) * w / ow).astype(np.int64), 0, w - 1)
    scale = (ow / w) if focal_scale is None else focal_scale
    return disparity[iy][:, ix] * scale
