"""HTTP client of `serve_http` (`serve/pipeline.py`): the port's copy of
the JAX package's `serve/client.py`, the counterpart of the reference's
remote camera client (reference demo/fast_demo_oak_client.py).  It streams
image pairs from files, or from any iterable of frames, to the server and
returns disparity maps.  Standard library and numpy only.
"""
from __future__ import annotations

import json
import urllib.request
from typing import Iterable, Iterator

import numpy as np


def infer_remote(server: str, im2: np.ndarray, im3: np.ndarray, timeout: float = 120.0) -> np.ndarray:
    """im2/im3 (H,W,3) float in [0,1] -> (H,W) disparity (the server answers
    uint16 x256, the protocol of reference fast_demo_server.py:110-176)."""
    h, w, _ = im2.shape
    meta = json.dumps({"h": h, "w": w}).encode()
    payload = meta + np.stack([im2, im3]).astype(np.float32).tobytes()
    req = urllib.request.Request(
        f"{server.rstrip('/')}/infer", data=payload, method="POST",
        headers={"Content-Type": "application/octet-stream", "X-Meta-Length": str(len(meta))},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
    return np.frombuffer(raw, np.uint16).reshape(h, w).astype(np.float32) / 256.0


def stream_pairs(server: str, frames: Iterable[tuple[np.ndarray, np.ndarray]],
                 ema_alpha: float = 0.15) -> Iterator[np.ndarray]:
    """Stream stereo frames, applying the reference demo's EMA temporal
    filter (reference fast_demo_oak.py:40-49, alpha=0.15)."""
    smoothed = None
    for im2, im3 in frames:
        disp = infer_remote(server, im2, im3)
        smoothed = disp if smoothed is None else ema_alpha * disp + (1 - ema_alpha) * smoothed
        yield smoothed


def file_pair_source(left_paths, right_paths):
    """(left, right) float RGB frames in [0,1] from two lists of image files."""
    from PIL import Image

    for lp, rp in zip(left_paths, right_paths):
        left = np.asarray(Image.open(lp).convert("RGB"), np.float32) / 255.0
        right = np.asarray(Image.open(rp).convert("RGB"), np.float32) / 255.0
        yield left, right
