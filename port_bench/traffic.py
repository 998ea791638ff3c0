"""The one traffic generator: a mix file's parameters -> the pool of stereo
pairs that the closed loop cycles through.

A mix (`traffic/<name>.json`) gives the image size, how many distinct
pairs the pool holds, the loop (closed, with its number of clients and
the batch a request carries) and, for the output check and the traced
run, how many pairs those take.  Every pair is drawn on the device from
the seed: a texture of coarse and fine noise over a strip wider than the
image, the left view cut from it at 0 and the right view at a shift drawn
between `min_shift` and `max_shift` pixels, so that the scene has one
disparity; the views go to the host as float32 (1, H, W, 3) in [0, 1], as
a user of the pipeline hands them over.  Every seed draws the same
sizes: only the pixels change.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KEYS = {"name", "height", "width", "pool_pairs", "loop", "clients", "batch", "min_shift", "max_shift",
        "check_pairs", "trace_pairs", "eager_trace_pairs", "why"}


def validate(mix: dict) -> None:
    """Raise on a mix this generator cannot run."""
    if set(mix) != KEYS:
        raise ValueError(f"traffic {mix.get('name')!r}: keys {sorted(set(mix) ^ KEYS)} missing or unknown")
    if mix["loop"] != "closed" or mix["clients"] != 1 or mix["batch"] != 1:
        raise ValueError(f"traffic {mix['name']!r}: only a closed loop of one client at batch 1 is generated")
    if not 0 < mix["check_pairs"] <= mix["pool_pairs"]:
        raise ValueError(f"traffic {mix['name']!r}: check_pairs must be in [1, pool_pairs]")
    if not 0 <= mix["min_shift"] <= mix["max_shift"]:
        raise ValueError(f"traffic {mix['name']!r}: need 0 <= min_shift <= max_shift")
    if min(mix["height"], mix["width"], mix["pool_pairs"], mix["trace_pairs"], mix["eager_trace_pairs"]) < 1:
        raise ValueError(f"traffic {mix['name']!r}: sizes and counts must be positive")


def stream(seed: int, k: int) -> int:
    """The k-th independent seed derived from a run's seed."""
    return (seed * 1_000_003 + k) % (1 << 63)


def make_pool(mix: dict, seed: int, device: torch.device) -> list[tuple[np.ndarray, np.ndarray]]:
    """mix["pool_pairs"] pairs of host float32 (1, H, W, 3) views."""
    h, w = mix["height"], mix["width"]
    n = mix["pool_pairs"]
    span = w + mix["max_shift"]
    gen = torch.Generator(device=device).manual_seed(stream(seed, 0))
    coarse = torch.rand((n, 3, max(h // 16, 2), max(span // 16, 2)), generator=gen, device=device)
    fine = torch.rand((n, 3, h, span), generator=gen, device=device)
    strip = (0.8 * F.interpolate(coarse, size=(h, span), mode="bilinear", align_corners=False) + 0.2 * fine)
    shifts = torch.randint(mix["min_shift"], mix["max_shift"] + 1, (n,), generator=gen, device=device).tolist()
    strip = strip.clamp(0, 1).permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return [(np.ascontiguousarray(strip[i:i + 1, :, :w]), np.ascontiguousarray(strip[i:i + 1, :, s:s + w]))
            for i, s in enumerate(shifts)]


def check_indices(mix: dict, seed: int) -> list[int]:
    """The pool pairs whose answers the output check compares, drawn from
    the seed."""
    rng = np.random.default_rng(stream(seed, 1))
    return sorted(rng.choice(mix["pool_pairs"], size=mix["check_pairs"], replace=False).tolist())
