"""Per-dataset tile presets for row-tiled high-resolution inference, and a
tiling chosen from the device's free memory: a copy of the JAX package's
`parallel/presets.py` (the reference's tile_presets.py and
memory_utils.py, reshaped for full-width row tiles).

The one change: with `hbm_bytes_free=None`, `select_tiling_parameters`
reads the card's free bytes from `torch.cuda.mem_get_info`; off the card
the caller passes them.  There is no guess for a missing device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TilePreset:
    """n_tiles row bands with `overlap` rows of sin^2-blended overlap."""

    n_tiles: int
    overlap: int
    iscale: float = 1.0

    def __post_init__(self):
        if self.overlap % 32 != 0:
            raise ValueError("overlap must be a multiple of 32 (model stride)")


# Tuned per benchmark resolution (heights: kitti 375, middlebury 2014 ~2000,
# booster 3008x4112, monotrap 480).
TILE_PRESETS: dict[str, TilePreset] = {
    "default": TilePreset(n_tiles=2, overlap=64),
    "kitti2012": TilePreset(n_tiles=1, overlap=0),
    "kitti2015": TilePreset(n_tiles=1, overlap=0),
    "eth3d": TilePreset(n_tiles=1, overlap=0),
    "middlebury": TilePreset(n_tiles=4, overlap=128),
    "middlebury2021": TilePreset(n_tiles=2, overlap=96),
    "booster": TilePreset(n_tiles=8, overlap=160),
    "layeredflow": TilePreset(n_tiles=2, overlap=64),
    "monotrap": TilePreset(n_tiles=1, overlap=0),
}


def get_preset_for_dataset(name: str) -> TilePreset:
    """The preset of a dataset name, or of its part before the first `_`,
    else the default one."""
    key = name.lower()
    for candidate in (key, key.split("_")[0]):
        if candidate in TILE_PRESETS:
            return TILE_PRESETS[candidate]
    return TILE_PRESETS["default"]


def select_tiling_parameters(
    image_h: int,
    image_w: int,
    hbm_bytes_free: int | None = None,
    n_devices: int = 1,
    bytes_per_pixel_budget: float = 2800.0,
) -> TilePreset:
    """The smallest power-of-two tile count whose share of the footprint
    fits in 0.8 of the free device memory.

    The dominant allocations are the (H/4, W/4, W/4) volumes and the
    hourglass's activations, O(H * W^2 / 16); `bytes_per_pixel_budget` is
    the bytes an input pixel costs at W ~ 1024, scaled by (W / 1024)^2.
    `hbm_bytes_free=None` reads the card's free bytes (`mem_get_info`) and
    raises without a card."""
    if hbm_bytes_free is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to read free memory from: pass hbm_bytes_free")
        hbm_bytes_free = torch.cuda.mem_get_info()[0]
    per_pixel = bytes_per_pixel_budget * max((image_w / 1024.0) ** 2, 0.25)
    total = image_h * image_w * per_pixel
    n = 1
    while total / n > hbm_bytes_free * 0.8 and n < 64:
        n *= 2
    n = max(n, n_devices) if n > 1 else n
    return TilePreset(n_tiles=n, overlap=64 if n > 1 else 0)
