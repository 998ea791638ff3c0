"""Row-tiled high-resolution inference on one card: the port of the JAX
package's `parallel/tiles.py` (the reference's mapreduce_v2 tile wrapper).

The image is cut into overlapping full-width row bands whose height is a
multiple of 32; each band runs the test-mode forward, and the bands are
blended back with a sin^2 row window over their overlaps.  Full-width bands
keep the whole disparity range and every epipolar row intact.

On one card the tile axis is a batch.  `sequential=False` runs all the
bands as one batch, B = n_tiles (the JAX package's program sharded over a
mesh's tile axis computes the same); `sequential=True` runs them one after
another, as the JAX package's `lax.map` does, so the peak holds one band's
activations.  Where the JAX package compiles one program per (tile_h,
n_tiles, W), the port keeps one `_Program` of the serving pipeline per
plan and W on the card: an eager first call, then one CUDA graph of the
extraction, the forwards and the stitch, replayed after.  Each replay
stitches into an accumulator made anew inside it.  `graphs=False` runs every call eagerly,
and the CPU runs only so.  Public functions take and give NHWC tensors, as
the JAX package's do.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from stereoanywhere_tpu_torch.device import device_constant
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
from stereoanywhere_tpu_torch.serve.pipeline import GraphOwner, _Program, normalize_and_pad


@dataclass(frozen=True)
class TilePlan:
    """Row-tile geometry: n_tiles tiles of tile_h rows, stride = tile_h - overlap."""

    image_h: int
    tile_h: int
    overlap: int
    starts: tuple[int, ...]

    @property
    def n_tiles(self) -> int:
        return len(self.starts)


def plan_row_tiles(image_h: int, n_tiles: int, overlap: int, multiple: int = 32) -> TilePlan:
    """Split H into n_tiles overlapping row bands, tile_h a multiple of
    `multiple`, the starts spread evenly and rounded (the JAX package's
    rule, edge-clamped like the reference's `_enumerate_tiles`)."""
    if n_tiles == 1:
        return TilePlan(image_h, image_h, 0, (0,))
    raw = math.ceil((image_h + (n_tiles - 1) * overlap) / n_tiles)
    tile_h = min(image_h, math.ceil(raw / multiple) * multiple)
    stride = (image_h - tile_h) / max(n_tiles - 1, 1)
    starts = tuple(int(round(i * stride)) for i in range(n_tiles))
    return TilePlan(image_h, tile_h, tile_h - int(math.ceil(stride)), starts)


def blend_window(tile_h: int) -> np.ndarray:
    """sin^2 row weight (the reference's `_make_blend_weight`), clamped away
    from zero so that every row keeps support."""
    w = np.sin(np.pi * (np.arange(tile_h) + 0.5) / tile_h) ** 2
    return np.maximum(w, 1e-3).astype(np.float32)


def extract_row_tiles(x: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(1,H,W,C) -> (T, tile_h, W, C), the overlapping bands stacked."""
    return torch.stack([x[0, s : s + plan.tile_h] for s in plan.starts])


def stitch_row_tiles(tiles: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(T, tile_h, W, C) -> (1, H, W, C): each band weighted by the blend
    window, summed into fresh accumulators tile by tile in the JAX
    package's order, divided by the summed weights."""
    _, th, w, c = tiles.shape
    win = device_constant(blend_window, (th,), tiles.device, tiles.dtype).view(th, 1, 1)
    acc = torch.zeros((plan.image_h, w, c), device=tiles.device, dtype=tiles.dtype)
    wacc = torch.zeros((plan.image_h, 1, 1), device=tiles.device, dtype=tiles.dtype)
    for i, s in enumerate(plan.starts):
        acc[s : s + th] += tiles[i] * win
        wacc[s : s + th] += win
    return (acc / wacc)[None]


def _tiled_forward(model: StereoAnywhere, iters: int, sequential: bool, plan: TilePlan,
                   im2, im3, mde2, mde3) -> torch.Tensor:
    """Extract the bands, run the test-mode forward on them (one batch, or
    one band after another), stitch."""
    tiles = [extract_row_tiles(x, plan) for x in (im2, im3, mde2, mde3)]
    if sequential:
        disp = torch.cat([model(*(t[i : i + 1] for t in tiles), iters=iters)["disparity"]
                          for i in range(plan.n_tiles)])
    else:
        disp = model(*tiles, iters=iters)["disparity"]
    return stitch_row_tiles(disp, plan)


class TileParallelInference(GraphOwner):
    """High-resolution stereo inference over row tiles of one image.

    `model` is a `StereoAnywhere`, moved to `device` (the card unless "cpu"
    is asked for).  `infer` runs its test-mode forward with `iters`
    iterations on every band of `plan_row_tiles(H, n_tiles, overlap)` and
    stitches the bands' disparities; `stereo_stage` wraps it as the
    serving pipeline's stereo stage."""

    def __init__(
        self,
        model: StereoAnywhere,
        n_tiles: int,
        overlap: int = 64,
        iters: int = 32,
        sequential: bool = False,
        device: str | torch.device = "cuda",
        graphs: bool | None = None,
    ):
        super().__init__(device, graphs)
        self.model = model.to(self.device)
        self.n_tiles, self.overlap, self.iters, self.sequential = n_tiles, overlap, iters, sequential
        self._programs: dict[tuple, _Program] = {}

    def _build(self, plan: TilePlan, w: int) -> _Program:
        """The program of (plan, W).  Keyed on the whole plan, not on tile_h
        alone: two heights can share a tile_h with other starts (2 tiles of
        544 rows, overlap 64, for H 992 and 1024).  Its body holds the
        model, not this object, so that dropping this object frees its
        graphs without waiting for the cycle collector."""
        key = (plan, w)
        if key not in self._programs:
            body = functools.partial(_tiled_forward, self.model, self.iters, self.sequential, plan)
            self._programs[key] = self._program(body)
        return self._programs[key]

    @torch.inference_mode()
    def infer(self, im2, im3, mde2, mde3) -> torch.Tensor:
        """im* (1,H,W,3), mde* (1,H,W,1), H a multiple of 32 (tensors or
        arrays).  Returns (1,H,W,1) positive disparity, f32."""
        self.requests += 1
        im2, im3, mde2, mde3 = (self._tensor(x) for x in (im2, im3, mde2, mde3))
        b, h, w, _ = im2.shape
        assert b == 1, "the tiled path takes one image (like the reference's tile_wrapper.py:148-149)"
        if h % 32:
            raise ValueError(f"H {h} is no multiple of 32: pad the image first (stereo_stage does)")
        program = self._build(plan_row_tiles(h, self.n_tiles, self.overlap), w)
        if not self.graphs:
            return program.body(im2, im3, mde2, mde3)
        return program(im2, im3, mde2, mde3)

    @torch.inference_mode()
    def stereo_stage(self, im2, im3, mde2, mde3) -> torch.Tensor:
        """The serving pipeline's stereo stage with the model run over row
        tiles: joint min-max normalize the depth pair, edge-pad to a
        multiple of 32, `infer`, unpad.  (1,H,W,3) views and (1,H,W,1)
        depth (tensors or arrays) -> (1,H,W,1) disparity, f32."""
        im2, im3, mde2, mde3 = (self._tensor(x) for x in (im2, im3, mde2, mde3))
        _, h, w, _ = im2.shape
        inputs, (t, l) = normalize_and_pad(im2, im3, mde2, mde3)
        return self.infer(*inputs)[:, t : t + h, l : l + w]
