"""Benchmark evaluation harness: the reference's `test.py` protocol, as the
JAX package's `eval/harness.py` runs it.

Per sample (reference `test.py:160-274`):
  1. with `iscale` != 1, the images are downscaled by `resize_np(...,
     nearest=True)`; with `oscale` != 1, gt, validgt and maskocc too (gt
     values divided by oscale), and the metrics run at that resolution.
     "nearest" is `jax.image.resize`'s: source index floor((i + 0.5) * in /
     out), half-pixel centres.  The reference's `F.interpolate` default
     takes floor(i * in / out): the JAX package, the oracle here, differs
     from it, and the port follows the JAX package;
  2. mono depth of both views from `mono_fn` (DAv2 at the dataset's size of
     `DAV2_SIZES`), or the sample's precomputed mono resized to the images
     with `jax.image.resize`'s antialiased bilinear;
  3. joint min-max normalisation of the mono pair with eps=0;
  4. centred replicate pad up to the sample's `ShapeBucketer` bucket;
  5. `stereo_fn` (the stereo forward, positive disparity);
  6. unpad; only when the prediction's and gt's scales differ, a nearest
     resize to the gt grid with the values scaled by iscale / oscale;
  7. numpy `guided_metrics` per sample (and MonoTrap's depth metrics).

Everything here runs on the host in numpy; the card runs only `stereo_fn`
and `mono_fn` (`eval/programs.py`).

`ShapeBucketer` keeps the JAX package's buckets: the padded context changes
the disparity, so the same buckets give the same metrics.  Its widths are
rounded to 64 for a TPU reason (the blocked hourglass's split); whether
another multiple runs faster on the card is not measured.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np

from stereoanywhere_tpu_torch.eval.metrics import depth_metrics, guided_metrics
from stereoanywhere_tpu_torch.ops.interp import _jax_image_matrix

# Canonical per-benchmark eval scales (reference run_test.py:53-75 +
# README.md:323: "use 4 for Booster, 8 for LayeredFlow, 1 for others" —
# iscale == oscale for every published table).  Datasets not listed use 1.0.
EVAL_SCALES: dict[str, float] = {
    "booster": 4.0,
    "layeredflow": 8.0,
}


def eval_preset(dataset: str) -> dict[str, float]:
    """The shipped iscale/oscale bundle for `dataset` (reference Table 2/3
    protocol); cli eval defaults to these when flags are not given."""
    s = EVAL_SCALES.get(dataset, 1.0)
    return {"iscale": s, "oscale": s}


# Per-dataset DAv2 input sizes (reference test.py:192-195)
DAV2_SIZES: dict[str, tuple[int, int]] = {
    "kitti2012": (1372, 518),
    "kitti2015": (1372, 518),
    "kitti_stereo": (1372, 518),
    "middlebury": (1036, 1036),
    "middlebury2021": (1372, 770),
    "eth3d": (518, 518),
    "booster": (1036, 756),
    "layeredflow": (952, 532),
    "monotrap": (518, 518),
    "sceneflow": (518, 518),
}


def pad_to_multiple(x: np.ndarray, multiple: int = 32) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Centered replicate pad (reference test.py:204-213).
    Returns padded array and (top, bottom, left, right)."""
    h, w = x.shape[1], x.shape[2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    return pad_to_shape(x, (h + ph, w + pw))


def pad_to_shape(x: np.ndarray, hw: tuple[int, int]) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Centered replicate pad up to an exact (H, W) — the pad-32 rule
    generalized to bucket shapes.  Returns padded array and pads."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = hw[0] - h, hw[1] - w
    assert ph >= 0 and pw >= 0, (x.shape, hw)
    top, bottom = ph // 2, ph - ph // 2
    left, right = pw // 2, pw - pw // 2
    out = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)), mode="edge")
    return out, (top, bottom, left, right)


class ShapeBucketer:
    """Maps raw (h, w) eval sizes onto a bounded set of program shapes.

    Buckets are discovered lazily: the first `max_buckets` distinct pad-32
    shapes become buckets verbatim; after the cap, the bucket whose union
    with the new shape wastes the least area grows to that union (a new
    program, count stays capped).  A sample reuses the smallest existing
    bucket that fits it.  Bucket widths are rounded to `width_multiple`
    (default 64, the JAX package's).
    """

    def __init__(self, multiple: int = 32, max_buckets: int = 3, width_multiple: int = 64):
        self.multiple = multiple
        self.width_multiple = max(width_multiple, multiple)
        self.max_buckets = max_buckets
        self.buckets: list[tuple[int, int]] = []

    def _ceil(self, v: int, m: int | None = None) -> int:
        m = self.multiple if m is None else m
        return ((v + m - 1) // m) * m

    def bucket_for(self, h: int, w: int) -> tuple[int, int]:
        need = (self._ceil(h), self._ceil(w, self.width_multiple))
        fits = [b for b in self.buckets if b[0] >= need[0] and b[1] >= need[1]]
        if fits:
            return min(fits, key=lambda b: b[0] * b[1])
        if len(self.buckets) < self.max_buckets:
            self.buckets.append(need)
            return need
        unions = [
            (max(b[0], need[0]), max(b[1], need[1])) for b in self.buckets
        ]
        i = min(range(len(unions)), key=lambda i: unions[i][0] * unions[i][1])
        self.buckets[i] = unions[i]
        return unions[i]


def unpad(x: np.ndarray, pads: tuple[int, int, int, int]) -> np.ndarray:
    t, b, l, r = pads
    h, w = x.shape[1], x.shape[2]
    return x[:, t : h - b, l : w - r]


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """`jax.image.resize`'s nearest source index floor((i + 0.5) * in / out)
    as XLA computes it: the constant factor folded to in * (1 / out), each
    step in f32 (at 82 -> 41 it gives 2i, where exact arithmetic gives
    2i + 1)."""
    scale = np.float32(in_size) * (np.float32(1.0) / np.float32(out_size))
    return np.floor((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale).astype(np.int64)


def resize_np(x: np.ndarray, out_hw: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """(N,H,W,C) -> (N,out_h,out_w,C) f32 with `jax.image.resize`'s
    semantics: "nearest" (half-pixel centres), or "bilinear" (the tent,
    antialiased when downsampling)."""
    x = np.asarray(x, np.float32)
    for axis, out_size in ((1, out_hw[0]), (2, out_hw[1])):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        if nearest:
            x = np.take(x, _nearest_index(in_size, out_size), axis=axis)
        else:
            m = _jax_image_matrix(in_size, out_size, "bilinear")
            x = np.moveaxis(np.tensordot(x, m, axes=([axis], [1])), -1, axis)
    return np.ascontiguousarray(x, np.float32)


def joint_minmax_np(m2: np.ndarray, m3: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Joint per-sample, per-channel min-max normalisation of the mono pair
    with eps=0: the eval protocol's bare (x - min) / (max - min) (reference
    test.py:198), unlike the model's own normalisation."""
    lo = np.minimum(m2.min(axis=(1, 2), keepdims=True), m3.min(axis=(1, 2), keepdims=True))
    hi = np.maximum(m2.max(axis=(1, 2), keepdims=True), m3.max(axis=(1, 2), keepdims=True))
    return (m2 - lo) / (hi - lo), (m3 - lo) / (hi - lo)


@dataclass
class EvalResult:
    per_sample: list[dict] = field(default_factory=list)

    def mean(self) -> dict[str, float]:
        keys = [k for k in self.per_sample[0] if k != "errormap" and not k.startswith("_")]
        out = {}
        for k in keys:
            vals = [s[k] for s in self.per_sample if np.isfinite(s.get(k, np.nan))]
            out[k] = float(np.mean(vals)) if vals else float("nan")
        return out

    def to_csv(self, path: str, extra_cols: dict | None = None):
        rows = self.mean()
        rows.update(extra_cols or {})
        exists = os.path.exists(path)
        with open(path, "a", newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=list(rows))
            if not exists:
                wtr.writeheader()
            wtr.writerow(rows)


class Evaluator:
    """Runs the zero-shot benchmark protocol over a dataset iterable.

    stereo_fn(im2, im3, mono2, mono3) -> (1,H,W,1) positive disparity
    mono_fn(images01 (2,H,W,3), dataset) -> (2,H,W,1) raw mono depth, or None
        to use precomputed sample['im2_mono'].
    Both take and give numpy arrays.
    """

    def __init__(
        self,
        stereo_fn: Callable,
        mono_fn: Callable | None = None,
        dataset_name: str = "middlebury",
        iscale: float = 1.0,
        oscale: float = 1.0,
        pad_multiple: int = 32,
        save_images_dir: str | None = None,
        bucketer: "ShapeBucketer | None | str" = "auto",
    ):
        self.stereo_fn = stereo_fn
        self.mono_fn = mono_fn
        self.dataset_name = dataset_name
        self.iscale = iscale
        self.oscale = oscale
        self.pad_multiple = pad_multiple
        self.save_images_dir = save_images_dir
        if bucketer == "auto":
            bucketer = ShapeBucketer(multiple=pad_multiple)
        self.bucketer = bucketer
        self._sample_idx = 0

    def run_sample(self, sample: dict) -> dict:
        im2 = sample["im2"][None]  # (1,H,W,3) in [0,1]
        im3 = sample["im3"][None]
        gt = sample["gt"][None]
        valid = sample["validgt"][None]
        maskocc = sample.get("maskocc")
        maskocc = np.zeros_like(gt) if maskocc is None else maskocc[None]

        h0, w0 = im2.shape[1:3]
        if self.iscale != 1.0:
            # reference test.py:170-171: a downscale by 1/iscale, floor(in*scale) sizes
            hs, ws = int(h0 * (1.0 / self.iscale)), int(w0 * (1.0 / self.iscale))
            im2 = resize_np(im2, (hs, ws), nearest=True)
            im3 = resize_np(im3, (hs, ws), nearest=True)
        if self.oscale != 1.0:
            # reference test.py:174-176: gt/valid/maskocc nearest-downscaled
            # (gt values divided by oscale); metrics run at THIS resolution.
            ho, wo = int(h0 * (1.0 / self.oscale)), int(w0 * (1.0 / self.oscale))
            gt = resize_np(gt, (ho, wo), nearest=True) / self.oscale
            valid = resize_np(valid, (ho, wo), nearest=True)
            maskocc = resize_np(maskocc, (ho, wo), nearest=True)

        if float(gt.max()) == 0.0:
            # no labeled points: metrics of an all-zero prediction
            # (reference test.py:182-187)
            m = guided_metrics(
                np.zeros_like(gt)[0, ..., 0], gt[0, ..., 0], valid[0, ..., 0],
                maskocc[0, ..., 0],
            )
            m.pop("errormap", None)
            return m

        # mono branch
        if self.mono_fn is not None:
            mono = np.asarray(self.mono_fn(np.concatenate([im2, im3], 0), self.dataset_name))
            mono2, mono3 = mono[:1], mono[1:]
        else:
            mono2 = resize_np(sample["im2_mono"][None], im2.shape[1:3])
            mono3 = resize_np(sample["im3_mono"][None], im2.shape[1:3])
        mono2, mono3 = joint_minmax_np(mono2, mono3)

        if self.bucketer is not None:
            bh, bw = self.bucketer.bucket_for(*im2.shape[1:3])
            im2p, pads = pad_to_shape(im2, (bh, bw))
            im3p, _ = pad_to_shape(im3, (bh, bw))
            mono2p, _ = pad_to_shape(mono2, (bh, bw))
            mono3p, _ = pad_to_shape(mono3, (bh, bw))
        else:
            im2p, pads = pad_to_multiple(im2, self.pad_multiple)
            im3p, _ = pad_to_multiple(im3, self.pad_multiple)
            mono2p, _ = pad_to_multiple(mono2, self.pad_multiple)
            mono3p, _ = pad_to_multiple(mono3, self.pad_multiple)

        disp = np.asarray(self.stereo_fn(im2p, im3p, mono2p, mono3p))
        disp = unpad(disp, pads)

        if self.iscale != 1.0 and self.iscale / self.oscale != 1.0:
            # reference test.py:241-243: only when the prediction and gt
            # resolutions differ — nearest resize to the gt grid, disparity
            # values scaled by iscale/oscale.  With iscale == oscale (every
            # published table) the prediction stays at the reduced
            # resolution and the metrics run there.
            disp = resize_np(disp, gt.shape[1:3], nearest=True) * (
                self.iscale / self.oscale
            )

        m = guided_metrics(disp[0, ..., 0], gt[0, ..., 0], valid[0, ..., 0],
                           maskocc[0, ..., 0])
        m.pop("errormap", None)

        if self.save_images_dir:
            # qualitative grids (reference test.py:298-334 --save_images)
            from stereoanywhere_tpu_torch.utils.logging import dump_images
            from stereoanywhere_tpu_torch.utils.visualization import (
                bad_tau_map,
                colorize_disparity,
                kitti_error_colormap,
            )

            d0, g0, v0 = disp[0, ..., 0], gt[0, ..., 0], valid[0, ..., 0]
            vmax = float(np.percentile(g0[v0 > 0], 97)) if (v0 > 0).any() else None
            dump_images(
                self.save_images_dir,
                self._sample_idx,
                {
                    "left": sample["im2"],
                    "dmap": colorize_disparity(d0, vmax),
                    "gt": colorize_disparity(np.where(v0 > 0, g0, 0.0), vmax),
                    "maemap": kitti_error_colormap(d0, g0, v0),
                    "metricmap": bad_tau_map(d0, g0, v0),
                    "mono": np.repeat(np.clip(mono2[0], 0, 1), 3, axis=-1),
                },
            )
            self._sample_idx += 1

        if "gt_depth" in sample:
            # disp -> depth via fixed rig constants (reference
            # test_monotrap.py:246-255): only POSITIVE disparities are
            # converted (non-positive values pass through raw and are then
            # clamped to 0 by the clip), the depth map is clipped to
            # [0, gt_depth.max()], and the metric validity mask is the
            # DISPARITY validity (data['validgt']), not validgt_depth.
            from stereoanywhere_tpu_torch.data.datasets import MonoTrapDataset

            gt_depth = sample["gt_depth"][None]
            if self.oscale != 1.0:
                # reference test_monotrap.py:178: gt_depth nearest-downscaled
                # (metric depth — values NOT divided by oscale)
                gt_depth = resize_np(gt_depth, gt.shape[1:3], nearest=True)
            d0 = disp[0, ..., 0]
            gd = gt_depth[0, ..., 0]
            depth = np.where(
                d0 > 0,
                MonoTrapDataset.BASELINE * MonoTrapDataset.FOCAL / np.where(d0 > 0, d0, 1.0),
                d0,
            )
            depth = np.clip(depth, 0, gd.max())
            dm = depth_metrics(depth, gd, valid[0, ..., 0])
            dm.pop("errormap", None)
            m.update({f"depth/{k}": v for k, v in dm.items()})
        return m

    def run(self, dataset: Iterable, max_samples: int | None = None) -> EvalResult:
        result = EvalResult()
        for i, sample in enumerate(dataset):
            if max_samples is not None and i >= max_samples:
                break
            result.per_sample.append(self.run_sample(sample))
        return result
