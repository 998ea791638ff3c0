"""Mirror-aware high-resolution inference: the port of the JAX package's
`parallel/non_lambertian.py` (the reference's NonLambertianProcessor).

Candidate non-Lambertian regions come from an Otsu threshold on the
normalised |left - right| intensity difference, quantised to uint8 as the
reference's `cv2.threshold(u8, THRESH_OTSU)` takes it.  The JAX package
thresholds through `native/libstereodata.so` (`sd_otsu_threshold`) when
that library is built and through a float histogram otherwise; the port
imports nothing of it, so `otsu_threshold_u8` reproduces the native
function in numpy, bit for bit, and the mask always takes that path.
`otsu_threshold`, the float histogram, is kept for callers of it.
"""
from __future__ import annotations

import numpy as np

from stereoanywhere_tpu_torch.parallel.tiles import TileParallelInference


def otsu_threshold(gray: np.ndarray, bins: int = 256) -> float:
    """Otsu's method on a [0,1] grayscale image over a float histogram of
    `bins` bins: the centre of the bin that maximises the between-class
    variance."""
    hist, edges = np.histogram(gray.ravel(), bins=bins, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0.5
    p = hist / total
    centers = 0.5 * (edges[:-1] + edges[1:])
    w0 = np.cumsum(p)
    w1 = 1.0 - w0
    mu = np.cumsum(p * centers)
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = (mu_t * w0 - mu) ** 2 / (w0 * w1)
    sigma_b[~np.isfinite(sigma_b)] = -1
    return float(centers[int(np.argmax(sigma_b))])


def otsu_threshold_u8(img: np.ndarray) -> int:
    """Otsu threshold of a uint8 array, as `native/stereodata.cc`
    `sd_otsu_threshold` computes it in double: for each t with pixels on
    both sides, w_b * w_f * (m_b - m_f)^2, the first t of the largest
    value (0 when no t splits the pixels).  The sums are of integers, exact
    in double in any order, so the result is the native one bit for bit."""
    img = np.asarray(img, np.uint8)
    hist = np.bincount(img.ravel(), minlength=256).astype(np.int64)
    w_b = np.cumsum(hist)
    w_f = img.size - w_b
    levels = np.arange(256, dtype=np.float64)
    sum_b = np.cumsum(levels * hist)
    valid = (w_b > 0) & (w_f > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = sum_b / w_b - (sum_b[-1] - sum_b) / w_f
        var = w_b.astype(np.float64) * w_f.astype(np.float64) * d * d
    return int(np.argmax(np.where(valid, var, -1.0)))


def non_lambertian_mask(im2: np.ndarray, im3: np.ndarray) -> np.ndarray:
    """Binary mask (float32) of photometrically inconsistent pixels: the
    channel-mean |left - right| difference, normalised by its maximum,
    quantised to uint8 and thresholded by Otsu (the reference's
    non_lambertian.py:34-43)."""
    diff = np.abs(im2.mean(axis=-1) - im3.mean(axis=-1))
    diff = diff / max(diff.max(), 1e-6)
    u8 = np.round(diff * 255).astype(np.uint8)
    return (u8 > otsu_threshold_u8(u8)).astype(np.float32)


class NonLambertianProcessor(TileParallelInference):
    """TileParallelInference that also reports the non-Lambertian coverage.
    Build its model with the mirror handling on (`use_truncate_vol` and the
    mirror fields of `StereoAnywhereConfig`), which the reference forces."""

    def analyze(self, im2_np: np.ndarray, im3_np: np.ndarray) -> dict:
        mask = non_lambertian_mask(im2_np, im3_np)
        return {"mask": mask, "coverage": float(mask.mean())}
