"""Training-time stereo augmentation, a copy of the JAX package's
`data/augmentor.py` (numpy + PIL; the same draws in the same order, so the
same seed gives the same samples): capability-equivalent to the reference's
albumentations-based DisparityAugmentor (reference
dataloaders/augmentor.py:18-290).

Pipeline (same structure and defaults as the reference):
  1. photometric jitter on the *_aug copies only, asymmetric between views
     with prob `asymmetric_prob` (reference augmentor.py:39-56: 0.3):
     brightness/contrast/saturation/hue/gamma/gaussian-noise,
  2. spatial: random scale (and slight x/y stretch), applied jointly to
     images + gt (gt values scaled by the x-zoom),
  3. horizontal flip WITH left/right view swap + disparity swap (reference
     augmentor.py:119-139), vertical flip,
  4. random crop to crop_size.

Sample dict in/out per data/datasets.py contract (HWC float32, images in
uint8 scale at train time like the reference).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from PIL import Image


def _resize(arr: np.ndarray, hw: tuple[int, int], nearest: bool) -> np.ndarray:
    h, w = hw
    mode = Image.NEAREST if nearest else Image.BILINEAR
    chans = [
        np.asarray(Image.fromarray(arr[..., c].astype(np.float32), mode="F").resize((w, h), mode))
        for c in range(arr.shape[-1])
    ]
    return np.stack(chans, axis=-1)


@dataclass
class DisparityAugmentor:
    crop_size: tuple[int, int] = (320, 640)
    min_scale: float = -0.2
    max_scale: float = 0.2
    do_flip: bool = True
    asymmetric_prob: float = 0.3
    photometric_prob: float = 0.8
    stretch_prob: float = 0.4
    max_stretch: float = 0.1
    vflip_prob: float = 0.1
    noise_std: float = 4.0
    seed: int | None = None

    def __post_init__(self):
        # The RNG is thread-local so PrefetchLoader workers can augment
        # concurrently (the reference accepts the same per-worker stream
        # independence through its DataLoader's worker seeding,
        # base_dataset.py:65-74).  Each thread's stream is derived from
        # (seed, thread-index).
        import itertools
        import threading

        self._tls = threading.local()
        self._thread_counter = itertools.count()

    @property
    def rng(self) -> np.random.Generator:
        if not hasattr(self._tls, "rng"):
            tid = next(self._thread_counter)
            seq = [tid] if self.seed is None else [self.seed, tid]
            self._tls.rng = np.random.default_rng(seq)
        return self._tls.rng

    @rng.setter
    def rng(self, value):
        self._tls.rng = value

    # -- photometric -----------------------------------------------------
    # The full 15-transform family of the reference's albumentations stack
    # (reference augmentor.py:39-56), reimplemented in numpy/PIL with the
    # same per-transform probabilities and albumentations-default-like
    # parameter ranges.  Applied in the reference's order.

    def _box_blur(self, im, k):
        pad = k // 2
        p = np.pad(im, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        c = np.cumsum(np.cumsum(p, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
        return (
            c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
        ) / float(k * k)

    def _gaussian_blur(self, im, k, sigma):
        x = np.arange(k, dtype=np.float32) - k // 2
        g = np.exp(-0.5 * (x / sigma) ** 2)
        g /= g.sum()
        pad = k // 2
        p = np.pad(im, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        out = np.empty_like(im)
        # separable: rows then cols
        tmp = np.zeros((im.shape[0], p.shape[1], im.shape[2]), np.float32)
        for i, wgt in enumerate(g):
            tmp += wgt * p[i : i + im.shape[0], :, :]
        for j, wgt in enumerate(g):
            if j == 0:
                out = wgt * tmp[:, j : j + im.shape[1], :]
            else:
                out += wgt * tmp[:, j : j + im.shape[1], :]
        return out

    def _median_blur(self, im, k):
        pad = k // 2
        p = np.pad(im, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        stack = [
            p[i : i + im.shape[0], j : j + im.shape[1], :]
            for i in range(k)
            for j in range(k)
        ]
        return np.median(np.stack(stack, axis=0), axis=0)

    def _motion_blur(self, im, k, horizontal):
        pad = k // 2
        if horizontal:
            p = np.pad(im, ((0, 0), (pad, pad), (0, 0)), mode="edge")
            return sum(p[:, i : i + im.shape[1], :] for i in range(k)) / float(k)
        p = np.pad(im, ((pad, pad), (0, 0), (0, 0)), mode="edge")
        return sum(p[i : i + im.shape[0], :, :] for i in range(k)) / float(k)

    def _equalize(self, im):
        out = np.empty_like(im)
        for c in range(im.shape[-1]):
            ch = np.clip(im[..., c], 0, 255).astype(np.uint8)
            hist = np.bincount(ch.reshape(-1), minlength=256)
            cdf = np.cumsum(hist).astype(np.float64)
            nz = cdf[cdf > 0]
            if len(nz) == 0:
                out[..., c] = ch
                continue
            cdf = (cdf - nz[0]) / max(cdf[-1] - nz[0], 1) * 255.0
            out[..., c] = cdf[ch]
        return out

    def _clahe(self, im, clip_limit=4.0, tiles=8):
        """Contrast-limited adaptive hist-eq on the luma channel, bilinear
        LUT interpolation between tile histograms (cv2.createCLAHE parity in
        structure; exact bin redistribution differs)."""
        im = np.clip(im, 0, 255)
        luma = im.mean(axis=-1)
        h, w = luma.shape
        li = np.clip(luma, 0, 255).astype(np.uint8)
        th, tw = max(h // tiles, 1), max(w // tiles, 1)
        luts = np.zeros((tiles, tiles, 256), np.float32)
        for ty in range(tiles):
            for tx in range(tiles):
                tile = li[ty * th : (ty + 1) * th if ty < tiles - 1 else h,
                          tx * tw : (tx + 1) * tw if tx < tiles - 1 else w]
                hist = np.bincount(tile.reshape(-1), minlength=256).astype(np.float64)
                limit = clip_limit * hist.sum() / 256.0
                excess = np.maximum(hist - limit, 0).sum()
                hist = np.minimum(hist, limit) + excess / 256.0
                cdf = np.cumsum(hist)
                luts[ty, tx] = cdf / max(cdf[-1], 1) * 255.0
        # bilinear interpolation of tile LUT outputs per pixel
        yy = np.clip((np.arange(h) + 0.5) / th - 0.5, 0, tiles - 1)
        xx = np.clip((np.arange(w) + 0.5) / tw - 0.5, 0, tiles - 1)
        y0 = np.floor(yy).astype(int); y1 = np.minimum(y0 + 1, tiles - 1)
        x0 = np.floor(xx).astype(int); x1 = np.minimum(x0 + 1, tiles - 1)
        fy = (yy - y0)[:, None]; fx = (xx - x0)[None, :]
        idx = li
        v00 = luts[y0[:, None], x0[None, :], idx]
        v01 = luts[y0[:, None], x1[None, :], idx]
        v10 = luts[y1[:, None], x0[None, :], idx]
        v11 = luts[y1[:, None], x1[None, :], idx]
        new_luma = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
                    + v10 * fy * (1 - fx) + v11 * fy * fx)
        scale = new_luma / np.maximum(luma, 1e-3)
        return im * scale[..., None]

    def _hsv_shift(self, im, dh, ds, dv):
        """HueSaturationValue on uint8-scale RGB."""
        x = np.clip(im, 0, 255) / 255.0
        mx = x.max(axis=-1); mn = x.min(axis=-1)
        diff = mx - mn
        r_, g_, b_ = x[..., 0], x[..., 1], x[..., 2]
        hgt = np.zeros_like(mx)
        mask = diff > 1e-8
        rc = np.where(mask, (mx - r_) / np.maximum(diff, 1e-8), 0)
        gc = np.where(mask, (mx - g_) / np.maximum(diff, 1e-8), 0)
        bc = np.where(mask, (mx - b_) / np.maximum(diff, 1e-8), 0)
        hgt = np.where(mx == r_, bc - gc, hgt)
        hgt = np.where(mx == g_, 2.0 + rc - bc, hgt)
        hgt = np.where(mx == b_, 4.0 + gc - rc, hgt)
        hue = (hgt / 6.0) % 1.0
        sat = np.where(mx > 1e-8, diff / np.maximum(mx, 1e-8), 0)
        val = mx
        hue = (hue + dh / 360.0) % 1.0
        sat = np.clip(sat + ds, 0, 1)
        val = np.clip(val + dv, 0, 1)
        i = np.floor(hue * 6.0).astype(int) % 6
        f = hue * 6.0 - np.floor(hue * 6.0)
        p = val * (1 - sat); q = val * (1 - f * sat); t = val * (1 - (1 - f) * sat)
        r2 = np.choose(i, [val, q, p, p, t, val])
        g2 = np.choose(i, [t, val, val, q, p, p])
        b2 = np.choose(i, [p, p, t, val, val, q])
        return np.stack([r2, g2, b2], axis=-1) * 255.0

    def _jpeg(self, im, quality):
        from io import BytesIO

        from PIL import Image

        buf = BytesIO()
        Image.fromarray(np.clip(im, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=int(quality)
        )
        buf.seek(0)
        return np.asarray(Image.open(buf).convert("RGB"), dtype=np.float32)

    def _jitter(self, im: np.ndarray) -> np.ndarray:
        """im uint8-scale float (H,W,3).  Reference stack order
        (augmentor.py:41-56): RGBShift, ChannelDropout, Equalize, HSV,
        ChannelShuffle, RandomBrightnessContrast, RandomGamma, MotionBlur,
        Blur, ToGray, MedianBlur, ImageCompression, GaussNoise,
        GaussianBlur, CLAHE."""
        r = self.rng
        out = im.astype(np.float32)
        if r.random() >= self.photometric_prob:
            return np.clip(out, 0, 255).astype(np.float32)
        if r.random() < 0.5:  # RGBShift (+-20 per channel)
            out = out + r.uniform(-20, 20, (1, 1, 3))
        if r.random() < 0.1:  # ChannelDropout
            out = out.copy()
            out[..., int(r.integers(0, 3))] = 0.0
        if r.random() < 0.1:  # Equalize
            out = self._equalize(np.clip(out, 0, 255))
        if r.random() < 0.5:  # HueSaturationValue (+-20 deg, +-0.3, +-0.2)
            out = self._hsv_shift(
                out, r.uniform(-20, 20), r.uniform(-0.3, 0.3), r.uniform(-0.2, 0.2)
            )
        if r.random() < 0.2:  # ChannelShuffle
            out = out[..., r.permutation(3)]
        # RandomBrightnessContrast p=1
        out = np.clip(out, 0, 255) * r.uniform(0.8, 1.2)
        mean = out.mean(axis=(0, 1), keepdims=True)
        out = (out - mean) * r.uniform(0.8, 1.2) + mean
        if r.random() < 0.1:  # RandomGamma
            out = np.clip(out, 0, 255)
            out = 255.0 * (out / 255.0) ** r.uniform(0.8, 1.2)
        if r.random() < 0.1:  # MotionBlur
            out = self._motion_blur(out, int(r.choice([3, 5, 7])), bool(r.random() < 0.5))
        if r.random() < 0.2:  # Blur
            out = self._box_blur(out, int(r.choice([3, 5, 7])))
        if r.random() < 0.1:  # ToGray
            out = np.repeat(out.mean(axis=-1, keepdims=True), 3, axis=-1)
        if r.random() < 0.1:  # MedianBlur
            out = self._median_blur(out, int(r.choice([3, 5])))
        if r.random() < 0.1:  # ImageCompression (albumentations default 99-100)
            out = self._jpeg(out, r.integers(99, 101))
        if r.random() < 0.1:  # GaussNoise
            out = out + r.normal(0, self.noise_std, out.shape)
        if r.random() < 0.1:  # GaussianBlur
            k = int(r.choice([3, 5, 7]))
            out = self._gaussian_blur(out, k, sigma=0.3 * ((k - 1) * 0.5 - 1) + 0.8)
        if r.random() < 0.1:  # CLAHE
            out = self._clahe(np.clip(out, 0, 255))
        return np.clip(out, 0, 255).astype(np.float32)

    # -- main ------------------------------------------------------------
    def __call__(self, data: dict) -> dict:
        r = self.rng
        im2, im3 = data["im2"], data["im3"]
        gt, validgt = data["gt"], data["validgt"]
        gt_r, validgt_r = data["gt_right"], data["validgt_right"]
        mono2 = data.get("im2_mono")
        mono3 = data.get("im3_mono")

        ch, cw = self.crop_size
        h, w = im2.shape[:2]

        # --- spatial scale / stretch -----------------------------------
        min_zoom = max((ch + 8) / h, (cw + 8) / w)
        zoom = max(2.0 ** r.uniform(self.min_scale, self.max_scale), min_zoom)
        zx = zy = zoom
        if r.random() < self.stretch_prob:
            zx *= 2.0 ** r.uniform(-self.max_stretch, self.max_stretch)
            zx = max(zx, min_zoom)
        nh, nw = int(round(h * zy)), int(round(w * zx))

        def spatial(arr, nearest=False, scale_vals=False):
            if arr is None:
                return None
            out = _resize(arr, (nh, nw), nearest)
            return out * zx if scale_vals else out

        im2 = spatial(im2)
        im3 = spatial(im3)
        gt = spatial(gt, nearest=True, scale_vals=True)
        validgt = spatial(validgt, nearest=True)
        gt_r = spatial(gt_r, nearest=True, scale_vals=True)
        validgt_r = spatial(validgt_r, nearest=True)
        mono2 = spatial(mono2)
        mono3 = spatial(mono3)

        # --- horizontal flip with view swap (reference :119-139) --------
        if self.do_flip and r.random() < 0.5:
            im2, im3 = im3[:, ::-1], im2[:, ::-1]
            gt, gt_r = gt_r[:, ::-1], gt[:, ::-1]
            validgt, validgt_r = validgt_r[:, ::-1], validgt[:, ::-1]
            if mono2 is not None:
                mono2, mono3 = mono3[:, ::-1], mono2[:, ::-1]

        # --- vertical flip ----------------------------------------------
        if self.do_flip and r.random() < self.vflip_prob:
            flip = lambda a: None if a is None else a[::-1]
            im2, im3, gt, validgt, gt_r, validgt_r = map(flip, (im2, im3, gt, validgt, gt_r, validgt_r))
            mono2, mono3 = flip(mono2), flip(mono3)

        # --- random crop -------------------------------------------------
        nh, nw = im2.shape[:2]
        y0 = r.integers(0, max(nh - ch, 0) + 1)
        x0 = r.integers(0, max(nw - cw, 0) + 1)
        crop = lambda a: None if a is None else np.ascontiguousarray(a[y0 : y0 + ch, x0 : x0 + cw])
        im2, im3, gt, validgt, gt_r, validgt_r = map(crop, (im2, im3, gt, validgt, gt_r, validgt_r))
        mono2, mono3 = crop(mono2), crop(mono3)

        # --- photometric on the _aug copies ------------------------------
        if r.random() < self.asymmetric_prob:
            im2_aug, im3_aug = self._jitter(im2), self._jitter(im3)
        else:
            # symmetric: same transform for both views via a shared substream
            state = self.rng.bit_generator.state
            im2_aug = self._jitter(im2)
            self.rng.bit_generator.state = state
            im3_aug = self._jitter(im3)

        out = {
            "im2": im2 / 255.0,
            "im3": im3 / 255.0,
            "im2_aug": im2_aug / 255.0,
            "im3_aug": im3_aug / 255.0,
            "gt": gt,
            "validgt": validgt,
            "gt_right": gt_r,
            "validgt_right": validgt_r,
        }
        if mono2 is not None:
            out["im2_mono"] = mono2
            out["im3_mono"] = mono3
        return out
