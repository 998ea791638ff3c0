"""Auxiliary losses and classical utilities, a copy of the JAX package's
`train/loss_extras.py`: SSIM/CSIM, smoothness, photometric, self-supervised,
triplet and sparsity losses (reference losses.py:9-197, unused by its
train.py), SiLog and affine-invariant MAE (losses.py:345-410) and the
RANSAC scale/shift recovery (reference utils.py:28-87).  Maps are NHWC.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.ops.geometry import disp_warping


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 average pool of an NHWC map, zero padding counted."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=True).permute(0, 2, 3, 1)


def _moments(x, y):
    mu_x, mu_y = _avg_pool3(x), _avg_pool3(y)
    sig_x = _avg_pool3(x * x) - mu_x ** 2
    sig_y = _avg_pool3(y * y) - mu_y ** 2
    sig_xy = _avg_pool3(x * y) - mu_x * mu_y
    return mu_x, mu_y, sig_x, sig_y, sig_xy


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Window-3 SSIM distance (reference losses.py:9-34): (1 - SSIM)/2."""
    mu_x, mu_y, sig_x, sig_y, sig_xy = _moments(x, y)
    n = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    d = (mu_x ** 2 + mu_y ** 2 + c1) * (sig_x + sig_y + c2)
    return ((1 - n / d) / 2).clamp(0, 1)


def csim(x: torch.Tensor, y: torch.Tensor, k1: float = 0.25, k2: float = 1.0) -> torch.Tensor:
    """Window-3 CSIM distance (reference losses.py:35-62): K1 (mu_x - mu_y)^2
    + K2 (sig_x + sig_y - 2 sig_xy), through SSIM's (1 - v)/2 clamp."""
    mu_x, mu_y, sig_x, sig_y, sig_xy = _moments(x, y)
    v = k1 * (mu_x ** 2 + mu_y ** 2 - 2 * mu_x * mu_y) + k2 * (sig_x + sig_y - 2 * sig_xy)
    return ((1 - v) / 2).clamp(0, 1)


def photometric_loss(img, img_warped, alpha: float = 0.85):
    """alpha SSIM + (1 - alpha) L1."""
    return alpha * ssim(img, img_warped).mean() + (1 - alpha) * (img - img_warped).abs().mean()


def smoothness_loss(disp, img):
    """Edge-aware first-order smoothness."""
    dx_d = (disp[:, :, 1:] - disp[:, :, :-1]).abs()
    dy_d = (disp[:, 1:] - disp[:, :-1]).abs()
    dx_i = (img[:, :, 1:] - img[:, :, :-1]).abs().mean(-1, keepdim=True)
    dy_i = (img[:, 1:] - img[:, :-1]).abs().mean(-1, keepdim=True)
    return (dx_d * torch.exp(-dx_i)).mean() + (dy_d * torch.exp(-dy_i)).mean()


def _warp_right_to_left(im_right, disp_left):
    """The right view warped to the left by the (non-negative) left disparity, NHWC."""
    warped = disp_warping(F.relu(disp_left).permute(0, 3, 1, 2), im_right.permute(0, 3, 1, 2), right_disp=False)
    return warped.permute(0, 2, 3, 1)


def self_supervised_loss(im_left, im_right, disp_left):
    """Photometric consistency of the right view warped to the left."""
    return photometric_loss(im_left, _warp_right_to_left(im_right, disp_left))


def triplet_photometric_loss(im_left, im_right, disp_left, margin: float = 0.05):
    """The warped right view must beat the unwarped one by `margin`."""
    pos = (im_left - _warp_right_to_left(im_right, disp_left)).abs().mean()
    neg = (im_left - im_right).abs().mean()
    return F.relu(pos - neg + margin)


def sparsity_loss(conf):
    """Favour confident (sparse-uncertainty) maps."""
    return (1.0 - conf).mean()


def total_variation_loss(img, weight: float = 1.0):
    """reference losses.py:193-197."""
    tv_h = ((img[:, 1:] - img[:, :-1]) ** 2).sum()
    tv_w = ((img[:, :, 1:] - img[:, :, :-1]) ** 2).sum()
    return weight * (tv_h + tv_w) / np.prod(img.shape)


def silog_loss(pred, target, valid, lambd: float = 0.5):
    """Scale-invariant log loss (reference SiLogLoss, losses.py:345-356)."""
    m = valid.to(pred.dtype)
    n = m.sum().clamp(min=1.0)
    diff = (torch.log(target.clamp(min=1e-6)) - torch.log(pred.clamp(min=1e-6))) * m
    mean = diff.sum() / n
    mean_sq = (diff ** 2).sum() / n
    return (mean_sq - lambd * mean ** 2).clamp(min=0.0).sqrt()


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's nanmedian (the mean of the two middle values of an even
    count), which torch.nanmedian is not (it takes the lower one)."""
    vals = x[~torch.isnan(x)].sort().values
    n = vals.numel()
    if n == 0:
        return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def affine_invariant_mae(pred, target, valid, eps: float = 1e-6):
    """Median/MAD-normalised MAE (reference AffineInvariantV2MAELoss,
    losses.py:386-410) over the valid pixels."""
    m = valid > 0

    def norm(x):
        vals = torch.where(m, x, torch.full_like(x, float("nan")))
        t = _nanmedian(vals)
        s = torch.nanmean((vals - t).abs())
        return (x - t) / s.clamp(min=eps)

    diff = (norm(pred) - norm(target)).abs()
    return torch.where(m, diff, torch.zeros_like(diff)).sum() / m.sum().clamp(min=1)


def ransac_scale_shift(
    mde: np.ndarray,
    disp: np.ndarray,
    valid: np.ndarray,
    iters: int = 100,
    threshold: float = 2.0,
    seed: int = 0,
) -> tuple[float, float]:
    """RANSAC fit of disp ~= scale * mde + shift over the valid pixels
    (reference utils.py:28-87); host numpy."""
    rng = np.random.default_rng(seed)
    m = mde[valid > 0].ravel()
    d = disp[valid > 0].ravel()
    if m.size < 2:
        return 1.0, 0.0
    best_inliers = -1
    best = (1.0, 0.0)
    for _ in range(iters):
        i, j = rng.integers(0, m.size, 2)
        if abs(m[i] - m[j]) < 1e-9:
            continue
        s = (d[i] - d[j]) / (m[i] - m[j])
        t = d[i] - s * m[i]
        inl = np.abs(s * m + t - d) < threshold
        n = int(inl.sum())
        if n > best_inliers:
            best_inliers = n
            a = np.stack([m[inl], np.ones(n)], 1)
            sol, *_ = np.linalg.lstsq(a, d[inl], rcond=None)
            best = (float(sol[0]), float(sol[1]))
    return best
