"""Cost-volume ops: all-pairs correlation, depth-bin masks, soft-argmax
disparity, entropy confidence, mirror detection and truncation.

Volumes are (B, H, W2, W3) as in the JAX package: left pixel axis W2, right
(disparity hypothesis) axis W3 last.  Per-pixel maps are (B, 1, H, W), and
feature maps (B, C, H, W), channels-last in the card's stereo stage.
"""
from __future__ import annotations

import math

import torch

from stereoanywhere_tpu_torch.ops.fuzzy import fuzzy_and, fuzzy_not, fuzzy_or


def all_pairs_correlation(feat_left: torch.Tensor, feat_right: torch.Tensor) -> torch.Tensor:
    """feat_left (B,C,H,W2), feat_right (B,C,H,W3) -> (B,H,W2,W3), scaled by
    1/sqrt(C): one batched matmul over (B,H), accumulated in f32.  For
    channels-last maps both operands are views: (B,H,W2,C) and its
    transposed (B,H,C,W3)."""
    c = feat_left.shape[1]
    lf = feat_left.permute(0, 2, 3, 1).float()  # (B,H,W2,C)
    rf = feat_right.permute(0, 2, 1, 3).float()  # (B,H,C,W3)
    vol = torch.matmul(lf, rf)
    return (vol / math.sqrt(c)).to(feat_left.dtype)


def generate_masks(mde: torch.Tensor, n: int) -> torch.Tensor:
    """N one-hot depth-bin masks (B,N,H,W) from mde (B,1,H,W) in [0,1]:
    mask_i = [i/N <= mde < (i+1)/N]."""
    edges = (torch.arange(n, device=mde.device, dtype=mde.dtype) / n).view(1, n, 1, 1)
    return ((mde >= edges) & (mde < edges + 1.0 / n)).to(mde.dtype)


def masked_volume(volume: torch.Tensor, left_masks: torch.Tensor, right_masks: torch.Tensor) -> torch.Tensor:
    """Mask the volume per depth bin, emitted in the hourglass layout:
    (B,H,W2,W3) x (B,N,H,W2) x (B,N,H,W3) -> (B,N,W3,H,W2)."""
    vol = volume.permute(0, 3, 1, 2).unsqueeze(1)  # (B,1,W3,H,W2)
    lm = left_masks.unsqueeze(2)  # (B,N,1,H,W2)
    rm = right_masks.permute(0, 1, 3, 2).unsqueeze(-1)  # (B,N,W3,H,1)
    return vol * lm * rm


def _softmax_expectation(volume: torch.Tensor, dim: int) -> torch.Tensor:
    prob = torch.softmax(volume, dim=dim)
    shape = [1] * volume.ndim
    shape[dim] = volume.shape[dim]
    idx = torch.arange(volume.shape[dim], device=volume.device, dtype=volume.dtype).view(shape)
    return torch.sum(prob * idx, dim=dim)


def estimate_left_disparity(volume: torch.Tensor) -> torch.Tensor:
    """(B,H,W2,W3) -> (B,1,H,W2): x2 - E_softmax[x3]."""
    exp_x3 = _softmax_expectation(volume, 3)
    xs = torch.arange(volume.shape[2], device=volume.device, dtype=volume.dtype)
    return (xs - exp_x3).unsqueeze(1)


def estimate_right_disparity(volume: torch.Tensor) -> torch.Tensor:
    """(B,H,W2,W3) -> (B,1,H,W3): E_softmax[x2] - x3."""
    exp_x2 = _softmax_expectation(volume, 2)
    xs = torch.arange(volume.shape[3], device=volume.device, dtype=volume.dtype)
    return (exp_x2 - xs).unsqueeze(1)


def _entropy_confidence(volume: torch.Tensor, dim: int) -> torch.Tensor:
    prob = torch.softmax(volume, dim=dim)
    ent = -torch.sum(prob * torch.log2(prob + 1e-6), dim=dim)
    return 1.0 - ent / math.log2(volume.shape[dim])


def estimate_left_confidence(volume: torch.Tensor) -> torch.Tensor:
    """1 - normalized entropy over W3 -> (B,1,H,W2)."""
    return _entropy_confidence(volume, 3).unsqueeze(1)


def estimate_right_confidence(volume: torch.Tensor) -> torch.Tensor:
    """1 - normalized entropy over W2 -> (B,1,H,W3)."""
    return _entropy_confidence(volume, 2).unsqueeze(1)


def gauss_corr_volume(disp_left: torch.Tensor, gauss_k: float | torch.Tensor = 10.0,
                      gauss_c: float = 1.0) -> torch.Tensor:
    """Synthetic Gaussian volume (B,H,W2,W3) peaked at x3 = x2 - disp;
    disp_left (B,1,H,W)."""
    w = disp_left.shape[-1]
    xs = torch.arange(w, device=disp_left.device, dtype=disp_left.dtype)
    center = xs.view(1, 1, w, 1) - disp_left[:, 0, :, :, None]  # (B,H,W2,1): the matched x3
    delta = center - xs.view(1, 1, 1, w)
    return gauss_k * torch.exp(-(delta ** 2) / (2 * gauss_c ** 2))


def truncate_corr_volume(
    disp_left: torch.Tensor,
    conf_left: torch.Tensor,
    conf_th: float | None = None,
    attenuation_gain: float = 0.1,
) -> torch.Tensor:
    """Multiplicative mask (B,H,W2,W3) attenuating the cells behind the
    mono surface where conf_left is high; disp_left, conf_left (B,1,H,W)."""
    w = disp_left.shape[-1]
    xs = torch.arange(w, device=disp_left.device, dtype=disp_left.dtype)
    conf = conf_left[:, 0, :, :, None]  # (B,H,W2,1)
    if conf_th is not None:
        conf = (conf > conf_th).to(disp_left.dtype)
    center = xs.view(1, 1, w, 1) - disp_left[:, 0, :, :, None]  # (B,H,W2,1)
    ramp = center - xs.view(1, 1, 1, w)
    att = torch.sigmoid(ramp) * (1.0 - attenuation_gain) + attenuation_gain
    return (1.0 - conf) + conf * att


def handcrafted_mirror_detector(
    stereo_disp: torch.Tensor,
    mono_disp: torch.Tensor,
    stereo_conf: torch.Tensor,
    mono_conf: torch.Tensor,
    conf_th: float = 0.5,
    step_gain: float = 20.0,
) -> torch.Tensor:
    """Fuzzy mirror detector: (mono >> stereo AND both confident) OR
    (mono confident AND NOT stereo confident), through sigmoid gates."""
    both_conf = fuzzy_and(stereo_conf, mono_conf)
    mono_near = torch.sigmoid(step_gain * (mono_disp - stereo_disp))
    mono_better_a = fuzzy_and(both_conf, mono_near)
    mono_better_b = fuzzy_and(fuzzy_not(stereo_conf), mono_conf)
    mono_better = fuzzy_or(mono_better_a, mono_better_b)
    return torch.sigmoid(step_gain * (mono_better - conf_th))
