"""Modulated deformable convolution (the JAX package's `models/dcn.py`; the
reference wraps torchvision's `deform_conv2d`).  Available as a layer, used
by no shipped model.

A k x k convolution whose taps sample the input at learned offsets: a
zero-initialised conv of the input gives, per output pixel and tap, a row
offset, a column offset and a modulation logit (channels [0, k^2), [k^2,
2k^2), [2k^2, 3k^2)).  Tap t = (i, j) of output pixel (y, x) samples the
input bilinearly at the absolute position (y*stride + i - padding + dy_t,
x*stride + j - padding + dx_t), zero outside the image, and weighs it by
2 * sigmoid(logit_t).

The JAX package samples through two dense tent contractions, which build a
(B, H', W', W, C) intermediate: fine at its test sizes, not on an image.
Here the sample is a gather of the four neighbouring pixels (NCHW), the
same function; the weighted taps then meet the kernel in one contraction.
The gather leaves the convolution path: a channels-last input (the stereo
stage's format) is copied to NCHW once, by `sample_bilinear`'s flattening,
and the module's weights are its own, contiguous.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def sample_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img (B,C,H,W) sampled at absolute coordinates ys, xs (B,H',W'), zero
    outside [0, H) x [0, W) -> (B,C,H',W')."""
    b, c, h, w = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    flat = img.reshape(b, c, h * w)
    out = 0
    for yi, wy in ((y0, 1 - wy1), (y0 + 1, wy1)):
        for xi, wx in ((x0, 1 - wx1), (x0 + 1, wx1)):
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(b, 1, -1).expand(b, c, -1)
            v = torch.gather(flat, 2, idx).reshape(b, c, *ys.shape[1:])
            out = out + v * (wy * wx * inside).unsqueeze(1).to(img.dtype)
    return out


class DeformableConv2d(nn.Module):
    """k x k modulated deformable conv over NCHW; `weight` (O, I, k, k) and
    `bias` as a conv's, `offset_modulator_conv` the offsets' conv (zero
    weights at init, so a fresh layer is a regular conv)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = False):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        taps = kernel_size * kernel_size
        self.offset_modulator_conv = nn.Conv2d(in_channels, 3 * taps, kernel_size, stride=stride, padding=padding)
        nn.init.zeros_(self.offset_modulator_conv.weight)
        nn.init.zeros_(self.offset_modulator_conv.bias)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        nn.init.kaiming_normal_(self.weight, mode="fan_out")
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, taps = self.kernel_size, self.kernel_size ** 2
        conv = self.offset_modulator_conv
        offs = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), self.stride, self.padding)
        oy, ox = offs[:, :taps].float(), offs[:, taps:2 * taps].float()
        mod = 2.0 * torch.sigmoid(offs[:, 2 * taps:])
        b, _, hp, wp = offs.shape
        base_y = (torch.arange(hp, device=x.device, dtype=torch.float32) * self.stride).view(1, hp, 1)
        base_x = (torch.arange(wp, device=x.device, dtype=torch.float32) * self.stride).view(1, 1, wp)
        sampled = []
        for t in range(taps):
            ys = base_y + (t // k - self.padding) + oy[:, t]
            xs = base_x + (t % k - self.padding) + ox[:, t]
            sampled.append(sample_bilinear(x, ys, xs) * mod[:, t:t + 1])
        taps_x = torch.stack(sampled, dim=2)  # (B, C, k*k, H', W')
        out = torch.einsum("bcthw,oct->bohw", taps_x, self.weight.to(x.dtype).reshape(*self.weight.shape[:2], taps))
        return out if self.bias is None else out + self.bias.to(x.dtype).view(1, -1, 1, 1)
