"""Lightweight feature extractors: MobileNet trunks with an FPN-style
`Conv2x` decoder, and the single-feature gate `FeatureAtt` (the JAX
package's `models/mobile_extractors.py`; the reference's `Feature`,
`FeatureV4`, `Conv2x`, `FeatureAtt`).  The reference builds them and its
shipped model does not use them.

There are no weights to load: the reference takes ImageNet weights from
timm, and the JAX package re-implements the published architectures with
its own names.  The modules here carry those names (`backbone.block2_0.
pw_exp`, `deconv32_16.conv1.conv`, ...), so `compat.from_jax`
`load_module_variables` carries a JAX tree's params and batch statistics
across.

- MobileNetV2-1.0: inverted residuals (1x1 expand + BN + ReLU6, 3x3
  depthwise + BN + ReLU6, 1x1 project + BN, identity skip at stride 1 and
  equal widths), stages (t, c, n, s) = (1,16,1,1) (6,24,2,2) (6,32,3,2)
  (6,64,4,2) (6,96,3,1) (6,160,3,2), grouped as the reference splits them.
- MobileNetV4-Conv-S: a conv stem, two fused conv stages, universal
  inverted bottlenecks, and the first block of the /32 stage only.

NCHW, with contiguous weights: `StereoAnywhere` does not build these
modules, so the stereo stage's channels-last weights
(`layers.channels_last_weights`) do not reach them, and their grouped
convolutions, which `row_conv` refuses, run as PyTorch gives them.
BatchNorm runs on its running statistics, and on the batch's with
`train=True` (updating the running statistics as flax does).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.models.layers import BasicConv, BatchNorm
from stereoanywhere_tpu_torch.ops.interp import resize_jax_image


def _bn(norm: BatchNorm, x: torch.Tensor, train: bool) -> torch.Tensor:
    norm.batch_statistics = train
    try:
        return norm(x)
    finally:
        norm.batch_statistics = False


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=bias)


class ConvBnAct(nn.Module):
    """conv -> BatchNorm -> ReLU6 / ReLU / nothing."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1, act: str = "relu6"):
        super().__init__()
        if act not in ("relu6", "relu", "none"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.conv = _conv(cin, features, kernel_size, stride)
        self.bn = BatchNorm(features)

    def forward(self, x, train: bool = False):
        x = _bn(self.bn, self.conv(x), train)
        return _relu6(x) if self.act == "relu6" else F.relu(x) if self.act == "relu" else x


class InvertedResidual(nn.Module):
    """MobileNetV2's inverted residual bottleneck."""

    def __init__(self, cin: int, features: int, stride: int = 1, expand: int = 6):
        super().__init__()
        self.skip = stride == 1 and cin == features
        mid = cin * expand
        if expand != 1:
            self.pw_exp = _conv(cin, mid, 1)
            self.bn_exp = BatchNorm(mid)
        self.dw = _conv(mid, mid, 3, stride, groups=mid)
        self.bn_dw = BatchNorm(mid)
        self.pw_proj = _conv(mid, features, 1)
        self.bn_proj = BatchNorm(features)

    def forward(self, x, train: bool = False):
        h = x
        if hasattr(self, "pw_exp"):
            h = _relu6(_bn(self.bn_exp, self.pw_exp(h), train))
        h = _relu6(_bn(self.bn_dw, self.dw(h), train))
        h = _bn(self.bn_proj, self.pw_proj(h), train)
        return h + x if self.skip else h


class UniversalInvertedResidual(nn.Module):
    """MobileNetV4's universal inverted bottleneck: an optional start
    depthwise (no activation), 1x1 expand + BN + ReLU, an optional middle
    depthwise + BN + ReLU, 1x1 project + BN.  Kernel 0 leaves a depthwise
    out; the middle one carries the stride when it exists, else the start
    one."""

    def __init__(self, cin: int, features: int, dw_start: int = 0, dw_mid: int = 3, stride: int = 1,
                 expand: float = 4.0):
        super().__init__()
        self.skip = stride == 1 and cin == features
        mid = int(round(cin * expand))
        if dw_start:
            self.dw_start = _conv(cin, cin, dw_start, stride if dw_mid == 0 else 1, groups=cin)
            self.bn_start = BatchNorm(cin)
        self.pw_exp = _conv(cin, mid, 1)
        self.bn_exp = BatchNorm(mid)
        if dw_mid:
            self.dw_mid = _conv(mid, mid, dw_mid, stride, groups=mid)
            self.bn_mid = BatchNorm(mid)
        self.pw_proj = _conv(mid, features, 1)
        self.bn_proj = BatchNorm(features)

    def forward(self, x, train: bool = False):
        h = x
        if hasattr(self, "dw_start"):
            h = _bn(self.bn_start, self.dw_start(h), train)
        h = F.relu(_bn(self.bn_exp, self.pw_exp(h), train))
        if hasattr(self, "dw_mid"):
            h = F.relu(_bn(self.bn_mid, self.dw_mid(h), train))
        h = _bn(self.bn_proj, self.pw_proj(h), train)
        return h + x if self.skip else h


@functools.lru_cache(maxsize=None)
def _jax_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """`jax.image.resize`'s nearest source index: floor((i + 0.5) * in /
    out), in f32 as JAX computes it."""
    pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size) / np.float32(out_size)
    return np.floor(pos.astype(np.float32)).astype(np.int64)


def resize_nearest_jax(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` over the last two axes."""
    for axis, n in zip((-2, -1), out_hw):
        if x.shape[axis] != n:
            idx = torch.from_numpy(_jax_nearest_index(x.shape[axis], n)).to(x.device)
            x = torch.index_select(x, x.ndim + axis, idx)
    return x


class Conv2x(nn.Module):
    """Upsample (transposed conv k4 s2) or downsample (conv k3 s2), nearest
    to the skip's size if it differs, then concatenate with the skip and
    refine to 2 x features (`concat`), or add it and refine to features."""

    def __init__(self, cin: int, features: int, skip_channels: int | None = None, deconv: bool = False,
                 concat: bool = True):
        super().__init__()
        self.concat = concat
        k = 4 if deconv else 3
        self.conv1 = BasicConv(cin, features, kernel_size=k, stride=2, padding=1, deconv=deconv)
        skip = features if skip_channels is None else skip_channels
        self.conv2 = (BasicConv(features + skip, features * 2) if concat else BasicConv(features, features))

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[-2:] != rem.shape[-2:]:
            x = resize_nearest_jax(x, tuple(rem.shape[-2:]))
        return self.conv2(torch.cat([x, rem], dim=1) if self.concat else x + rem)


class FeatureAtt(nn.Module):
    """Gate a cost volume (B,C,D,H,W) by sigmoid(attention of a feature map
    (B,Cf,H,W)), broadcast over D."""

    def __init__(self, cv_features: int, feat_channels: int):
        super().__init__()
        self.feat_att_0 = BasicConv(feat_channels, feat_channels // 2, kernel_size=1, padding=0)
        self.feat_att_1 = nn.Conv2d(feat_channels // 2, cv_features, 1)

    def forward(self, cv, feat):
        return torch.sigmoid(self.feat_att_1(self.feat_att_0(feat))).unsqueeze(2) * cv


class MobileNetV2Backbone(nn.Module):
    """MobileNetV2-1.0's trunk, returning its /2, /4, /8, /16 and /32 maps
    (16, 24, 32, 96 and 160 channels)."""

    STAGES = (("block1", 24, (2, 1), 0), ("block2", 32, (2, 1, 1), 0), ("block3", 64, (2, 1, 1, 1), 0),
              ("block3", 96, (1, 1, 1), 4), ("block4", 160, (2, 1, 1), 0))

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv_stem = ConvBnAct(in_channels, 32, 3, 2)
        self.block0_0 = InvertedResidual(32, 16, 1, 1)
        cin = 16
        for name, c, strides, first in self.STAGES:
            for j, s in enumerate(strides):
                setattr(self, f"{name}_{first + j}", InvertedResidual(cin, c, s, 6))
                cin = c

    def _stage(self, x, name, n, first, train):
        for j in range(n):
            x = getattr(self, f"{name}_{first + j}")(x, train)
        return x

    def forward(self, x, train: bool = False):
        x2 = self.block0_0(self.conv_stem(x, train), train)
        x4 = self._stage(x2, "block1", 2, 0, train)
        x8 = self._stage(x4, "block2", 3, 0, train)
        x16 = self._stage(self._stage(x8, "block3", 4, 0, train), "block3", 3, 4, train)
        x32 = self._stage(x16, "block4", 3, 0, train)
        return x2, x4, x8, x16, x32


class Feature(nn.Module):
    """MobileNetV2 trunk and Conv2x decoder: [x4, x8, x16, x32] with 48, 64,
    192 and 160 channels."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.backbone = MobileNetV2Backbone(in_channels)
        self.deconv32_16 = Conv2x(160, 96, 96, deconv=True)
        self.deconv16_8 = Conv2x(192, 32, 32, deconv=True)
        self.deconv8_4 = Conv2x(64, 24, 24, deconv=True)
        self.conv4 = BasicConv(48, 48)

    def forward(self, x, train: bool = False):
        _, x4, x8, x16, x32 = self.backbone(x, train)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


class MobileNetV4SmallBackbone(nn.Module):
    """MobileNetV4-Conv-S's trunk through the first /32 block: /2 32, /4 32,
    /8 64, /16 96 and /32 128 channels."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv_stem = ConvBnAct(in_channels, 32, 3, 2, act="relu")
        self.block0_0 = ConvBnAct(32, 32, 3, 2, act="relu")
        self.block0_1 = ConvBnAct(32, 32, 1, 1, act="relu")
        self.block1_0 = ConvBnAct(32, 96, 3, 2, act="relu")
        self.block1_1 = ConvBnAct(96, 64, 1, 1, act="relu")
        self.block2_0 = UniversalInvertedResidual(64, 96, 5, 5, 2, 3.0)
        for j in range(1, 5):
            setattr(self, f"block2_{j}", UniversalInvertedResidual(96, 96, 0, 3, 1, 2.0))
        self.block2_5 = UniversalInvertedResidual(96, 96, 3, 0, 1, 4.0)
        self.block3_0 = UniversalInvertedResidual(96, 128, 3, 3, 2, 6.0)

    def forward(self, x, train: bool = False):
        x2 = self.conv_stem(x, train)
        x4 = self.block0_1(self.block0_0(x2, train), train)
        x8 = self.block1_1(self.block1_0(x4, train), train)
        x16 = x8
        for j in range(6):
            x16 = getattr(self, f"block2_{j}")(x16, train)
        return x2, x4, x8, x16, self.block3_0(x16, train)


class FeatureV4(nn.Module):
    """A 1x1 mapping conv to 3 channels, the MobileNetV4-Conv-S trunk and a
    Conv2x decoder down to 1/2^n_downsample: n 3 -> [x8, x16, x32], 2 ->
    [x4, ...], 1 -> [x2, ...], 0 -> a bilinear x1 first (`jax.image.resize`'s)."""

    def __init__(self, img_channels: int = 3, n_downsample: int = 2):
        super().__init__()
        if n_downsample not in (0, 1, 2, 3):
            raise ValueError(f"n_downsample {n_downsample}: one of 0, 1, 2, 3")
        self.n_downsample = n_downsample
        self.mapping_conv = nn.Conv2d(img_channels, 3, 1)
        self.backbone = MobileNetV4SmallBackbone(3)
        self.deconv32_16 = Conv2x(128, 96, 96, deconv=True)
        self.deconv16_8 = Conv2x(192, 64, 64, deconv=True)
        if n_downsample == 3:
            self.final_conv = BasicConv(128, 128)
        else:
            self.deconv8_4 = Conv2x(128, 32, 32, deconv=True)
            if n_downsample < 2:
                self.deconv4_2 = Conv2x(64, 32, 32, deconv=True)
            self.final_conv = BasicConv(64, 64)

    def forward(self, x, train: bool = False):
        x2, x4, x8, x16, x32 = self.backbone(self.mapping_conv(x), train)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        if self.n_downsample == 3:
            return [self.final_conv(x8), x16, x32]
        x4 = self.deconv8_4(x8, x4)
        if self.n_downsample == 2:
            return [self.final_conv(x4), x8, x16, x32]
        x2 = self.final_conv(self.deconv4_2(x4, x2))
        if self.n_downsample == 1:
            return [x2, x4, x8, x16, x32]
        x1 = resize_jax_image(x2, (x2.shape[-2] * 2, x2.shape[-1] * 2), "bilinear")
        return [x1, x2, x4, x8, x16, x32]
