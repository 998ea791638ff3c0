"""Depth-Anything-V2: DINOv2 backbone + DPT head, in PyTorch.

Module and parameter names follow the reference (`pretrained.*`,
`depth_head.projects.*`, `depth_head.scratch.*`).  The head's final
upsample is half-pixel bilinear without antialiasing followed by the plain
3x3 / 1x1 output convs (the JAX package fuses the 3x3 into the resize on
accelerators; the sums are the same).  The refinenet4 `resConfUnit1` of the
reference never runs and is not built.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.config import MonoConfig
from stereoanywhere_tpu_torch.device import device_constant, resolve_device
from stereoanywhere_tpu_torch.models.dinov2 import VIT_CONFIGS, DinoVisionTransformer
from stereoanywhere_tpu_torch.models.layers import init_weights
from stereoanywhere_tpu_torch.ops.interp import (
    resize_bicubic_halfpix, resize_bilinear_align_corners, resize_bilinear_halfpix)
from stereoanywhere_tpu_torch.utils.profiling import span

INTERMEDIATE_LAYER_IDX = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
    "vitg": (9, 19, 29, 39),
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(resize_bilinear_align_corners(x, tuple(size)))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int]):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, with_skip=i != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(True), nn.Conv2d(32, 1, 1), nn.ReLU(True)
        )


class DPTHead(nn.Module):
    def __init__(self, in_dim: int, features: int = 256, out_channels: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        oc = tuple(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(in_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(features, oc)

    def forward(self, layer_feats, patch_h: int, patch_w: int):
        outs = []
        for i, (tokens, _cls) in enumerate(layer_feats):
            x = tokens.transpose(1, 2).reshape(tokens.shape[0], tokens.shape[2], patch_h, patch_w)
            outs.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(o) for i, o in enumerate(outs))
        p4 = s.refinenet4(l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        out = s.output_conv1(p1)
        out = resize_bilinear_halfpix(out, (patch_h * 14, patch_w * 14))
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    """ImageNet-normalized NHWC image (H, W multiples of 14) -> relative
    inverse depth (B, H, W, 1).  `device` defaults to the card and raises
    without one unless "cpu" is asked for; weights are random from
    `generator` (default seed 0) until loaded.

    ViT-S/B/L draw their weights on the CPU from `generator` and are copied
    to `device` in `dtype`.  ViT-G (1.1 B parameters, 4.4 GB in f32) is
    built in place: its parameters are allocated on `device` in `dtype` and
    drawn there, from a generator on that device seeded with `generator`'s
    seed, so no host copy of the model is made; its weights therefore
    depend on the device's random number generator."""

    def __init__(
        self,
        cfg: MonoConfig = MonoConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        vit = VIT_CONFIGS[cfg.encoder]
        in_place = cfg.encoder == "vitg"
        with torch.device("meta" if in_place else "cpu"):
            self.pretrained = DinoVisionTransformer(vit["embed_dim"], vit["depth"], vit["num_heads"],
                                                    ffn_layer=vit.get("ffn_layer", "mlp"))
            self.depth_head = DPTHead(vit["embed_dim"], cfg.features, cfg.out_channels)
        generator = generator or torch.Generator().manual_seed(0)
        if in_place:
            self.to(dtype=dtype).to_empty(device=dev)
            if generator.device != dev:
                generator = torch.Generator(device=dev).manual_seed(generator.initial_seed())
            init_weights(self, generator)
        else:
            init_weights(self, generator)
            self.to(device=dev, dtype=dtype)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.depth_head.projects[0].weight.dtype
        ph, pw = x.shape[1] // 14, x.shape[2] // 14
        with span("sa.mono.vit"):
            feats = self.pretrained(x.permute(0, 3, 1, 2).to(dt), INTERMEDIATE_LAYER_IDX[self.cfg.encoder])
        with span("sa.mono.dpt"):
            return self.depth_head(feats, ph, pw).permute(0, 2, 3, 1)


def imagenet_normalize(image01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC -> ImageNet-normalized."""
    mean, std = device_constant(_imagenet_stats, (), image01.device, image01.dtype)
    return (image01 - mean) / std


def _imagenet_stats() -> np.ndarray:
    return np.array([IMAGENET_MEAN, IMAGENET_STD], np.float32)


def dav2_input_size(h: int, w: int, input_size_width: int = 518, input_size_height: int = 518) -> tuple[int, int]:
    """Keep-aspect 'lower_bound' multiple-of-14 resize target (final_h, final_w);
    the target sides swap when h > w."""
    if h > w:
        input_size_width, input_size_height = input_size_height, input_size_width
    scale_h = input_size_height / h
    scale_w = input_size_width / w
    if scale_w > scale_h:
        scale_h = scale_w
    else:
        scale_w = scale_h

    def constrain(x, min_val):
        y = int(np.round(x / 14) * 14)
        if y < min_val:
            y = int(np.ceil(x / 14) * 14)
        return y

    return constrain(scale_h * h, input_size_height), constrain(scale_w * w, input_size_width)


def infer_mono_depth(model: DepthAnythingV2, image01: torch.Tensor, input_size_width: int = 518,
                     input_size_height: int = 518) -> torch.Tensor:
    """The reference's `infer_image` (its `dpt.py:188-238`), as the JAX
    package's `infer_mono_depth`: (B,H,W,3) in [0,1] -> (B,H,W,1) f32 depth.
    Bicubic (a=-0.75, half-pixel, no antialias) to `dav2_input_size`,
    ImageNet normalisation, DAv2 (in its weights' dtype), then half-pixel
    bilinear back to (H, W)."""
    _, h, w, _ = image01.shape
    fh, fw = dav2_input_size(h, w, input_size_width, input_size_height)
    x = resize_bicubic_halfpix(image01.permute(0, 3, 1, 2), (fh, fw)).permute(0, 2, 3, 1)
    depth = model(imagenet_normalize(x)).float().permute(0, 3, 1, 2)
    return resize_bilinear_halfpix(depth, (h, w)).permute(0, 2, 3, 1)
