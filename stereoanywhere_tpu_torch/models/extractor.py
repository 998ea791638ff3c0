"""Feature and context encoders (reference BasicEncoder / MultiBasicEncoder).

(B,C,H,W) tensors, held in memory as the stereo stage holds them
(`models/layers.py`; channels-last on the card): channels-last inputs and
weights give channels-last outputs, which every norm and residual sum
keeps.

Every convolution goes through `row_conv` / `conv_rows`: on a rank's rows
with its neighbours' halos when a row group is active (`parallel/halo.py`)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.models.layers import BatchNorm, ResidualBlock, instance_norm
from stereoanywhere_tpu_torch.parallel.halo import conv_rows, row_conv


class FeatureEncoder(nn.Module):
    """fnet: instance norm, 256 channels at 1/4 resolution.  Both views run
    as one doubled batch."""

    def __init__(self, output_dim: int = 256, downsample: int = 2):
        super().__init__()
        d = downsample
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1 + (d > 2), padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, "instance", 1), ResidualBlock(64, 64, "instance", 1))
        self.layer2 = nn.Sequential(
            ResidualBlock(64, 96, "instance", 1 + (d > 1)), ResidualBlock(96, 96, "instance", 1)
        )
        self.layer3 = nn.Sequential(
            ResidualBlock(96, 128, "instance", 1 + (d > 0)), ResidualBlock(128, 128, "instance", 1)
        )
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(row_conv(self.conv1, x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return row_conv(self.conv2, x)


class ContextEncoder(nn.Module):
    """cnet: batch norm, two heads at each of 1/4, 1/8, 1/16.

    It reads the left mono depth that the reference replicates to 3
    channels; given one channel, conv1 runs with its kernel summed over the
    input channels, which is the same convolution on a third of the work.
    Returns ((h04, x04), (h08, x08), (h16, x16)) raw head outputs.
    """

    def __init__(self, output_dims: Sequence[Sequence[int]] = ((128,) * 3, (128,) * 3), downsample: int = 2):
        super().__init__()
        d = downsample
        self.stride1 = 1 + (d > 2)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=self.stride1, padding=3)
        self.norm1 = BatchNorm(64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, "batch", 1), ResidualBlock(64, 64, "batch", 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, "batch", 1 + (d > 1)), ResidualBlock(96, 96, "batch", 1))
        self.layer3 = nn.Sequential(
            ResidualBlock(96, 128, "batch", 1 + (d > 0)), ResidualBlock(128, 128, "batch", 1)
        )
        self.layer4 = nn.Sequential(ResidualBlock(128, 128, "batch", 2), ResidualBlock(128, 128, "batch", 1))
        self.layer5 = nn.Sequential(ResidualBlock(128, 128, "batch", 2), ResidualBlock(128, 128, "batch", 1))
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "batch", 1), nn.Conv2d(128, dims[2], 3, padding=1))
            for dims in output_dims
        )
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "batch", 1), nn.Conv2d(128, dims[1], 3, padding=1))
            for dims in output_dims
        )
        self.outputs32 = nn.ModuleList(nn.Conv2d(128, dims[0], 3, padding=1) for dims in output_dims)

    def forward(self, x: torch.Tensor):
        if x.shape[1] == 1:
            w = self.conv1.weight.sum(dim=1, keepdim=True)
            x = conv_rows(x, w, self.conv1.bias, self.stride1, 3)
        else:
            x = row_conv(self.conv1, x)
        x = F.relu(self.norm1(x))
        x = self.layer3(self.layer2(self.layer1(x)))
        head = lambda h, t: row_conv(h[1], h[0](t))  # noqa: E731  (ResidualBlock, Conv2d)
        outs04 = tuple(head(h, x) for h in self.outputs08)
        y = self.layer4(x)
        outs08 = tuple(head(h, y) for h in self.outputs16)
        z = self.layer5(y)
        outs16 = tuple(row_conv(h, z) for h in self.outputs32)
        return outs04, outs08, outs16
