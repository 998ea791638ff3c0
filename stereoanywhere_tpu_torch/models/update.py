"""Iterative update block: motion encoder, 3-scale ConvGRU cascade, heads (NCHW).

`MultiUpdateBlock.step` is one GRU iteration of the test-mode loop; the
JAX package's `nn.scan` over `RefinementStep` becomes a Python loop in the
stereo model.  The fused (Pallas) refinement variants are not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid
from stereoanywhere_tpu_torch.ops.interp import interp_like, pool2x


class ConvGRU(nn.Module):
    """Conv GRU with precomputed context injections (cz, cr, cq)."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        p = kernel_size // 2
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hd = h.shape[1]
        # z and r read the same [h, x]: one conv with both kernels stacked
        zr = F.conv2d(
            torch.cat([h, x], dim=1),
            torch.cat([self.convz.weight, self.convr.weight]),
            torch.cat([self.convz.bias, self.convr.bias]),
            padding=self.convz.padding,
        )
        z = torch.sigmoid(zr[:, :hd] + cz)
        r = torch.sigmoid(zr[:, hd:] + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class MotionEncoder(nn.Module):
    """Stereo correlation + mono correlation + flow -> 128 motion channels.
    convc1/convc2 are shared by the two correlation streams."""

    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self._conv = nn.Conv2d(64 * 3, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, corr_mono):
        b = corr.shape[0]
        both = F.relu(self.convc2(F.relu(self.convc1(torch.cat([corr, corr_mono], dim=0)))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self._conv(torch.cat([both[:b], both[b:], flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    """conv-relu-conv head; only the x component of its output is used."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, output_dim, 3, padding=1)

    def forward_x(self, x):
        """The x-delta alone: conv2 restricted to its first output channel
        (the reference zeroes the y component)."""
        y = F.relu(self.conv1(x))
        return F.conv2d(y, self.conv2.weight[:1], self.conv2.bias[:1], padding=1)


class MultiUpdateBlock(nn.Module):
    """3-level GRU cascade with cross-scale pooling / interpolation."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 n_downsample: int = 2, corr_channels: int = 36):
        super().__init__()
        hd = tuple(hidden_dims)
        self.n_gru_layers = n_gru_layers
        self.encoder = MotionEncoder(corr_channels)
        self.gru08 = ConvGRU(hd[2], 128 + hd[1] * (n_gru_layers > 1))
        self.gru16 = ConvGRU(hd[1], hd[0] * (n_gru_layers == 3) + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.flow_head = FlowHead(hd[2], 256, 2)
        factor = 2 ** n_downsample
        self.mask = nn.Sequential(
            nn.Conv2d(hd[2], 256, 3, padding=1), nn.ReLU(inplace=True), nn.Conv2d(256, factor * factor * 9, 1)
        )

    def cascade(self, net, inp, motion):
        net = list(net)
        n = self.n_gru_layers
        if n == 3:
            net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        if n >= 2:
            if n > 2:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]), interp_like(net[2], net[1]))
            else:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]))
        if n > 1:
            net[0] = self.gru08(net[0], *inp[0], motion, interp_like(net[1], net[0]))
        else:
            net[0] = self.gru08(net[0], *inp[0], motion)
        return net

    def step(self, net, inp, corr, corr_mono, flow, compute_mask: bool):
        """One iteration: returns (net, delta_x (B,1,H,W), mask logits or None)."""
        motion = self.encoder(flow, corr, corr_mono)
        net = self.cascade(net, inp, motion)
        delta_x = self.flow_head.forward_x(net[0])
        mask = 0.25 * self.mask(net[0]) if compute_mask else None
        return net, delta_x, mask


def refinement_step(block: MultiUpdateBlock, net, inp, stereo_pyr, mono_pyr, coords1, coords0, radius: int,
                    compute_mask: bool):
    """One GRU iteration of the test-mode loop (the JAX `RefinementStep`):
    look both pyramids up at coords1 (B,1,H,W) f32, run the update block, move
    coords1 by the x-delta.  net/inp/pyramids are in the compute dtype.
    Returns (net, coords1, mask logits or None)."""
    cdt = net[0].dtype
    x = coords1[:, 0]
    stereo_corr = lookup_corr_pyramid(stereo_pyr, x, radius).permute(0, 3, 1, 2).to(cdt)
    mono_corr = lookup_corr_pyramid(mono_pyr, x, radius).permute(0, 3, 1, 2).to(cdt)
    flow_x = coords1 - coords0
    flow = torch.cat([flow_x, torch.zeros_like(flow_x)], dim=1).to(cdt)
    net, delta_x, mask = block.step(net, inp, stereo_corr, mono_corr, flow, compute_mask)
    return [n.to(cdt) for n in net], coords1 + delta_x.float(), mask
