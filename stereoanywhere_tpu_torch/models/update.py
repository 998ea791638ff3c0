"""Iterative update block: motion encoder, 3-scale ConvGRU cascade, heads.

`refinement_step` is one GRU iteration of the test-mode loop (NCHW); the
JAX package's `nn.scan` over `RefinementStep` becomes a Python loop in the
stereo model.  The rotated schedule of `fused_level0="on"` (JAX
`FusedRefinementStep`) is built from three pieces: `update_nets`, the
un-rotated pre-step without the flow head (JAX `skip_flow_head`);
`fused_refinement_step`, the rotated body, NHWC, whose quarter-resolution
plane runs in the K7, K5, K8 and K9 kernels; and `refinement_tail`, the
flow head, mask head and coordinate update (JAX `tail_only`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.ops import step_fused as sf
from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair
from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import dual_lookup
from stereoanywhere_tpu_torch.ops.cuda.step_fused import conv_gru, flow_head, motion_encoder
from stereoanywhere_tpu_torch.ops.interp import interp_like, interp_like_nhwc, pool2x, pool2x_nhwc


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
        self._fused = {}

    def fused_weights(self, dtype: torch.dtype) -> sf.FusedWeights:
        """The weights in the layout of the rotated step's kernels, packed
        once per dtype and device and kept until the parameters are loaded
        anew (`load_state_dict`, `compat.from_jax.load_stereo_variables`)."""
        key = (dtype, self.flow_head.conv1.weight.device)
        if key not in self._fused:
            self._fused[key] = sf.FusedWeights(
                head=sf.pack_head_weights(self.flow_head.conv1, self.flow_head.conv2, dtype),
                motion=sf.pack_motion_weights(self.encoder, dtype),
                gru=tuple(sf.pack_gru_weights(g, dtype) for g in (self.gru08, self.gru16, self.gru32)),
            )
        return self._fused[key]

    def clear_fused_cache(self) -> None:
        self._fused.clear()

    def _load_from_state_dict(self, *args, **kwargs):
        self.clear_fused_cache()
        super()._load_from_state_dict(*args, **kwargs)

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


def update_nets(block: MultiUpdateBlock, net, inp, stereo_pyr, mono_pyr, coords1, coords0, radius: int,
                lookup_impl: str = "window"):
    """Look both pyramids up at coords1 (B,1,H,W) f32, encode the motion and
    run the cascade: a GRU iteration without its flow head (the JAX
    `skip_flow_head` pre-step).  net/inp/pyramids are in the compute dtype."""
    cdt = net[0].dtype
    stereo_corr, mono_corr = lookup_corr_pyramid_pair(stereo_pyr, mono_pyr, coords1[:, 0], radius, lookup_impl)
    stereo_corr = stereo_corr.permute(0, 3, 1, 2).to(cdt)
    mono_corr = mono_corr.permute(0, 3, 1, 2).to(cdt)
    flow_x = coords1 - coords0
    flow = torch.cat([flow_x, torch.zeros_like(flow_x)], dim=1).to(cdt)
    motion = block.encoder(flow, stereo_corr, mono_corr)
    return [n.to(cdt) for n in block.cascade(net, inp, motion)]


def refinement_tail(block: MultiUpdateBlock, net, coords1, compute_mask: bool):
    """Flow head, mask head and coordinate update (the JAX `tail_only`):
    returns (net, coords1 + delta-x, mask logits or None)."""
    delta_x = block.flow_head.forward_x(net[0])
    mask = 0.25 * block.mask(net[0]) if compute_mask else None
    return net, coords1 + delta_x.float(), mask


def refinement_step(block: MultiUpdateBlock, net, inp, stereo_pyr, mono_pyr, coords1, coords0, radius: int,
                    compute_mask: bool, lookup_impl: str = "window"):
    """One GRU iteration of the test-mode loop (the JAX `RefinementStep`):
    look both pyramids up at coords1 (B,1,H,W) f32, run the update block, move
    coords1 by the x-delta.  net/inp/pyramids are in the compute dtype.
    Returns (net, coords1, mask logits or None)."""
    net = update_nets(block, net, inp, stereo_pyr, mono_pyr, coords1, coords0, radius, lookup_impl)
    return refinement_tail(block, net, coords1, compute_mask)


def fused_refinement_step(ws: sf.FusedWeights, net, czrq, stereo_pyr, mono_pyr, coords1: torch.Tensor, radius: int):
    """The rotated body of the fused loop (JAX `FusedRefinementStep`):

        coords += flow_head(net0)                      K7
        corr = lookup(coords), both pyramids           K5
        net2 = gru32(net2, pool(net1))                 K9
        net1 = gru16(net1, pool(net0), interp(net2))   K9
        motion = encoder(corr, coords - coords0)       K8
        net0 = gru08(net0, motion, interp(net1))       K9

    net: the three hidden states, NHWC in the compute dtype; czrq: each
    scale's context injections [cz | cr | cq], NHWC; coords1 (B,H4,W4) f32,
    the x-coordinate.  Returns (net, coords1)."""
    coords1 = flow_head(net[0], coords1, ws.head)
    corr_a, corr_b = dual_lookup(stereo_pyr, mono_pyr, coords1, radius)
    net = list(net)
    net[2] = conv_gru(net[2], [pool2x_nhwc(net[1])], czrq[2], ws.gru[2])
    net[1] = conv_gru(net[1], [pool2x_nhwc(net[0]), interp_like_nhwc(net[2], net[1])], czrq[1], ws.gru[1])
    xup = interp_like_nhwc(net[1], net[0])
    motion = motion_encoder(corr_a, corr_b, coords1, ws.motion)
    net[0] = conv_gru(net[0], [motion, xup], czrq[0], ws.gru[0])
    return net, coords1
