"""Iterative update block: motion encoder, 3-scale ConvGRU cascade, heads.

`refinement_step` is one GRU iteration of the test-mode loop, on (B,C,H,W)
tensors held in the stereo stage's format (channels-last on the card):
every convolution, concatenation along C, pooling and resize here keeps
the format, and the lookups' (B,H,W,C) results are channels-last views.
The JAX package's `nn.scan` over `RefinementStep` becomes a Python loop
in the stereo model.  The rotated schedule of `fused_level0="on"` (JAX
`FusedRefinementStep`) is built from three pieces: `update_nets`, the
un-rotated pre-step without the flow head (JAX `skip_flow_head`);
`fused_refinement_step`, the rotated body, NHWC (the channels-last states
seen as (B,H,W,C), which costs no copy), whose quarter-resolution plane
runs in the K7, K5, K8 and K9 kernels; and `refinement_tail`, the
flow head, mask head and coordinate update (JAX `tail_only`).

The unfused modules' convolutions go through `row_conv` / `conv_rows`: on
a rank's rows with its neighbours' halos when a row group is active
(`parallel/halo.py`).  The fused kernels read neighbouring rows inside one
launch (K7 two, K8 five, K9 two), so under a row group each launch runs
unchanged on a band: the rank's rows widened by that radius with its
neighbours' rows, up to the image's edges and no further (the kernel's own
zero padding is then the image's there), and the widened rows, which the
band's inner edges spoil, are dropped (`on_band`).  K5 reads along W only.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import channels_last_format
from stereoanywhere_tpu_torch.ops import step_fused as sf
from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair
from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import DualPyramid, dual_lookup
from stereoanywhere_tpu_torch.ops.cuda.step_fused import conv_gru, flow_head, motion_encoder
from stereoanywhere_tpu_torch.ops.interp import interp_like, interp_like_nhwc, pool2x, pool2x_nhwc
from stereoanywhere_tpu_torch.parallel import halo
from stereoanywhere_tpu_torch.parallel.halo import conv_rows, row_conv

# rows each fused kernel reads beyond its output's: K7 3x3 then 3x3; K8 7x7
# (flow), 3x3, 3x3; K9 3x3 (z, r), then 3x3 over r * h
HEAD_ROWS, MOTION_ROWS, GRU_ROWS = 2, 5, 2


class ConvGRU(nn.Module):
    """Conv GRU with precomputed context injections (cz, cr, cq)."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        p = kernel_size // 2
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)

    def forward(self, h, cz, cr, cq, *x_list):
        hd = h.shape[1]
        # z and r read the same [h, x]: one conv with both kernels stacked.
        # [h, x] and [r * h, x] are each one concatenation of the inputs (a
        # channels-last concatenation along C interleaves its inputs' rows:
        # x is not built on its own first)
        zr = conv_rows(
            torch.cat([h, *x_list], dim=1),
            torch.cat([self.convz.weight, self.convr.weight]),
            torch.cat([self.convz.bias, self.convr.bias]),
            padding=self.convz.padding,
        )
        z = torch.sigmoid(zr[:, :hd] + cz)
        r = torch.sigmoid(zr[:, hd:] + cr)
        q = torch.tanh(row_conv(self.convq, torch.cat([r * h, *x_list], dim=1)) + cq)
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
        both = F.relu(row_conv(self.convc2, F.relu(row_conv(self.convc1, torch.cat([corr, corr_mono], dim=0)))))
        flo = F.relu(row_conv(self.convf2, F.relu(row_conv(self.convf1, flow))))
        out = F.relu(row_conv(self._conv, torch.cat([both[:b], both[b:], flo], dim=1)))
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
        y = F.relu(row_conv(self.conv1, x))
        return conv_rows(y, self.conv2.weight[:1], self.conv2.bias[:1], padding=1)


def _leaves(packed) -> list[torch.Tensor]:
    """The tensors of nested tuples of packed weights, in order."""
    return [packed] if torch.is_tensor(packed) else [t for x in packed for t in _leaves(x)]


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
        self.register_load_state_dict_post_hook(MultiUpdateBlock.refresh_fused_weights)

    def fused_weights(self, dtype: torch.dtype) -> sf.FusedWeights:
        """The weights in the layout of the rotated step's kernels, packed
        once per dtype and device.  A load of the parameters packs them
        again into the same tensors (`refresh_fused_weights`), so that a
        CUDA graph that read them reads the new weights."""
        key = (dtype, self.flow_head.conv1.weight.device)
        if key not in self._fused:
            self._fused[key] = self._pack(dtype)
        return self._fused[key]

    def _pack(self, dtype: torch.dtype) -> sf.FusedWeights:
        return sf.FusedWeights(
            head=sf.pack_head_weights(self.flow_head.conv1, self.flow_head.conv2, dtype),
            motion=sf.pack_motion_weights(self.encoder, dtype),
            gru=tuple(sf.pack_gru_weights(g, dtype) for g in (self.gru08, self.gru16, self.gru32)),
        )

    @torch.inference_mode()  # the packs may be inference tensors, made inside a served forward
    def refresh_fused_weights(self, *_) -> None:
        """Pack the current parameters into the tensors packed before, in
        place; run after every load (`load_state_dict`, through its hook,
        and `compat.from_jax.load_stereo_variables`)."""
        for (dtype, _), packed in self._fused.items():
            for old, new in zip(_leaves(packed), _leaves(self._pack(dtype))):
                old.copy_(new)


def gru_cascade(block: nn.Module, net, inp, motion):
    """The 3-scale ConvGRU cascade of `block` (its `gru32`, `gru16`, `gru08`
    and `n_gru_layers`): net the hidden states [1/4, 1/8, 1/16], inp each
    scale's (cz, cr, cq), motion the finest scale's input."""
    net = list(net)
    n = block.n_gru_layers
    if n == 3:
        net[2] = block.gru32(net[2], *inp[2], pool2x(net[1]))
    if n >= 2:
        if n > 2:
            net[1] = block.gru16(net[1], *inp[1], pool2x(net[0]), interp_like(net[2], net[1]))
        else:
            net[1] = block.gru16(net[1], *inp[1], pool2x(net[0]))
    if n > 1:
        net[0] = block.gru08(net[0], *inp[0], motion, interp_like(net[1], net[0]))
    else:
        net[0] = block.gru08(net[0], *inp[0], motion)
    return net


class SigmoidUpdateHead(nn.Module):
    """conv-ReLU-conv-sigmoid (the reference's, for its confidence and
    local-scale outputs)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, output_dim, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(row_conv(self.conv2, F.relu(row_conv(self.conv1, x))))


class ScaleShiftUpdateHead(nn.Module):
    """Global scale and shift: two 3x3 convs, a max over the image, then
    Linear-ReLU-Linear (`scaler.2`, `scaler.4` as in the reference).
    Returns (B, output_dim, 1, 1)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1)
        self.scaler = nn.Sequential(nn.AdaptiveMaxPool2d(1), nn.Flatten(), nn.Linear(hidden_dim, hidden_dim),
                                    nn.ReLU(), nn.Linear(hidden_dim, output_dim))

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        return self.scaler(h).view(x.shape[0], -1, 1, 1)


class ConfidenceAwareMotionEncoder(nn.Module):
    """The motion encoder with a flow-confidence stream: the two
    correlations through the shared convc1/convc2, the flow and its
    confidence through their own 7x7 and 3x3 convs, merged into 125
    channels, then [merged | flow | flow_conf] (128 channels)."""

    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convcf1 = nn.Conv2d(1, 64, 7, padding=3)
        self.convcf2 = nn.Conv2d(64, 64, 3, padding=1)
        self._conv_with_conf = nn.Conv2d(64 * 4, 128 - 3, 3, padding=1)

    def forward(self, flow, flow_conf, corr, corr_mono):
        b = corr.shape[0]
        both = F.relu(row_conv(self.convc2, F.relu(row_conv(self.convc1, torch.cat([corr, corr_mono], dim=0)))))
        flo = F.relu(row_conv(self.convf2, F.relu(row_conv(self.convf1, flow))))
        cfl = F.relu(row_conv(self.convcf2, F.relu(row_conv(self.convcf1, flow_conf))))
        out = F.relu(row_conv(self._conv_with_conf, torch.cat([both[:b], both[b:], flo, cfl], dim=1)))
        return torch.cat([out, flow, flow_conf], dim=1)


class MultiUpdateScalerBlock(nn.Module):
    """The 3-scale GRU cascade predicting a local scale, a global scale and
    shift and a confidence delta instead of a flow delta (the reference's
    `BasicMultiUpdateScalerBlock`, which its model builds and never uses).
    As in the JAX package, the encoder gets both correlation streams: the
    reference calls it with three arguments where it takes four, an error
    on a path it never runs.  Returns (net, delta_lscale, delta_gscale,
    delta_gshift, delta_conf): the local ones (B,1,H,W), the global ones
    (B,1,1,1)."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 corr_channels: int = 36):
        super().__init__()
        hd = tuple(hidden_dims)
        self.n_gru_layers = n_gru_layers
        self.encoder = ConfidenceAwareMotionEncoder(corr_channels)
        self.gru08 = ConvGRU(hd[2], 128 + hd[1] * (n_gru_layers > 1))
        self.gru16 = ConvGRU(hd[1], hd[0] * (n_gru_layers == 3) + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.gscale_gshift_head = ScaleShiftUpdateHead(hd[2], 256, 2)
        self.conf_head = SigmoidUpdateHead(hd[2], 256, 1)
        self.lscale_head = SigmoidUpdateHead(hd[2], 256, 1)

    def forward(self, net, inp, corr, corr_mono, flow, flow_conf):
        motion = self.encoder(flow, flow_conf, corr, corr_mono)
        net = gru_cascade(self, net, inp, motion)
        gscale_gshift = self.gscale_gshift_head(net[0])
        return (net, self.lscale_head(net[0]), gscale_gshift[:, 0:1], gscale_gshift[:, 1:2],
                self.conf_head(net[0]))


def update_nets(block: MultiUpdateBlock, net, inp, pyramids, coords1, coords0, radius: int,
                lookup_impl: str = "window"):
    """Look the stereo and mono pyramids up at coords1 (B,1,H,W) f32, encode
    the motion and run the cascade: a GRU iteration without its flow head
    (the JAX `skip_flow_head` pre-step).  net/inp/pyramids are in the
    compute dtype; pyramids is a `DualPyramid` (K5) or, in train mode, the
    pair of level lists (the differentiable gather)."""
    cdt = net[0].dtype
    # coords1 may be the expanded coords0 (init_disparity_zero): K5 reads
    # its x-coordinates as a contiguous plane
    stereo_corr, mono_corr = lookup_corr_pyramid_pair(pyramids, coords1[:, 0].contiguous(), radius, lookup_impl)
    stereo_corr = stereo_corr.permute(0, 3, 1, 2).to(cdt)
    mono_corr = mono_corr.permute(0, 3, 1, 2).to(cdt)
    flow_x = coords1 - coords0
    if channels_last_format(net[0]) is None:
        flow = torch.cat([flow_x, torch.zeros_like(flow_x)], dim=1).to(cdt)
    else:
        # [flow-x, 0] built as (B,H,W,2), so that its (B,2,H,W) view is
        # channels-last as the states are
        flow = torch.stack([flow_x[:, 0], torch.zeros_like(flow_x[:, 0])], dim=-1).permute(0, 3, 1, 2).to(cdt)
    motion = block.encoder(flow, stereo_corr, mono_corr)
    return [n.to(cdt) for n in gru_cascade(block, net, inp, motion)]


def refinement_tail(block: MultiUpdateBlock, net, coords1, compute_mask: bool):
    """Flow head, mask head and coordinate update (the JAX `tail_only`):
    returns (net, coords1 + delta-x, mask logits or None)."""
    delta_x = block.flow_head.forward_x(net[0])
    mask = 0.25 * row_conv(block.mask[2], F.relu(row_conv(block.mask[0], net[0]))) if compute_mask else None
    return net, coords1 + delta_x.float(), mask


def refinement_step(block: MultiUpdateBlock, net, inp, pyramids, coords1, coords0, radius: int,
                    compute_mask: bool, lookup_impl: str = "window"):
    """One GRU iteration of the test-mode loop (the JAX `RefinementStep`):
    look both pyramids up at coords1 (B,1,H,W) f32, run the update block, move
    coords1 by the x-delta.  net/inp/pyramids are in the compute dtype.
    Returns (net, coords1, mask logits or None).  No gradient flows through
    the incoming coords1 (JAX `models/update.py:399`)."""
    coords1 = coords1.detach()
    net = update_nets(block, net, inp, pyramids, coords1, coords0, radius, lookup_impl)
    return refinement_tail(block, net, coords1, compute_mask)


def on_band(fn, radius: int, *planes: torch.Tensor) -> torch.Tensor:
    """fn(*planes) for NHWC / (B,H,W) planes of this rank's rows: with no
    row group, fn itself; with one, fn over the band of global rows
    [a - radius, b + radius) clipped to the image, fetched from the
    neighbours, and the result's rows [a, b) of it.  Exact when fn reads at
    most `radius` rows beyond each output row and zero-pads at its input's
    edges, as the kernels do."""
    g = halo.active()
    if g is None:
        return fn(*planes)
    n = planes[0].shape[1]
    height, ranges = g.span(n)
    needs = [(max(0, a - radius), min(height, b + radius)) for a, b in ranges]
    lo, a = needs[g.index][0], ranges[g.index][0]
    out = fn(*(g.fetch(p, 1, needs).contiguous() for p in planes))
    return out.narrow(1, a - lo, n).contiguous()


def fused_refinement_step(ws: sf.FusedWeights, net, czrq, pyramids: DualPyramid, coords1: torch.Tensor,
                          radius: int):
    """The rotated body of the fused loop (JAX `FusedRefinementStep`):

        coords += flow_head(net0)                      K7
        corr = lookup(coords), both pyramids           K5
        net2 = gru32(net2, pool(net1))                 K9
        net1 = gru16(net1, pool(net0), interp(net2))   K9
        motion = encoder(corr, coords - coords0)       K8
        net0 = gru08(net0, motion, interp(net1))       K9

    net: the three hidden states, NHWC in the compute dtype; czrq: each
    scale's context injections [cz | cr | cq], NHWC; coords1 (B,H4,W4) f32,
    the x-coordinate.  Returns (net, coords1).  Under a row group every
    plane holds the rank's rows: K7, K8 and K9 run on bands (`on_band`),
    the pooling and resizes are the row-aware ones."""
    coords1 = on_band(lambda h, c: flow_head(h, c, ws.head), HEAD_ROWS, net[0], coords1)
    corr_a, corr_b = dual_lookup(pyramids, coords1, radius)
    net = list(net)

    def gru(i, xs):
        return on_band(lambda h, c, *x: conv_gru(h, list(x), c, ws.gru[i]), GRU_ROWS, net[i], czrq[i], *xs)

    net[2] = gru(2, [pool2x_nhwc(net[1])])
    net[1] = gru(1, [pool2x_nhwc(net[0]), interp_like_nhwc(net[2], net[1])])
    xup = interp_like_nhwc(net[1], net[0])
    motion = on_band(lambda a, b, c: motion_encoder(a, b, c, ws.motion), MOTION_ROWS, corr_a, corr_b, coords1)
    net[0] = gru(0, [motion, xup])
    return net, coords1
