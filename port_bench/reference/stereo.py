"""StereoAnywhere's test-mode forward in plain PyTorch, f32: the feature
and context encoders, the normals' volume and its masks, the hourglass and
its classifiers, the soft LRC, the weighted least squares, the mirror
truncation, the correlation pyramids, `iters` refinement steps (motion
encoder, three-scale ConvGRU cascade, flow head; the gather lookup) and
convex upsampling.

A frozen copy of the shipped configuration's path through
`stereoanywhere_tpu_torch/models/` (no row groups, no fused loop, no
variants, no training), with the same module classes' names and parameter
names, so that `port_bench.weights` draws the same tensors into both.
Every product runs through `arith`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import arith
from port_bench.reference import ops


@dataclass(frozen=True)
class StereoConfig:
    """The shipped model's widths (the reference's defaults)."""

    corr_radius: int = 4
    corr_levels: int = 4
    n_gru_layers: int = 3
    n_downsample: int = 2
    context_dims: tuple[int, ...] = (128, 128, 128)
    fnet_dim: int = 256
    volume_channels: int = 8
    vol_n_masks: int = 8
    mirror_conf_th: float = 0.98
    mirror_attenuation: float = 0.9
    lrc_th: float = 1.0
    normal_gain: float = 10.0
    width_pad_align: int = 64
    width_pad_min: int = 640


def instance_norm(x, eps: float = 1e-5):
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x * x).mean(dim=dims, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class BatchNorm(nn.Module):
    """BatchNorm on its running statistics (eps 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


def _norm(kind: str, features: int) -> nn.Module:
    return BatchNorm(features) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(arith.conv(self.conv1, x)))
        y = F.relu(self.norm2(arith.conv(self.conv2, y)))
        if self.downsample is not None:
            x = self.downsample[1](arith.conv(self.downsample[0], x))
        return F.relu(x + y)


class FeatureEncoder(nn.Module):
    def __init__(self, output_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, "instance"), ResidualBlock(64, 64, "instance"))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, "instance", 2), ResidualBlock(96, 96, "instance"))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, "instance", 2), ResidualBlock(128, 128, "instance"))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(arith.conv(self.conv1, x)))
        return arith.conv(self.conv2, self.layer3(self.layer2(self.layer1(x))))


class ContextEncoder(nn.Module):
    """Reads the left depth replicated to 3 channels, as the reference does."""

    def __init__(self, dims: tuple[int, ...]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1, padding=3)
        self.norm1 = BatchNorm(64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, "batch"), ResidualBlock(64, 64, "batch"))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, "batch", 2), ResidualBlock(96, 96, "batch"))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, "batch", 2), ResidualBlock(128, 128, "batch"))
        self.layer4 = nn.Sequential(ResidualBlock(128, 128, "batch", 2), ResidualBlock(128, 128, "batch"))
        self.layer5 = nn.Sequential(ResidualBlock(128, 128, "batch", 2), ResidualBlock(128, 128, "batch"))
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "batch"), nn.Conv2d(128, dims[2], 3, padding=1)) for _ in range(2))
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "batch"), nn.Conv2d(128, dims[1], 3, padding=1)) for _ in range(2))
        self.outputs32 = nn.ModuleList(nn.Conv2d(128, dims[0], 3, padding=1) for _ in range(2))

    def forward(self, x):
        x = F.relu(self.norm1(arith.conv(self.conv1, x.expand(-1, 3, -1, -1))))
        x = self.layer3(self.layer2(self.layer1(x)))
        head = lambda h, t: arith.conv(h[1], h[0](t))  # noqa: E731
        outs04 = tuple(head(h, x) for h in self.outputs08)
        y = self.layer4(x)
        outs08 = tuple(head(h, y) for h in self.outputs16)
        z = self.layer5(y)
        outs16 = tuple(arith.conv(h, z) for h in self.outputs32)
        return outs04, outs08, outs16


# ---------------------------------------------------------------------------
# hourglass: volumes (B, C, W3, H, W2), depth pyramids (B, 1, H', W')


class BasicConv(nn.Module):
    """conv (no bias) -> instance norm -> leaky ReLU(0.01)."""

    def __init__(self, in_ch: int, out_ch: int, is_3d: bool = False, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        conv = nn.Conv3d if is_3d else nn.Conv2d
        self.conv = conv(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=False)

    def forward(self, x):
        return F.leaky_relu(instance_norm(arith.conv(self.conv, x)), negative_slope=0.01)


class _AttBranch(nn.Sequential):
    def __init__(self, cv_ch: int):
        super().__init__(BasicConv(1, 32), nn.Conv2d(32, cv_ch, 1))

    def forward(self, x):
        return arith.conv(self[1], self[0](x))


class DoubleFeatureAtt(nn.Module):
    def __init__(self, cv_ch: int):
        super().__init__()
        self.feat_att_left = _AttBranch(cv_ch)
        self.feat_att_right = _AttBranch(cv_ch)

    def forward(self, cv, feat_left, feat_right):
        gl = torch.sigmoid(self.feat_att_left(feat_left))
        gr = torch.sigmoid(self.feat_att_right(feat_right))
        gate = gl.unsqueeze(2) * gr.permute(0, 1, 3, 2).unsqueeze(-1)
        if gate.shape[2:] != cv.shape[2:]:
            gate = ops.resize_trilinear_align_corners(gate, tuple(cv.shape[2:]))
        return gate * cv


class Hourglass(nn.Module):
    """3 levels (8 -> 16 -> 32 -> 48 channels and back), with the
    reference's quirk that only the last aggregation level reaches the
    output (the earlier levels' weights exist and do not run)."""

    def __init__(self, in_ch: int = 8, out_ch: int = 8):
        super().__init__()
        ns = 4
        self.down_layers = nn.ModuleList()
        self.feature_atts = nn.ModuleList()
        cin = in_ch
        for i in range(ns - 1):
            cout = in_ch * 2 * (i + 1)
            self.down_layers.append(nn.Sequential(BasicConv(cin, cout, True, stride=2), BasicConv(cout, cout, True)))
            self.feature_atts.append(DoubleFeatureAtt(cout))
            cin = cout
        down_ch = [in_ch * 2 * (i + 1) for i in range(ns - 1)]
        self.agg_layers = nn.ModuleList()
        self.feature_atts_up = nn.ModuleList()
        for i in range(ns - 2):
            cout = in_ch * 2 * (ns - i - 2)
            cin = down_ch[ns - 2 - i] + down_ch[ns - 3 - i]
            self.agg_layers.append(nn.Sequential(
                BasicConv(cin, cout, True, kernel_size=1, padding=0), BasicConv(cout, cout, True),
                BasicConv(cout, cout, True)))
            self.feature_atts_up.append(DoubleFeatureAtt(cout))
        self.final_agg = nn.Sequential(
            BasicConv(in_ch + in_ch * 2, in_ch, True, kernel_size=1, padding=0), BasicConv(in_ch, in_ch, True),
            BasicConv(in_ch, out_ch, True))
        self.final_feature_atts_up = DoubleFeatureAtt(out_ch)

    def forward(self, x, features_left, features_right):
        original = x
        down = []
        for i in range(3):
            x = self.down_layers[i](x)
            x = self.feature_atts[i](x, features_left[i + 1], features_right[i + 1])
            down.append(x)
        x_up = ops.resize_trilinear_align_corners(down[1], tuple(down[0].shape[2:]))
        x = self.agg_layers[1](torch.cat([x_up, down[0]], dim=1))
        x = self.feature_atts_up[1](x, features_left[1], features_right[1])
        x_up = ops.resize_trilinear_align_corners(x, tuple(original.shape[2:]))
        x = self.final_agg(torch.cat([original, x_up], dim=1))
        return self.final_feature_atts_up(x, features_left[0], features_right[0])


# ---------------------------------------------------------------------------
# the refinement loop


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h, cz, cr, cq, *x_list):
        hx = torch.cat([h, *x_list], dim=1)
        z = torch.sigmoid(arith.conv(self.convz, hx) + cz)
        r = torch.sigmoid(arith.conv(self.convr, hx) + cr)
        q = torch.tanh(arith.conv(self.convq, torch.cat([r * h, *x_list], dim=1)) + cq)
        return (1 - z) * h + z * q


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self._conv = nn.Conv2d(64 * 3, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, corr_mono):
        enc = lambda c: F.relu(arith.conv(self.convc2, F.relu(arith.conv(self.convc1, c))))  # noqa: E731
        flo = F.relu(arith.conv(self.convf2, F.relu(arith.conv(self.convf1, flow))))
        out = F.relu(arith.conv(self._conv, torch.cat([enc(corr), enc(corr_mono), flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward_x(self, x):
        y = F.relu(arith.conv(self.conv1, x))
        return arith.conv2d(y, self.conv2.weight[:1], self.conv2.bias[:1], 1, 1)


class MultiUpdateBlock(nn.Module):
    def __init__(self, hd: tuple[int, ...], corr_channels: int, n_downsample: int):
        super().__init__()
        self.encoder = MotionEncoder(corr_channels)
        self.gru08 = ConvGRU(hd[2], 128 + hd[1])
        self.gru16 = ConvGRU(hd[1], hd[0] + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.flow_head = FlowHead(hd[2], 256)
        f = 2 ** n_downsample
        self.mask = nn.Sequential(nn.Conv2d(hd[2], 256, 3, padding=1), nn.ReLU(inplace=True),
                                  nn.Conv2d(256, f * f * 9, 1))

    def step(self, net, inp, levels, coords1, coords0, radius: int, compute_mask: bool):
        """One refinement iteration: (net, coords1, mask logits or None)."""
        stereo_levels, mono_levels = levels
        x = coords1[:, 0]
        corr = ops.lookup_corr_pyramid(stereo_levels, x, radius).permute(0, 3, 1, 2)
        corr_mono = ops.lookup_corr_pyramid(mono_levels, x, radius).permute(0, 3, 1, 2)
        flow_x = coords1 - coords0
        motion = self.encoder(torch.cat([flow_x, torch.zeros_like(flow_x)], dim=1), corr, corr_mono)
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], ops.pool2x(net[1]))
        net[1] = self.gru16(net[1], *inp[1], ops.pool2x(net[0]), ops.interp_like(net[2], net[1]))
        net[0] = self.gru08(net[0], *inp[0], motion, ops.interp_like(net[1], net[0]))
        delta_x = self.flow_head.forward_x(net[0])
        mask = None
        if compute_mask:
            mask = 0.25 * arith.conv(self.mask[2], F.relu(arith.conv(self.mask[0], net[0])))
        return net, coords1 + delta_x, mask


def _classifier(ch: int) -> nn.Conv3d:
    return nn.Conv3d(ch, 1, 3, padding=1, bias=False)


class StereoAnywhere(nn.Module):
    """(B,H,W,3) views in [0,1] and (B,H,W,1) normalized depth, H and W
    multiples of 32 -> (B,H,W,1) positive disparity."""

    def __init__(self, cfg: StereoConfig = StereoConfig()):
        super().__init__()
        self.cfg = cfg
        dims = tuple(cfg.context_dims)
        self.cnet = ContextEncoder(dims)
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(d, d * 3, 3, padding=1) for d in dims)
        self.fnet = FeatureEncoder(cfg.fnet_dim)
        self.hourglass_mono = Hourglass(cfg.vol_n_masks, cfg.volume_channels)
        self.classifier_mono = _classifier(cfg.volume_channels)
        self.classifier_monoconf = _classifier(cfg.volume_channels)
        corr_channels = cfg.corr_levels * (2 * cfg.corr_radius + 1)
        self.update_block = MultiUpdateBlock(dims, corr_channels, cfg.n_downsample)

    def forward(self, image2, image3, mde2, mde3, iters: int):
        cfg = self.cfg
        image2, image3, mde2, mde3 = (t.permute(0, 3, 1, 2).contiguous() for t in (image2, image3, mde2, mde3))
        b, _, h, w = image2.shape
        w_orig = None
        if w >= cfg.width_pad_min and w % cfg.width_pad_align:
            w_orig = w
            w = -(-w // cfg.width_pad_align) * cfg.width_pad_align
            image2, image3, mde2, mde3 = (F.pad(t, (0, w - w_orig, 0, 0), mode="replicate")
                                          for t in (image2, image3, mde2, mde3))
        f = 2 ** cfg.n_downsample
        h4, w4 = h // f, w // f
        image2, image3 = image2 * 2.0 - 1.0, image3 * 2.0 - 1.0

        mde2_low = ops.resize_bilinear_align_corners(mde2, (h4, w4))
        mde3_low = ops.resize_bilinear_align_corners(mde3, (h4, w4))
        normals2 = ops.estimate_normals(mde2_low, w4 / cfg.normal_gain)
        normals3 = ops.estimate_normals(mde3_low, w4 / cfg.normal_gain)

        cnet_out = self.cnet(mde2)
        net = [torch.tanh(o[0]) for o in cnet_out]
        inp = [tuple(torch.chunk(arith.conv(conv, F.relu(o[1])), 3, dim=1))
               for conv, o in zip(self.context_zqr_convs, cnet_out)]
        fmaps = self.fnet(torch.cat([image2, image3], dim=0))
        fmap2, fmap3 = fmaps[:b], fmaps[b:]

        sizes = [(h // 2 ** i, w // 2 ** i) for i in range(cfg.n_downsample, 6)]
        fmde2 = [ops.resize_bilinear_align_corners(mde2, s) for s in sizes]
        fmde3 = [ops.resize_bilinear_align_corners(mde3, s) for s in sizes]

        stereo_vol = ops.all_pairs_correlation(fmap2, fmap3)
        mono_vol = 1.73 * ops.all_pairs_correlation(normals2, normals3)
        left_masks = ops.generate_masks(mde2_low, cfg.vol_n_masks)
        right_masks = ops.generate_masks(mde3_low, cfg.vol_n_masks)

        agg = self.hourglass_mono(ops.masked_volume(mono_vol, left_masks, right_masks), fmde2, fmde3)
        agg = agg.permute(0, 1, 3, 4, 2)  # (B,C,H,W2,W3)
        agg_disp = arith.conv(self.classifier_mono, agg)[:, 0]
        agg_conf = arith.conv(self.classifier_monoconf, agg)[:, 0]

        disp2_low = ops.estimate_left_disparity(agg_disp)
        disp3_low = ops.estimate_right_disparity(agg_disp)
        conf2_low = ops.estimate_left_confidence(agg_conf)
        conf3_low = ops.estimate_right_confidence(agg_conf)
        lrc2_low, lrc3_low = ops.softlrc(disp2_low, disp3_low, cfg.lrc_th)
        dispconf2_low = ops.fuzzy_and(conf2_low, lrc2_low)
        dispconf3_low = ops.fuzzy_and(conf3_low, lrc3_low)
        scale, shift = ops.weighted_lsq(torch.cat([mde2_low, mde3_low], dim=1),
                                        torch.cat([disp2_low, disp3_low], dim=1),
                                        torch.cat([dispconf2_low, dispconf3_low], dim=1))
        scaled_mde2_low = scale * mde2_low + shift
        scaled_mde3_low = scale * mde3_low + shift
        lrc_scaled2_low, _ = ops.softlrc(scaled_mde2_low, scaled_mde3_low, cfg.lrc_th)
        mirror_conf = ops.handcrafted_mirror_detector(disp2_low, scaled_mde2_low, dispconf2_low, lrc_scaled2_low,
                                                      cfg.mirror_conf_th)
        stereo_vol = ops.truncate_corr_volume(scaled_mde2_low, mirror_conf, cfg.mirror_attenuation) * stereo_vol
        levels = (ops.build_corr_pyramid(stereo_vol, cfg.corr_levels),
                  ops.build_corr_pyramid(agg_disp, cfg.corr_levels))

        coords0 = torch.arange(w4, device=image2.device, dtype=image2.dtype).view(1, 1, 1, w4).expand(b, 1, h4, w4)
        coords1 = coords0 - scaled_mde2_low
        mask = None
        for it in range(iters):
            net, coords1, mask = self.update_block.step(net, inp, levels, coords1, coords0, cfg.corr_radius,
                                                        it == iters - 1)
        disparity = -ops.convex_upsample(coords1 - coords0, mask, cfg.n_downsample)
        if w_orig is not None:
            disparity = disparity[..., :w_orig]
        return disparity.permute(0, 2, 3, 1)
