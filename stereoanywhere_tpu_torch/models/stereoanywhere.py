"""StereoAnywhere, test-mode forward, in PyTorch.

The forward dataflow of the JAX package's `models/stereoanywhere.py` (the
reference's stereoanywhere.py:95-299) with NHWC tensors at the entry point
and NCHW inside.  Only the test-mode forward is ported: no training outputs
and no volume corruption.  Internally flow = coords1 - coords0 =
-disparity; the output is POSITIVE disparity.

The refinement loop has the JAX package's two schedules: `iters` plain
steps, or with `fused_level0="on"` (where the JAX gate would fuse) one
pre-step without the flow head, `iters - 1` rotated bodies whose
quarter-resolution plane runs in the K7, K5, K8 and K9 kernels (NHWC), and
a tail with the flow and mask heads: the same function, reordered.

Inputs: image2, image3 (B,H,W,3) in [0,1]; mde2, mde3 (B,H,W,1) normalized
mono depth; H and W multiples of 32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
from stereoanywhere_tpu_torch.device import resolve_device, torch_dtype
from stereoanywhere_tpu_torch.models.extractor import ContextEncoder, FeatureEncoder
from stereoanywhere_tpu_torch.models.hourglass import Hourglass
from stereoanywhere_tpu_torch.models.layers import LECUN, init_weights
from stereoanywhere_tpu_torch.models.update import (
    MultiUpdateBlock,
    fused_refinement_step,
    refinement_step,
    refinement_tail,
    update_nets,
)
from stereoanywhere_tpu_torch.ops.corr_lookup import build_corr_pyramid
from stereoanywhere_tpu_torch.ops.fuzzy import fuzzy_and
from stereoanywhere_tpu_torch.ops.geometry import estimate_normals, joint_minmax_normalize, softlrc
from stereoanywhere_tpu_torch.ops.interp import resize_bilinear_align_corners
from stereoanywhere_tpu_torch.ops.lsq import weighted_lsq
from stereoanywhere_tpu_torch.ops.step_fused import fused_step_supported
from stereoanywhere_tpu_torch.ops.upsample import convex_upsample
from stereoanywhere_tpu_torch.ops.volume import (
    all_pairs_correlation,
    estimate_left_confidence,
    estimate_left_disparity,
    estimate_right_confidence,
    estimate_right_disparity,
    generate_masks,
    handcrafted_mirror_detector,
    masked_volume,
    truncate_corr_volume,
)


def _classifier(ch: int) -> nn.Conv3d:
    conv = nn.Conv3d(ch, 1, 3, padding=1, bias=False)
    conv.init_kind = LECUN
    return conv


class StereoAnywhere(nn.Module):
    """The stereo network.  `device` defaults to the card and raises without
    one unless "cpu" is asked for; weights are random from `generator`
    (default seed 0) until loaded."""

    def __init__(
        self,
        cfg: StereoAnywhereConfig = StereoAnywhereConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dims = tuple(cfg.context_dims)
        self.cnet = ContextEncoder((dims, dims), cfg.n_downsample)
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(d, d * 3, 3, padding=1) for d in dims)
        self.fnet = FeatureEncoder(cfg.fnet_dim, cfg.n_downsample)
        self.hourglass_mono = Hourglass(cfg.vol_n_masks, cfg.volume_channels)
        self.classifier_mono = _classifier(cfg.volume_channels)
        self.classifier_monoconf = _classifier(cfg.volume_channels)
        self.update_block = MultiUpdateBlock(dims, cfg.n_gru_layers, cfg.n_downsample, cfg.corr_channels)
        init_weights(self, generator or torch.Generator().manual_seed(0))
        self.to(device=dev, dtype=torch_dtype(cfg.compute_dtype))

    def fused_step_used(self, net0_shape) -> bool:
        """The JAX package's gate for the rotated, fused loop
        (`models/stereoanywhere.py:554-562`), with its barrel condition read
        as `lookup_impl == "barrel"`; net0_shape is the quarter-resolution
        hidden state's NCHW shape."""
        cfg = self.cfg
        b, c, h4, w4 = net0_shape
        return (
            cfg.fused_level0 == "on"
            and cfg.lookup_impl != "barrel"
            and cfg.n_gru_layers == 3
            and tuple(cfg.context_dims) == (128, 128, 128)
            and cfg.corr_radius == 4
            and fused_step_supported((b, h4, w4, c))
        )

    @torch.no_grad()
    def forward(self, image2, image3, mde2, mde3, iters: int = 32) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        cdt = torch_dtype(cfg.compute_dtype)
        to_nchw = lambda t: t.permute(0, 3, 1, 2).float()  # noqa: E731
        image2, image3, mde2, mde3 = (to_nchw(t) for t in (image2, image3, mde2, mde3))
        b, c, h, w = image2.shape

        # test-mode width alignment (JAX models/stereoanywhere.py:155-169)
        w_orig = None
        if cfg.width_pad_align and w >= cfg.width_pad_min and w % cfg.width_pad_align != 0:
            w_orig = w
            w = -(-w // cfg.width_pad_align) * cfg.width_pad_align
            pad = (0, w - w_orig, 0, 0)
            image2, image3, mde2, mde3 = (F.pad(t, pad, mode="replicate") for t in (image2, image3, mde2, mde3))

        f = cfg.downsample_factor
        h4, w4 = h // f, w // f
        if c == 1:
            image2, image3 = joint_minmax_normalize([image2.expand(-1, 3, -1, -1), image3.expand(-1, 3, -1, -1)])
        image2 = image2 * 2.0 - 1.0
        image3 = image3 * 2.0 - 1.0

        # mono pyramids
        mde2_low = resize_bilinear_align_corners(mde2, (h4, w4))
        mde3_low = resize_bilinear_align_corners(mde3, (h4, w4))
        normal_gain = w4 / cfg.normal_gain
        normals2 = estimate_normals(mde2_low, normal_gain)
        normals3 = estimate_normals(mde3_low, normal_gain)

        # context encoder on the left mono depth
        cnet_out = self.cnet(mde2.to(cdt))
        net = [torch.tanh(o[0]) for o in cnet_out]
        inp = [
            tuple(torch.chunk(conv(F.relu(o[1])), 3, dim=1))
            for conv, o in zip(self.context_zqr_convs, cnet_out)
        ]

        # feature encoder, both views as one batch
        fmaps = self.fnet(torch.cat([image2, image3], dim=0).to(cdt))
        fmap2, fmap3 = fmaps[:b], fmaps[b:]

        # mono depth pyramids for the hourglass attention
        fmde2 = [resize_bilinear_align_corners(mde2, (h // 2 ** i, w // 2 ** i)).to(cdt) for i in range(cfg.n_downsample, 6)]
        fmde3 = [resize_bilinear_align_corners(mde3, (h // 2 ** i, w // 2 ** i)).to(cdt) for i in range(cfg.n_downsample, 6)]

        # all-pairs volumes
        stereo_vol = all_pairs_correlation(fmap2, fmap3)  # (B,H4,W2,W3)
        mono_vol = (1.73 * all_pairs_correlation(normals2.to(cdt), normals3.to(cdt))).float()
        left_masks = generate_masks(mde2_low, cfg.vol_n_masks)
        right_masks = generate_masks(mde3_low, cfg.vol_n_masks)

        # masked mono volume -> hourglass -> classifiers over (H, W2, W3)
        agg = self.hourglass_mono(masked_volume(mono_vol, left_masks, right_masks).to(cdt), fmde2, fmde3)
        agg = agg.permute(0, 1, 3, 4, 2)  # (B,C,W3,H,W2) -> (B,C,H,W2,W3)
        agg_disp = self.classifier_mono(agg).float()[:, 0]  # (B,H,W2,W3)
        agg_conf = self.classifier_monoconf(agg).float()[:, 0]

        # coarse disparities and confidences
        coarse_dispmono2_low = estimate_left_disparity(agg_disp)
        coarse_dispmono3_low = estimate_right_disparity(agg_disp)
        conf2_low = estimate_left_confidence(agg_conf)
        conf3_low = estimate_right_confidence(agg_conf)
        coarse_dispmono2 = resize_bilinear_align_corners(coarse_dispmono2_low, (h, w)) * f
        coarse_dispmono3 = resize_bilinear_align_corners(coarse_dispmono3_low, (h, w)) * f
        coarse_conf2 = resize_bilinear_align_corners(conf2_low, (h, w))
        coarse_conf3 = resize_bilinear_align_corners(conf3_low, (h, w))

        lrc2_low, lrc3_low = softlrc(coarse_dispmono2_low, coarse_dispmono3_low, cfg.lrc_th)
        dispconf2_low = fuzzy_and(conf2_low, lrc2_low)
        dispconf3_low = fuzzy_and(conf3_low, lrc3_low)

        # global scale/shift by weighted least squares
        scale, shift = weighted_lsq(
            torch.cat([mde2_low, mde3_low], dim=1),
            torch.cat([coarse_dispmono2_low, coarse_dispmono3_low], dim=1),
            torch.cat([dispconf2_low, dispconf3_low], dim=1),
        )
        scaled_mde2_low = scale * mde2_low + shift
        scaled_mde3_low = scale * mde3_low + shift
        scaled_mde2 = (scale * mde2 + shift) * f
        scaled_mde3 = (scale * mde3 + shift) * f
        lrc_scaled2_low, _ = softlrc(scaled_mde2_low, scaled_mde3_low, cfg.lrc_th)

        # mirror detection and stereo-volume truncation
        if cfg.use_truncate_vol:
            mirror_conf = handcrafted_mirror_detector(
                coarse_dispmono2_low, scaled_mde2_low, dispconf2_low, lrc_scaled2_low, conf_th=cfg.mirror_conf_th
            )
            trunc_mask = truncate_corr_volume(scaled_mde2_low, mirror_conf, None, cfg.mirror_attenuation)
            stereo_vol = trunc_mask * stereo_vol
        mono_src = agg_disp if cfg.use_aggregate_mono_vol else mono_vol
        # contiguous levels: the K5 kernel reads rows of them
        stereo_pyr = build_corr_pyramid(stereo_vol.to(cdt).contiguous(), cfg.corr_levels)
        mono_pyr = build_corr_pyramid(mono_src.to(cdt).contiguous(), cfg.corr_levels)

        # iterative refinement (the JAX nn.scan, as a loop)
        coords0 = torch.arange(w4, device=image2.device, dtype=torch.float32).view(1, 1, 1, w4).expand(b, 1, h4, w4)
        coords1 = coords0 if cfg.init_disparity_zero else coords0 - scaled_mde2_low
        net = [n.to(cdt) for n in net]
        inp = [tuple(t.to(cdt) for t in triple) for triple in inp]
        lookup_impl = cfg.resolved_lookup_impl
        mask = None
        if iters >= 1 and self.fused_step_used(net[0].shape):
            net = update_nets(self.update_block, net, inp, stereo_pyr, mono_pyr, coords1, coords0, cfg.corr_radius,
                              lookup_impl)
            if iters > 1:
                ws = self.update_block.fused_weights(cdt)
                net_h = [n.permute(0, 2, 3, 1).contiguous() for n in net]
                czrq = [torch.cat(triple, dim=1).permute(0, 2, 3, 1).contiguous() for triple in inp]
                x = coords1[:, 0].contiguous()
                for _ in range(iters - 1):
                    net_h, x = fused_refinement_step(ws, net_h, czrq, stereo_pyr, mono_pyr, x, cfg.corr_radius)
                net = [n.permute(0, 3, 1, 2) for n in net_h]
                coords1 = x[:, None]
            net, coords1, mask = refinement_tail(self.update_block, net, coords1, compute_mask=True)
        else:
            for it in range(iters):
                net, coords1, mask = refinement_step(
                    self.update_block, net, inp, stereo_pyr, mono_pyr, coords1, coords0, cfg.corr_radius,
                    compute_mask=it == iters - 1, lookup_impl=lookup_impl,
                )

        flow_up = convex_upsample(coords1 - coords0, mask.float(), cfg.n_downsample)
        disparity = -flow_up
        if w_orig is not None:
            disparity = disparity[..., :w_orig]
        to_nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return {
            "disparity": to_nhwc(disparity),
            "coarse_dispmono2": to_nhwc(coarse_dispmono2),
            "coarse_dispmono3": to_nhwc(coarse_dispmono3),
            "coarse_scaled_mde2": to_nhwc(scaled_mde2),
            "coarse_scaled_mde3": to_nhwc(scaled_mde3),
            "coarse_conf2": to_nhwc(coarse_conf2),
            "coarse_conf3": to_nhwc(coarse_conf3),
            "scale": scale,
            "shift": shift,
        }
