"""StereoAnywhere with stereo-volume aggregation and stacked hourglasses in
plain PyTorch, f32: the reference of a configuration whose `stereo` block
sets `use_aggregate_stereo_vol` and `n_additional_hourglass` (upstream's
`--use_aggregate_stereo_vol` and `--n_additional_hourglass`,
github.com/bartn8/stereoanywhere models/stereoanywhere/stereoanywhere.py
:60-66, :147-166), with the mono prior of `shipped`.

`AggregatedStereoAnywhere` is `stereo.StereoAnywhere` with two more steps,
in upstream's order:

1. the masked stereo volume (the mono volume's depth-bin masks, the same
   hourglass layout) goes through `hourglass_stereo`, then the stereo
   stack, is permuted back to (B,C,H,W2,W3) and reduced by
   `classifier_stereo`; that volume replaces the raw correlation volume in
   the refinement loop's pyramid, and the mirror-truncation mask
   multiplies it there as it would the raw one;
2. the masked mono volume goes through `hourglass_mono`, then the mono
   stack, before its two classifiers.

A stack is upstream's list of n + 1 entries of which the first n run, the
first an identity: so entries 1 .. n-1 are the hourglasses that run, one
after the other, each over the volume that the previous one returned.

Departures from upstream, each also the port's:
- the never-run last entry of each stack, `stack.n`, is not built, so it
  has no parameters; entry 0, the identity, has none either;
- test mode only, with no volume corruption;
- those of `stereo.StereoAnywhere`: every hourglass skips its first
  aggregation level, whose result never reaches the output; BatchNorm on
  its running statistics; the weights are the benchmark's draw;
- `vol_downsample` is refused with the branch, as the port refuses it.

One departure that is not the port's: the stereo branch's coarse
disparities, which upstream (for its losses) and the port (inside
`sa.stereo.aggregate`) compute and return beside the disparity, are not
computed here, so nothing holds them to a reference.  The forward repeats
`stereo.StereoAnywhere.forward` but for the stereo volume and the mono
stack, since that method has no hook for either.

Parameter names are the port's (`hourglass_stereo.*`,
`hourglass_{mono,stereo}_stack.<i>.*`, `classifier_stereo.weight`), so
that one draw of `port_bench.weights` fills both alike.  Nothing here
imports the port.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import arith, ops, shipped
from port_bench.reference.pipeline import ReferencePipeline
from port_bench.reference.stereo import Hourglass, StereoAnywhere, StereoConfig, _classifier

STEREO_KEYS = shipped.STEREO_KEYS | {"use_aggregate_stereo_vol", "n_additional_hourglass"}


def hourglass_stack(cfg: StereoConfig, n: int) -> nn.ModuleList:
    """Entries 0 .. n-1 of upstream's stack: the identity, then n - 1
    hourglasses."""
    return nn.ModuleList([nn.Identity()] + [Hourglass(cfg.volume_channels, cfg.volume_channels)
                                            for _ in range(1, n)])


class AggregatedStereoAnywhere(StereoAnywhere):
    def __init__(self, cfg: StereoConfig, aggregate_stereo: bool, n_additional_hourglass: int):
        super().__init__(cfg)
        self.aggregate_stereo = aggregate_stereo
        if n_additional_hourglass > 1:
            self.hourglass_mono_stack = hourglass_stack(cfg, n_additional_hourglass)
        if aggregate_stereo:
            self.hourglass_stereo = Hourglass(cfg.vol_n_masks, cfg.volume_channels)
            if n_additional_hourglass > 1:
                self.hourglass_stereo_stack = hourglass_stack(cfg, n_additional_hourglass)
            self.classifier_stereo = _classifier(cfg.volume_channels)

    def aggregate(self, which: str, volume, fmde2, fmde3):
        """hourglass_<which> and its stack over a masked volume
        (B,N,W3,H,W2) -> (B,C,H,W2,W3)."""
        x = getattr(self, f"hourglass_{which}")(volume, fmde2, fmde3)
        for hourglass in getattr(self, f"hourglass_{which}_stack", [])[1:]:
            x = hourglass(x, fmde2, fmde3)
        return x.permute(0, 1, 3, 4, 2)

    def stereo_volume(self, stereo_vol, left_masks, right_masks, fmde2, fmde3):
        """The volume that the loop's stereo pyramid is built from, before
        the truncation mask: the aggregated one with the branch, the raw
        correlation volume without."""
        if not self.aggregate_stereo:
            return stereo_vol
        agg = self.aggregate("stereo", ops.masked_volume(stereo_vol, left_masks, right_masks), fmde2, fmde3)
        return arith.conv(self.classifier_stereo, agg)[:, 0]

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

        mono_vol = 1.73 * ops.all_pairs_correlation(normals2, normals3)
        left_masks = ops.generate_masks(mde2_low, cfg.vol_n_masks)
        right_masks = ops.generate_masks(mde3_low, cfg.vol_n_masks)
        stereo_vol = self.stereo_volume(ops.all_pairs_correlation(fmap2, fmap3), left_masks, right_masks,
                                        fmde2, fmde3)

        agg = self.aggregate("mono", ops.masked_volume(mono_vol, left_masks, right_masks), fmde2, fmde3)
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


def build(cfg: dict) -> ReferencePipeline:
    """The f32 pipeline on the meta device."""
    stereo = cfg["stereo"]
    aggregate_stereo = bool(stereo.get("use_aggregate_stereo_vol", False))
    n = int(stereo.get("n_additional_hourglass", 0))
    if n < 0:
        raise ValueError(f"config {cfg['name']}: n_additional_hourglass {n}, a count")
    if aggregate_stereo and stereo.get("vol_downsample", 0) > 0:
        raise ValueError(f"config {cfg['name']}: use_aggregate_stereo_vol with vol_downsample, which the port refuses")
    pipe = shipped.build(cfg)  # the widths' check, the mono prior, the loop's length and DAv2's size
    with torch.device("meta"):
        pipe.stereo = AggregatedStereoAnywhere(pipe.stereo.cfg, aggregate_stereo, n)
    return pipe
