"""StereoAnywhere, test-mode and train-mode forward, in PyTorch.

The forward dataflow of the JAX package's `models/stereoanywhere.py` (the
reference's stereoanywhere.py:95-299) with NHWC tensors at the entry point
and in the outputs.  Inside, tensors are (B,C,H,W) in shape, held in
the memory format of the stage's 2-D convolution weights
(`memory_format`): a model built on the card holds those channels-last
(`layers.channels_last_weights`), and so the activations, which cuDNN's
NHWC kernels then read and write as they are, with no transposes around
each convolution; the fused loop's kernels read the states as NHWC
views.  The hourglass and the classifiers keep NCDHW: cuDNN's NDHWC 3-D
convolutions are no faster there than its NCDHW ones with their
transposes.  A model built for the CPU keeps contiguous weights, and so
NCHW, where oneDNN's convolutions round as the CPU tests of the port
against the JAX package allow; `channels_last_weights` on it gives the
card's layout.  Internally flow = coords1 - coords0 = -disparity; the
output is POSITIVE disparity.

Test mode (`test_mode=True`, no autograd) pads wide inputs' width, looks
both pyramids up through the K5 kernel (`DualPyramid`) and has the JAX
package's two refinement schedules: `iters` plain steps, or with
`fused_level0="on"` (where the JAX gate would fuse) one pre-step without
the flow head, `iters - 1` rotated bodies whose quarter-resolution plane
runs in the K7, K5, K8 and K9 kernels (NHWC: the channels-last states as
views), and a tail with the flow and mask heads: the same function,
reordered.  With `vol_downsample` = v > 0,
both modes aggregate the mono volume at 1/2^v of (H/4, W/4, W/4), as the
JAX package does: the volume resized trilinearly, its masks nearest, the
hourglass's depth pyramids from a 1/2^v depth map, and the classifiers'
volumes resized back.

Train mode (`test_mode=False`, with autograd) is the JAX package's
`train=True` forward: no width padding, the plain schedule with every
iteration's upsampled disparity (`disparities`), the volume corruption
(`_corrupt_volumes`, drawn from `generator`), and the JAX package's
stop-gradient points (the confidence classifier's input, the truncation
mask, the coordinates at each iteration, a corrupted volume).  Its lookups
are the plain gather (`ops/corr_lookup.py`), differentiable, as the JAX
package runs its XLA lookups there: no kernel of either package has a
backward pass.  BatchNorm (the context encoder's) runs on its running
statistics with `freeze_bn` (the reference's default) and on the batch's
otherwise, updating the running statistics as flax does.  Under several
ranks (`parallel/multihost.py`) the batch is the global one: BatchNorm's
statistics, the "zero" corruption's max and the "noise" corruption's draw
are the global batch's, so N ranks compute what one process computes.

Row sharding (`parallel/spatial.py`): inside `parallel.halo.row_group`,
each rank's inputs are its rows of the padded images and every layer runs
on the rank's rows, the convolutions with halos from the neighbouring
ranks, the norms, min-max and least squares over the group, the resizes
from the bands of rows they read (`parallel/halo.py`), the fused loop's
K7, K8 and K9 launches on bands of the rows they read (`models/update.py`
`on_band`).  The volumes, the disparity and confidence estimates, the
warps and the K5 lookups read along W only and need nothing.  Test mode
only: train mode refuses a row group.

Inputs: image2, image3 (B,H,W,3) in [0,1]; mde2, mde3 (B,H,W,1) normalized
mono depth; H and W multiples of 32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
from stereoanywhere_tpu_torch.device import channels_last_format, resolve_device, torch_dtype
from stereoanywhere_tpu_torch.models.extractor import ContextEncoder, FeatureEncoder
from stereoanywhere_tpu_torch.models.hourglass import Hourglass
from stereoanywhere_tpu_torch.models.layers import (
    LECUN,
    batch_statistics,
    channels_last_weights,
    conv_in_dtype,
    init_weights,
)
from stereoanywhere_tpu_torch.models.update import (
    MultiUpdateBlock,
    fused_refinement_step,
    refinement_step,
    refinement_tail,
    update_nets,
)
from stereoanywhere_tpu_torch.ops.corr_lookup import build_corr_pyramid
from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import DualPyramid
from stereoanywhere_tpu_torch.ops.fuzzy import fuzzy_and
from stereoanywhere_tpu_torch.ops.geometry import estimate_normals, joint_minmax_normalize, softlrc
from stereoanywhere_tpu_torch.ops.interp import (
    resize_bilinear_align_corners,
    resize_nearest,
    resize_trilinear_align_corners,
)
from stereoanywhere_tpu_torch.ops.lsq import weighted_lsq
from stereoanywhere_tpu_torch.ops.step_fused import fused_step_supported
from stereoanywhere_tpu_torch.ops.upsample import convex_upsample
from stereoanywhere_tpu_torch.ops.volume import (
    all_pairs_correlation,
    estimate_left_confidence,
    estimate_left_disparity,
    estimate_right_confidence,
    estimate_right_disparity,
    gauss_corr_volume,
    generate_masks,
    handcrafted_mirror_detector,
    masked_volume,
    truncate_corr_volume,
)
from stereoanywhere_tpu_torch.parallel import halo
from stereoanywhere_tpu_torch.parallel.halo import row_conv
from stereoanywhere_tpu_torch.parallel.multihost import all_reduce_max, rank_and_world
from stereoanywhere_tpu_torch.utils.profiling import span


CORRUPTIONS = ("stereo roll", "stereo noise", "stereo zero", "mono roll", "mono noise", "mono zero")


def draw_corruption(prob: float, n_masks: int, w: int, generator: torch.Generator) -> tuple[int, int, int]:
    """(branch, mask index, shift) of one volume corruption, from a host
    generator.  The reference chains `elif random.random() < p` six times,
    so branch i of CORRUPTIONS fires with probability (1-p)^i p; branch 6
    (none) takes the rest.  The mask index is uniform over the n_masks
    depth bins, the shift over [1, w]."""
    hit = (torch.rand(6, generator=generator) < prob).tolist()
    branch = hit.index(True) if True in hit else 6
    mask_index = int(torch.randint(0, n_masks, (), generator=generator))
    shift = int(torch.randint(1, w + 1, (), generator=generator))
    return branch, mask_index, shift


def corrupt_volume(vol: torch.Tensor, kind: str, mask: torch.Tensor, shift: int, noise: torch.Tensor | None = None):
    """One volume (B,H,W2,W3) corrupted where mask (B,H,W2,1) is 1, blended
    in the volume's dtype: "roll" takes the volume rolled by `shift` along
    W2, "noise" scales it by `noise` (B,H,W2,1) in [0, 1), "zero" by a
    Gaussian curve peaked at zero disparity, of height max(vol) over the
    global batch.  Detached, as the reference detaches the blended result."""
    m = mask.to(vol.dtype)
    if kind == "roll":
        out = vol * (1 - m) + torch.roll(vol, shift, dims=2) * m
    elif kind == "noise":
        out = vol * (1 - m) + vol * noise.to(vol.dtype) * m
    elif kind == "zero":
        peak = all_reduce_max(vol.max().reshape(1))[0]
        curve = gauss_corr_volume(torch.zeros_like(mask[..., 0]).unsqueeze(1), peak).to(vol.dtype)
        out = vol * (1 - m) + vol * curve * m
    else:
        raise ValueError(f"unknown corruption {kind!r}")
    return out.detach()


def _classifier(ch: int) -> nn.Conv3d:
    conv = nn.Conv3d(ch, 1, 3, padding=1, bias=False)
    conv.init_kind = LECUN
    return conv


def hourglass_stack(cfg: StereoAnywhereConfig) -> nn.ModuleList:
    """The stacked hourglasses after a volume's first, under the reference's
    names `hourglass_{mono,stereo}_stack.N`: entry 0 is the reference's
    `HourglassIdentity` (no parameters), entries 1 .. n-1 hourglasses.  The
    reference builds n + 1 entries and runs the first n, so its last
    hourglass, `stack.n`, never runs: the JAX package's model has no
    variables for it, and neither has this list (a reference checkpoint's
    `stack.n` is dropped on load: `unused_stack_entries`)."""
    n = cfg.n_additional_hourglass
    return nn.ModuleList([nn.Identity()] + [Hourglass(cfg.volume_channels, cfg.volume_channels) for _ in range(1, n)])


def unused_stack_entries(cfg: StereoAnywhereConfig) -> tuple[str, ...]:
    """The name prefixes of a reference checkpoint's never-applied stack
    entries for `cfg` (see `hourglass_stack`)."""
    n = cfg.n_additional_hourglass
    if not n:
        return ()
    return tuple(f"hourglass_{v}_stack.{n}." for v in ("mono", "stereo"))


class StereoAnywhere(nn.Module):
    """The stereo network.  `device` defaults to the card and raises without
    one unless "cpu" is asked for; weights are random from `generator`
    (default seed 0) until loaded.  The parameters are held in
    `param_dtype`, by default the compute dtype; a trainer in mixed
    precision holds f32 masters (`train/trainer.py`).  On a CUDA device
    the 2-D convolution weights are held channels-last, and with them the
    stage's activations (`memory_format`)."""

    def __init__(
        self,
        cfg: StereoAnywhereConfig = StereoAnywhereConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        param_dtype: torch.dtype | None = None,
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
        if cfg.n_additional_hourglass > 1:
            self.hourglass_mono_stack = hourglass_stack(cfg)
        if cfg.use_aggregate_stereo_vol:
            if cfg.vol_downsample > 0:
                raise ValueError(
                    "use_aggregate_stereo_vol with vol_downsample > 0: the JAX package downsamples the masks but "
                    "not the stereo volume, and its forward fails on the shapes; the port refuses the combination")
            self.hourglass_stereo = Hourglass(cfg.vol_n_masks, cfg.volume_channels)
            if cfg.n_additional_hourglass > 1:
                self.hourglass_stereo_stack = hourglass_stack(cfg)
            self.classifier_stereo = _classifier(cfg.volume_channels)
        init_weights(self, generator or torch.Generator().manual_seed(0))
        self.to(device=dev, dtype=param_dtype or torch_dtype(cfg.compute_dtype))
        if dev.type == "cuda":
            channels_last_weights(self)

    @property
    def memory_format(self) -> torch.memory_format:
        """The stage's 2-D activations' memory format: its convolution
        weights' (`layers.channels_last_weights`)."""
        return channels_last_format(self.context_zqr_convs[0].weight) or torch.contiguous_format

    def fused_step_used(self, net0_shape) -> bool:
        """The JAX package's gate for the rotated, fused loop
        (`models/stereoanywhere.py:554-562`), with its barrel condition read
        as `lookup_impl == "barrel"`; net0_shape is the quarter-resolution
        hidden state's (B,C,H,W) shape."""
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

    @staticmethod
    def _global_shape(t: torch.Tensor) -> tuple[int, ...]:
        """A (B,C,H,W) tensor's shape over the whole image: its rows are the
        rank's under a row group, whose height the JAX gate sees."""
        g = halo.active()
        return tuple(t.shape) if g is None else (*t.shape[:2], g.span(t.shape[2])[0], t.shape[3])

    def forward(self, image2, image3, mde2, mde3, iters: int = 32, test_mode: bool = True,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Test mode runs without autograd and returns `disparity`; train mode
        runs with it and also returns `disparities` (iters, B, H, W, 1), every
        iteration's upsampled disparity.  Both return the coarse outputs,
        scale and shift.  `generator`, a host generator, draws the train
        mode's volume corruption (when `volume_corruption_prob` > 0)."""
        if test_mode:
            with torch.no_grad():
                return self._forward(image2, image3, mde2, mde3, iters, True, None)
        if self.cfg.volume_corruption_prob > 0 and generator is None:
            raise ValueError("the train-mode forward corrupts its volumes: give it a host torch.Generator")
        with batch_statistics(self, not self.cfg.freeze_bn):
            return self._forward(image2, image3, mde2, mde3, iters, False, generator)

    def _corrupt_volumes(self, stereo_vol, mono_vol, mde2_low, w4: int, generator: torch.Generator):
        """The JAX package's `_corrupt_volumes`: one of six corruptions or none,
        drawn from `generator` (the branch, mask and shift on the host; the
        noise on the volumes' device from a seed drawn from it, so nothing
        waits for the device).  The noise is the global batch's draw, of
        which each rank takes its own rows.  Only the corrupted volume is
        detached."""
        cfg = self.cfg
        branch, mask_index, shift = draw_corruption(cfg.volume_corruption_prob, cfg.vol_aug_n_masks, w4, generator)
        if branch == 6:
            return stereo_vol, mono_vol
        which, kind = CORRUPTIONS[branch].split()
        mask = generate_masks(mde2_low, cfg.vol_aug_n_masks)[:, mask_index, :, :, None]  # (B,H,W2,1)
        noise = None
        if kind == "noise":
            seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
            dev_gen = torch.Generator(device=mask.device).manual_seed(seed)
            rank, world = rank_and_world()
            b = mask.shape[0]
            noise = torch.rand((b * world, *mask.shape[1:]), generator=dev_gen, device=mask.device)
            noise = noise[rank * b:(rank + 1) * b]
        if which == "stereo":
            return corrupt_volume(stereo_vol, kind, mask, shift, noise), mono_vol
        return stereo_vol, corrupt_volume(mono_vol, kind, mask, shift, noise)

    def _forward(self, image2, image3, mde2, mde3, iters: int, test_mode: bool, generator) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        if halo.active() is not None:
            if not test_mode:
                raise ValueError("row sharding runs the test-mode forward only: train mode under a row group "
                                 "is not supported")
        cdt = torch_dtype(cfg.compute_dtype)
        with span("sa.stereo.prepare"):
            image2, image3, mde2, mde3 = (t.permute(0, 3, 1, 2).float() for t in (image2, image3, mde2, mde3))
            b, c, h, w = image2.shape

            # test-mode width alignment (JAX models/stereoanywhere.py:155-169)
            w_orig = None
            if test_mode and cfg.width_pad_align and w >= cfg.width_pad_min and w % cfg.width_pad_align != 0:
                w_orig = w
                w = -(-w // cfg.width_pad_align) * cfg.width_pad_align
                pad = (0, w - w_orig, 0, 0)
                image2, image3, mde2, mde3 = (F.pad(t, pad, mode="replicate") for t in (image2, image3, mde2, mde3))
            # a fresh copy in the model's format whatever the caller's strides,
            # so that the same shapes take the same kernels and round alike
            # (direct, tiled and row-sharded runs): a caller's other strides, or
            # a one-channel depth map's, which fit both formats, would take others
            fmt = self.memory_format
            image2, image3, mde2, mde3 = (t.clone(memory_format=fmt) for t in (image2, image3, mde2, mde3))

            f = cfg.downsample_factor
            h4, w4 = h // f, w // f
            if c == 1:
                image2, image3 = (t.contiguous(memory_format=fmt) for t in joint_minmax_normalize(
                    [image2.expand(-1, 3, -1, -1), image3.expand(-1, 3, -1, -1)]))
            image2 = image2 * 2.0 - 1.0
            image3 = image3 * 2.0 - 1.0

            # mono pyramids
            mde2_low = resize_bilinear_align_corners(mde2, (h4, w4))
            mde3_low = resize_bilinear_align_corners(mde3, (h4, w4))
            # vol_downsample: the hourglass's depth pyramids start from 1/2^v of
            # the full resolution (JAX :187-191)
            vf = 2 ** cfg.vol_downsample
            if cfg.vol_downsample > 0:
                mde2_vlow = resize_bilinear_align_corners(mde2, (h // vf, w // vf))
                mde3_vlow = resize_bilinear_align_corners(mde3, (h // vf, w // vf))
            else:
                mde2_vlow, mde3_vlow = mde2, mde3
            normal_gain = w4 / cfg.normal_gain
            normals2 = estimate_normals(mde2_low, normal_gain)
            normals3 = estimate_normals(mde3_low, normal_gain)

        with span("sa.stereo.context"):
            # context encoder on the left mono depth
            cnet_out = self.cnet(mde2.to(cdt))
            net = [torch.tanh(o[0]) for o in cnet_out]
            # the injections (cz, cr, cq) that every iteration reads, each made
            # contiguous in the model's format once: a chunk along C is a
            # strided view
            inp = [
                tuple(t.contiguous(memory_format=fmt)
                      for t in torch.chunk(row_conv(conv, F.relu(o[1])), 3, dim=1))
                for conv, o in zip(self.context_zqr_convs, cnet_out)
            ]

        with span("sa.stereo.features"):
            # feature encoder, both views as one batch
            fmaps = self.fnet(torch.cat([image2, image3], dim=0).to(cdt))
            fmap2, fmap3 = fmaps[:b], fmaps[b:]

        with span("sa.stereo.volumes"):
            # mono depth pyramids for the hourglass attention, f32 as in JAX: in
            # a bf16 model they promote the hourglass to f32 past its first gate
            hv, wv = mde2_vlow.shape[-2:]
            sizes = [(hv // 2 ** i, wv // 2 ** i) for i in range(cfg.n_downsample, 6)]
            fmde2 = [resize_bilinear_align_corners(mde2_vlow, size) for size in sizes]
            fmde3 = [resize_bilinear_align_corners(mde3_vlow, size) for size in sizes]

            # all-pairs volumes
            stereo_vol = all_pairs_correlation(fmap2, fmap3)  # (B,H4,W2,W3)
            mono_vol = (1.73 * all_pairs_correlation(normals2.to(cdt), normals3.to(cdt))).float()
            left_masks = generate_masks(mde2_low, cfg.vol_n_masks)
            right_masks = generate_masks(mde3_low, cfg.vol_n_masks)
            # vol_downsample: the mono volume (trilinear) and the masks (nearest)
            # at 1/2^v on each axis (JAX :248-253)
            orig_vol_dhw = tuple(mono_vol.shape[1:])
            if cfg.vol_downsample > 0:
                tgt = tuple(s // vf for s in orig_vol_dhw)
                mono_vol = resize_trilinear_align_corners(mono_vol, tgt, row_axis=-3)
                left_masks = resize_nearest(left_masks, (tgt[0], tgt[1]))
                right_masks = resize_nearest(right_masks, (tgt[0], tgt[2]))

        # the stereo-volume aggregation (JAX :265-320): the masked stereo
        # volume -> its hourglass and stack -> its classifier, whose volume
        # replaces the raw one in the loop; its coarse disparities are
        # outputs (and loss terms)
        agg_disp_stereo = None
        if cfg.use_aggregate_stereo_vol:
            with span("sa.stereo.aggregate"):
                agg_s = self.hourglass_stereo(masked_volume(stereo_vol.float(), left_masks, right_masks).to(cdt),
                                              fmde2, fmde3)
                for hourglass in getattr(self, "hourglass_stereo_stack", [])[1:]:
                    agg_s = hourglass(agg_s, fmde2, fmde3)
                agg_s = agg_s.permute(0, 1, 3, 4, 2)  # (B,C,W3,H,W2) -> (B,C,H,W2,W3)
                agg_disp_stereo = conv_in_dtype(self.classifier_stereo, agg_s, row_axis=-3).float()[:, 0]
                coarse_dispstereo2, coarse_dispstereo3 = (
                    resize_bilinear_align_corners(est(agg_disp_stereo), (h, w)) * f
                    for est in (estimate_left_disparity, estimate_right_disparity))

        with span("sa.stereo.hourglass"):
            # masked mono volume -> hourglass (and stack: JAX :345-357) ->
            # classifiers over (H, W2, W3); the confidence classifier's input is
            # detached (JAX :388, :399)
            agg = self.hourglass_mono(masked_volume(mono_vol, left_masks, right_masks).to(cdt), fmde2, fmde3)
            for hourglass in getattr(self, "hourglass_mono_stack", [])[1:]:
                agg = hourglass(agg, fmde2, fmde3)
            agg = agg.permute(0, 1, 3, 4, 2)  # (B,C,W3,H,W2) -> (B,C,H,W2,W3)
            agg_disp = conv_in_dtype(self.classifier_mono, agg, row_axis=-3).float()[:, 0]  # (B,H,W2,W3)
            agg_conf = conv_in_dtype(self.classifier_monoconf, agg.detach(), row_axis=-3).float()[:, 0]
            if cfg.vol_downsample > 0:  # back to (H4, W4, W4) (JAX :404-406)
                agg_disp = resize_trilinear_align_corners(agg_disp, orig_vol_dhw, row_axis=-3)
                agg_conf = resize_trilinear_align_corners(agg_conf, orig_vol_dhw, row_axis=-3)

        with span("sa.stereo.coarse"):
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

            # mirror detection: the stereo volume's truncation mask (detached, JAX :445)
            trunc_mask = None
            if cfg.use_truncate_vol:
                mirror_conf = handcrafted_mirror_detector(
                    coarse_dispmono2_low, scaled_mde2_low, dispconf2_low, lrc_scaled2_low, conf_th=cfg.mirror_conf_th
                )
                trunc_mask = truncate_corr_volume(scaled_mde2_low, mirror_conf, None, cfg.mirror_attenuation).detach()
            if agg_disp_stereo is not None:  # JAX :451
                stereo_vol = agg_disp_stereo
            mono_src = agg_disp if cfg.use_aggregate_mono_vol else mono_vol
            # the train mode's volume corruption, before the truncation (JAX :454-462)
            if not test_mode and cfg.volume_corruption_prob > 0:
                stereo_vol, mono_src = self._corrupt_volumes(stereo_vol, mono_src, mde2_low, w4, generator)
            if trunc_mask is not None:
                stereo_vol = trunc_mask * stereo_vol
            stereo_levels = build_corr_pyramid(stereo_vol.to(cdt).contiguous(), cfg.corr_levels)
            mono_levels = build_corr_pyramid(mono_src.to(cdt).contiguous(), cfg.corr_levels)
            if test_mode:
                # contiguous levels: the K5 kernel reads rows of them.  Checked,
                # and its pointer arrays built, once for all the forward's lookups
                pyramids = DualPyramid(stereo_levels, mono_levels)
            else:
                pyramids = (stereo_levels, mono_levels)  # the plain gather, differentiable

        with span("sa.stereo.loop"):
            # iterative refinement (the JAX nn.scan, as a loop)
            coords0 = torch.arange(w4, device=image2.device, dtype=torch.float32).view(1, 1, 1, w4).expand(b, 1, h4, w4)
            coords1 = coords0 if cfg.init_disparity_zero else coords0 - scaled_mde2_low
            net = [n.to(cdt) for n in net]
            inp = [tuple(t.to(cdt) for t in triple) for triple in inp]
            lookup_impl = cfg.resolved_lookup_impl
            mask = None
            flows, masks = [], []
            if not test_mode:
                # every iteration's flow and mask head (JAX emit_outputs)
                for _ in range(iters):
                    net, coords1, mask = refinement_step(
                        self.update_block, net, inp, pyramids, coords1, coords0, cfg.corr_radius,
                        compute_mask=True, lookup_impl=lookup_impl,
                    )
                    flows.append(coords1 - coords0)
                    masks.append(mask.float())
            elif iters >= 1 and self.fused_step_used(self._global_shape(net[0])):
                net = update_nets(self.update_block, net, inp, pyramids, coords1, coords0, cfg.corr_radius, lookup_impl)
                if iters > 1:
                    ws = self.update_block.fused_weights(cdt)
                    net_h = [n.permute(0, 2, 3, 1).contiguous() for n in net]
                    czrq = [torch.cat(triple, dim=1).permute(0, 2, 3, 1).contiguous() for triple in inp]
                    x = coords1[:, 0].contiguous()
                    for _ in range(iters - 1):
                        net_h, x = fused_refinement_step(ws, net_h, czrq, pyramids, x, cfg.corr_radius)
                    net = [n.permute(0, 3, 1, 2) for n in net_h]
                    coords1 = x[:, None]
                net, coords1, mask = refinement_tail(self.update_block, net, coords1, compute_mask=True)
            else:
                for it in range(iters):
                    net, coords1, mask = refinement_step(
                        self.update_block, net, inp, pyramids, coords1, coords0, cfg.corr_radius,
                        compute_mask=it == iters - 1, lookup_impl=lookup_impl,
                    )

        with span("sa.stereo.upsample"):
            to_nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
            result = {}
            if test_mode:
                disparity = -convex_upsample(coords1 - coords0, mask.float(), cfg.n_downsample)
                if w_orig is not None:
                    disparity = disparity[..., :w_orig]
                result["disparity"] = to_nhwc(disparity)
            else:
                ups = convex_upsample(torch.cat(flows), torch.cat(masks), cfg.n_downsample)  # (iters*B,1,H,W)
                result["disparities"] = -to_nhwc(ups).reshape(iters, b, h, w, 1)
                result["disparity"] = result["disparities"][-1]
            if agg_disp_stereo is not None:  # JAX :683-685
                result.update(coarse_dispstereo2=to_nhwc(coarse_dispstereo2),
                              coarse_dispstereo3=to_nhwc(coarse_dispstereo3))
            result.update(
                coarse_dispmono2=to_nhwc(coarse_dispmono2),
                coarse_dispmono3=to_nhwc(coarse_dispmono3),
                coarse_scaled_mde2=to_nhwc(scaled_mde2),
                coarse_scaled_mde3=to_nhwc(scaled_mde3),
                coarse_conf2=to_nhwc(coarse_conf2),
                coarse_conf3=to_nhwc(coarse_conf3),
                scale=scale,
                shift=shift,
            )
        return result
