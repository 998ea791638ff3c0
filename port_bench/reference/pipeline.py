"""The served pipeline in plain PyTorch: (1,H,W,3) views in [0,1] -> the
(1,H,W,1) disparity.

1. both views to DAv2's input size (`jax.image.resize` cubic, antialiased),
   ImageNet-normalized, DAv2 on the two as one batch, the depth back to
   (H, W) (`jax.image.resize` bilinear);
2. the two depth maps min-max normalized jointly, views and depth
   edge-padded to a multiple of 32;
3. StereoAnywhere, then the padding cut off.

A frozen copy of `stereoanywhere_tpu_torch/serve/pipeline.py`'s
arithmetic, which it does not import.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import ops
from port_bench.reference.dav2 import DepthAnythingV2, dav2_input_size, imagenet_normalize
from port_bench.reference.stereo import StereoAnywhere


def pad_sizes(h: int, w: int, multiple: int = 32) -> tuple[int, int, int, int]:
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


class ReferencePipeline(torch.nn.Module):
    def __init__(self, stereo: StereoAnywhere, mono: DepthAnythingV2, iters: int,
                 mono_size: tuple[int, int] = (518, 518)):
        super().__init__()
        self.stereo, self.mono, self.iters, self.mono_size = stereo, mono, iters, mono_size

    def mono_stage(self, im2, im3):
        """(B,H,W,3) pair -> two (B,1,H,W) depth maps."""
        b, h, w, _ = im2.shape
        fh, fw = dav2_input_size(h, w, *self.mono_size)
        both = torch.cat([im2, im3], dim=0).permute(0, 3, 1, 2)
        depth = self.mono(imagenet_normalize(ops.resize_jax_image(both, (fh, fw), "cubic")))
        depth = ops.resize_jax_image(depth, (h, w), "bilinear")
        return depth[:b], depth[b:]

    @torch.no_grad()
    def forward(self, im2, im3):
        _, h, w, _ = im2.shape
        mde2, mde3 = ops.joint_minmax_normalize(list(self.mono_stage(im2, im3)))
        t, bot, left, right = pad_sizes(h, w)
        pad = lambda x: F.pad(x, (left, right, t, bot), mode="replicate").permute(0, 2, 3, 1)  # noqa: E731
        views = [pad(x.permute(0, 3, 1, 2)) for x in (im2, im3)]
        disparity = self.stereo(*views, pad(mde2), pad(mde3), iters=self.iters)
        return disparity[:, t:t + h, left:left + w]
