"""Kernels: the least time of the stereo-volume aggregation branch's 3-D
convolutions over `aggregate_device_ms`, in %.

The work is counted on the configuration's plain reference, on the meta
device, at the pair's padded shape: every 3-D convolution that runs inside
its `stereo_volume` (`hourglass_stereo`, its stack, `classifier_stereo`),
whatever implements them in the port.  A convolution needs
2 Cin Cout k^3 FLOPs an output voxel and moves its input, its output and
its weights once, in bf16; the least time is `flops.least_ms` of the sums.
The gates, resizes, norms and the masked volume are left out, so the share
cannot pass 100%.  A configuration without the branch reads 0."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from port_bench import flops, reference
from port_bench.harness import load_reader


class _Conv3dLog(TorchDispatchMode):
    """(FLOPs, elements moved) of each 3-D convolution dispatched while
    `inside` is set."""

    def __init__(self):
        super().__init__()
        self.inside, self.convs = False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.inside and func is torch.ops.aten.convolution.default and args[0].dim() == 5:
            x, w = args[0], args[1]
            self.convs.append((2.0 * w.numel() * out.numel() / w.shape[0], x.numel() + w.numel() + out.numel()))
        return out


def branch_work(cfg: dict, h: int, w: int, root=reference.REPO) -> tuple[float, float]:
    """(FLOPs, bytes) of the branch's 3-D convolutions for one (H, W) pair:
    the stereo network of the configuration's reference run once on the
    meta device at the pipeline's padded shape."""
    from port_bench.reference.pipeline import pad_sizes

    stereo = reference.build(cfg, root).stereo
    t, bot, left, right = pad_sizes(h, w)
    with torch.device("meta"):
        view = torch.empty((1, h + t + bot, w + left + right, 3))
        depth = torch.empty((1, h + t + bot, w + left + right, 1))
    log, inner = _Conv3dLog(), stereo.stereo_volume

    def logged(*args):
        log.inside = True
        try:
            return inner(*args)
        finally:
            log.inside = False

    stereo.stereo_volume = logged
    with torch.no_grad(), log:
        stereo(view, view, depth, depth, iters=1)
    return sum(f for f, _ in log.convs), flops.BF16 * sum(m for _, m in log.convs)


def read(ctx):
    if not ctx.config["stereo"].get("use_aggregate_stereo_vol", False):
        return 0.0
    ms = load_reader("aggregate_device_ms", ctx.root)(ctx)
    if ms is None or ms <= 0:
        return ms
    work = branch_work(ctx.config, ctx.mix["height"], ctx.mix["width"], ctx.root)
    return 100.0 * flops.least_ms(*work) / ms
