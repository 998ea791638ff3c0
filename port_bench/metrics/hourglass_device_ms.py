"""Stereo stage: device ms a pair of the kernels inside the eager pass's
`hourglass` range (the mono hourglass and the classifiers after it)."""
from port_bench.trace import kernels_within


def read(ctx):
    seg = ctx.eager
    if seg is None or not seg.ranges["hourglass"] or not seg.kernels:
        return None
    return kernels_within(seg.kernels, seg.ranges["hourglass"]) / 1e3 / seg.pairs
