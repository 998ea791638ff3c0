"""Stereo stage: device ms a pair of the kernels inside the eager pass's
`loop` range (every refinement iteration with its glue: lookups, motion
encoder, the three ConvGRUs, pooling and resizes, flow and mask heads)."""
from port_bench.trace import kernels_within


def read(ctx):
    seg = ctx.eager
    if seg is None or not seg.ranges["loop"] or not seg.kernels:
        return None
    return kernels_within(seg.kernels, seg.ranges["loop"]) / 1e3 / seg.pairs
