"""Mono stage: device ms a pair of the kernels inside the eager pass's
`mono.depth_head` range (the DPT head)."""
from port_bench.trace import kernels_within


def read(ctx):
    seg = ctx.eager
    if seg is None or not seg.ranges["mono.depth_head"] or not seg.kernels:
        return None
    return kernels_within(seg.kernels, seg.ranges["mono.depth_head"]) / 1e3 / seg.pairs
