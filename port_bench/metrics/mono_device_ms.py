"""Mono stage: device ms a pair of the kernels inside the eager pass's
`mono.pretrained` and `mono.depth_head` ranges (DINOv2 and the DPT head)."""
from port_bench.trace import kernels_within


def read(ctx):
    seg = ctx.eager
    spans = [] if seg is None else seg.ranges["mono.pretrained"] + seg.ranges["mono.depth_head"]
    if not spans or not seg.kernels:
        return None
    return kernels_within(seg.kernels, spans) / 1e3 / seg.pairs
