"""Stereo stage: device ms a pair of the kernels that the eager pass
launched inside the port's own `sa.stereo.context` span (the context
encoder and its zqr convolutions) and `sa.stereo.features` span (the
feature encoder on both views), from `Segment.spans`.  An eager pass that
launched no kernel inside them reads 0 ms (a renamed span reads 0: the
card test holds it above 0)."""
from port_bench.trace import busy_us

SPANS = ("sa.stereo.context", "sa.stereo.features")


def read(ctx):
    seg = ctx.eager
    if seg is None or not seg.kernels:
        return None
    return busy_us((s, e) for name in SPANS for _, s, e in seg.spans.get(name, [])) / 1e3 / seg.pairs
