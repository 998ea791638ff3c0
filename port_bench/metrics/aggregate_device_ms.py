"""Stereo stage: device ms a pair of the kernels that the eager pass
launched inside the port's `sa.stereo.aggregate` span (the stereo-volume
aggregation branch: the masked stereo volume, `hourglass_stereo`, its
stack, `classifier_stereo` and the branch's coarse disparities), from
`Segment.spans`.  A configuration without the branch, or an eager pass
that launched no kernel inside the span, reads 0 ms (the card test holds
it above 0 on the branch's cell)."""
from port_bench.trace import busy_us

SPAN = "sa.stereo.aggregate"


def read(ctx):
    if not ctx.config["stereo"].get("use_aggregate_stereo_vol", False):
        return 0.0
    seg = ctx.eager
    if seg is None or not seg.kernels:
        return None
    return busy_us((s, e) for _, s, e in seg.spans.get(SPAN, [])) / 1e3 / seg.pairs
