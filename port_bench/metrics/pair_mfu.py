"""Device: the configuration's model's FLOPs for one pair
(`flops.pair_flops`, its plain reference counted on the meta device) over
the mean traced graph pair's wall time times the bf16 peak of 989
TFLOP/s, in %."""
from port_bench import flops


def read(ctx):
    seg = ctx.graph
    if seg is None or not seg.host["pair"]:
        return None
    mean_s = sum(e - s for s, e in seg.host["pair"]) / len(seg.host["pair"]) / 1e6
    work = flops.pair_flops(ctx.config, ctx.mix["height"], ctx.mix["width"], ctx.root)
    return 100.0 * work / (mean_s * flops.PEAK_BF16_FLOPS)
