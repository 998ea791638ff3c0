"""Device: the model's FLOPs for one pair (`flops.pair_flops`, the plain
reference counted on the meta device) over the mean traced graph pair's
wall time times the bf16 peak of 989 TFLOP/s, in %."""
from port_bench import flops


def read(ctx):
    seg = ctx.graph
    if seg is None or not seg.host["pair"]:
        return None
    mean_s = sum(e - s for s, e in seg.host["pair"]) / len(seg.host["pair"]) / 1e6
    m = ctx.config["mono"]
    work = flops.pair_flops(m["encoder"], ctx.mix["height"], ctx.mix["width"], ctx.config["iters"],
                            (m["input_size"],) * 2)
    return 100.0 * work / (mean_s * flops.PEAK_BF16_FLOPS)
