"""Kernels: the least time of the attention cores, softmax(q k^T / sqrt(hd)) v
of every head of every block for both views (`flops.attention_least_ms`),
over the device ms inside the eager pass's `vit_attention` ranges, in %."""
from port_bench import flops
from port_bench.trace import kernels_within


def read(ctx):
    seg = ctx.eager
    if seg is None or not seg.ranges["vit_attention"] or not seg.kernels:
        return None
    ms = kernels_within(seg.kernels, seg.ranges["vit_attention"]) / 1e3 / seg.pairs
    m = ctx.config["mono"]
    t = flops.tokens(ctx.mix["height"], ctx.mix["width"], (m["input_size"],) * 2)
    least = flops.attention_least_ms(2, t, m["embed_dim"], m["num_heads"], m["depth"])
    return 100.0 * least / ms if ms > 0 else None
