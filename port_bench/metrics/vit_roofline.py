"""Kernels: the least time of the ViT blocks' work at the pair's shapes
(both views; every product and the attention core at max(FLOPs / 989
TFLOP/s, bytes / 3.35 TB/s), `flops.vit_least_ms`) over the device ms
inside the eager pass's `mono.pretrained` range, in %."""
from port_bench import flops
from port_bench.trace import kernels_within


def read(ctx):
    seg = ctx.eager
    if seg is None or not seg.ranges["mono.pretrained"] or not seg.kernels:
        return None
    ms = kernels_within(seg.kernels, seg.ranges["mono.pretrained"]) / 1e3 / seg.pairs
    m = ctx.config["mono"]
    t = flops.tokens(ctx.mix["height"], ctx.mix["width"], (m["input_size"],) * 2)
    least = flops.vit_least_ms(2, t, m["embed_dim"], m["num_heads"], m["depth"], m["ffn"])
    return 100.0 * least / ms if ms > 0 else None
