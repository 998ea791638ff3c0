"""Programs: kernels a request runs in the graph's replay, from the traced
graph pairs (copies not counted)."""


def read(ctx):
    seg = ctx.graph
    return len(seg.kernels) / seg.pairs if seg is not None and seg.kernels else None
