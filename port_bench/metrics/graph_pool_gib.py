"""Programs: device memory in the pipeline's CUDA-graph pool after the
window, `graph_pool_bytes()` (GiB)."""


def read(ctx):
    return ctx.pool_bytes / 2 ** 30 if ctx.pool_bytes else None
