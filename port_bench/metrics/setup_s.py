"""Seconds from the process's start to the first timed request: imports,
the kernels' build (or its cache), the models and their weights, the
pool of pairs, the shape's eager call and capture, a replay of each pair."""


def read(ctx):
    return ctx.setup_s
