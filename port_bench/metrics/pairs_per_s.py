"""Pairs served in the window over the window's seconds (the window runs
from its first request to the end of its last)."""


def read(ctx):
    return len(ctx.latencies_s) / ctx.window_s if ctx.window_s > 0 else None
