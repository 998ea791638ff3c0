"""Median over every pair served in the window of its wall time, host
arrays handed to `__call__` -> the host disparity held (ms)."""
import statistics


def read(ctx):
    return 1e3 * statistics.median(ctx.latencies_s) if ctx.latencies_s else None
