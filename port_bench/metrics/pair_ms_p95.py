"""95th percentile over every pair served in the window of its wall time
(ms), numpy's linear interpolation between order statistics."""
import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.latencies_s, 95)) if ctx.latencies_s else None
