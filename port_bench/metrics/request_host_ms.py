"""Serve pipeline: the mean over the traced graph requests of a request's
wall time less the kernels' busy time inside it (ms): conversion, the
copies in and out, the launch of the replay and the waits for them."""
from port_bench.trace import busy_us, clipped


def read(ctx):
    seg = ctx.graph
    if seg is None or not seg.kernels or not seg.host["pair"]:
        return None
    kernels = [(s, e) for _, s, e in seg.kernels]
    host = [(e - s) - busy_us(clipped(kernels, s, e)) for s, e in seg.host["pair"]]
    return sum(host) / len(host) / 1e3
