"""Device: the share of the traced graph pairs' stretch (first request's
start to last request's end) in which no kernel ran, in %; memory copies
count as idle."""
from port_bench.trace import busy_us, clipped


def read(ctx):
    seg = ctx.graph
    if seg is None or not seg.kernels or not seg.host["pair"]:
        return None
    lo = min(s for s, _ in seg.host["pair"])
    hi = max(e for _, e in seg.host["pair"])
    busy = busy_us(clipped([(s, e) for _, s, e in seg.kernels], lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))
