"""Device milliseconds a step in the routed experts' grouped GEMMs: the
profiled rounds' kernel time of the kernels that ``roofline/grouped_mm``'s
``PATTERNS`` match (``bench/trace.reduce_trace``'s sums by name), over
those rounds; None where none ran (a program without them)."""
import re

from roofline import grouped_mm


def read(ctx):
    kernels = (ctx.get("trace") or {}).get("kernels") or {}
    t = sum(v for k, v in kernels.items()
            if any(re.search(p, k) for p in grouped_mm.PATTERNS))
    if not t or not ctx.get("profiled_rounds"):
        return None
    return 1e3 * t / ctx["profiled_rounds"]
