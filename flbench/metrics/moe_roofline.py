"""The routed experts' grouped GEMMs against their roofline, in percent:
the least time of their work (the longer of its bytes at the HBM rate and
its operations at the bf16 peak, ``roofline/grouped_mm.cost`` over the
program's ``grouped_mm_*`` launch counters in the profiled rounds) over
the device time of the kernels ``PATTERNS`` match; None where the
program counted or ran none."""
import re

from roofline import PEAKS, grouped_mm


def read(ctx):
    launches = ctx.get("launches") or {}
    kernels = (ctx.get("trace") or {}).get("kernels") or {}
    if not launches.get(grouped_mm.COUNTER):
        return None
    device = sum(v for k, v in kernels.items()
                 if any(re.search(p, k) for p in grouped_mm.PATTERNS))
    if not device:
        return None
    n_bytes, n_flops = grouped_mm.cost(launches)
    bound = max(n_bytes / PEAKS["hbm_bytes_per_s"],
                n_flops / PEAKS["bf16_flops_per_s"])
    return 100.0 * bound / device
