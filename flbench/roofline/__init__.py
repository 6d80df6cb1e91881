"""Operation and byte counts of the port's hand-written kernels, one module
each, and the table of peaks they are held against.

A kernel module names the CUDA functions that belong to it
(``PATTERNS``, searched in the profiler's kernel names), the program's
launch counter it reads (``COUNTER``), and ``cost(shape, launches)``:
the bytes each input is read once and each output written once, and the
float32 operations, over ``launches`` launches at the cell's shapes
(``shape``: ``N`` elements of an update, ``K`` kernels of FGC,
``agg``, the (rows, elements) of each Eq. 5 launch's stack, in order,
and ``folds``, the edge accumulators the absorbs filled).
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def kernel(name: str):
    return importlib.import_module(f"roofline.{name}")


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time: bytes at the HBM rate or float32 operations at the
    float32 peak, whichever is longer."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               n_flops / PEAKS["f32_flops_per_s"])


def roofline_share(names: list[str], ctx: dict):
    """Sum of bound times over sum of device times of the named kernels
    in the profiled rounds, in percent; None where none of them ran."""
    trace, launches = ctx.get("trace") or {}, ctx.get("launches") or {}
    bound = device = 0.0
    for name in names:
        mod = kernel(name)
        n = launches.get(mod.COUNTER, 0)
        if n == 0:
            continue
        bound += bound_s(*mod.cost(ctx["shape"], n))
        device += sum(t for k, t in trace.get("kernels", {}).items()
                      if any(re.search(p, k) for p in mod.PATTERNS))
    if bound == 0.0 or device == 0.0:
        return None
    return 100.0 * bound / device
