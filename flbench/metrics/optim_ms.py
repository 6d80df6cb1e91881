"""Device milliseconds a step in the optimizer's update
(``Optimizer.update``): the union of the device intervals of the
kernels, copies and memsets launched inside its ``flbench.optim``
annotation in the profiled rounds (``bench/trace.device_by_phase``),
over those rounds."""


def read(ctx):
    phases = (ctx.get("trace") or {}).get("device_by_phase") or {}
    if "optim" not in phases:
        return None
    return 1e3 * phases["optim"] / ctx["profiled_rounds"]
