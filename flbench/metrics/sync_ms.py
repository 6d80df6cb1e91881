"""Device milliseconds a step in the gradient sync across pods
(``core/distributed.anycost_gradient_sync``): the union of the device
intervals of the kernels, copies and memsets launched inside its
``flbench.sync`` annotation in the profiled rounds
(``bench/trace.device_by_phase``), over those rounds."""


def read(ctx):
    phases = (ctx.get("trace") or {}).get("device_by_phase") or {}
    if "sync" not in phases:
        return None
    return 1e3 * phases["sync"] / ctx["profiled_rounds"]
