"""Device milliseconds a step in the pod's forward and backward
(``launch/steps.value_and_grad``): the union of the device intervals of
the kernels, copies and memsets launched inside its ``flbench.grad``
annotation in the profiled rounds (``bench/trace.device_by_phase``),
over those rounds."""


def read(ctx):
    phases = (ctx.get("trace") or {}).get("device_by_phase") or {}
    if "grad" not in phases:
        return None
    return 1e3 * phases["grad"] / ctx["profiled_rounds"]
