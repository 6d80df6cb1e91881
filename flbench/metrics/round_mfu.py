"""The whole round's share of the float32 peak: training FLOPs (3 x each
trained device's forward at its own width over its samples) plus the
evaluation's forward, over the profiled rounds' length times 67 TFLOP/s,
in percent."""
from roofline import PEAKS


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("window_s") or not ctx["shape"].get("flops"):
        return None
    return 100.0 * ctx["shape"]["flops"] / (tr["window_s"]
                                            * PEAKS["f32_flops_per_s"])
