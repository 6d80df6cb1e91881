"""The whole round's share of the chip's peak: the operations a profiled
round computed (``ctx["shape"]["flops"]`` over the profiled rounds,
counted by the program's module from the configuration's shapes) over
the window's seconds a round times the peak ``ctx["shape"]["peak"]``
names (``roofline/peaks.json``: 67 TFLOP/s float32 for the FL round's
CNNs, 989 TFLOP/s bf16 for a pod step's bf16 weights), in percent.  The
window's rounds run without the profiler, whose own cost on the host
would otherwise lengthen the round."""
from roofline import PEAKS


def read(ctx):
    shape, tr = ctx.get("shape") or {}, ctx.get("trace") or {}
    if not (shape.get("flops") and tr.get("busy_s")
            and ctx.get("window_rounds")):
        return None
    per_round = shape["flops"] / ctx["profiled_rounds"]
    round_s = ctx["window_s"] / ctx["window_rounds"]
    return 100.0 * per_round / (round_s * PEAKS[shape["peak"]])
