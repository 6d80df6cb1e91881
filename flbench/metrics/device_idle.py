"""Share of the window's rounds in which no kernel, copy or memset runs
on the device, in percent: one minus the device's busy time a round in
the profiled rounds (the union of their intervals in the trace) over the
window's seconds a round.  The window's rounds run without the profiler,
whose own cost on the host would otherwise count as the device's idle
time."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not ctx.get("window_rounds"):
        return None
    busy = tr["busy_s"] / ctx["profiled_rounds"]
    return 100.0 * (1.0 - busy * ctx["window_rounds"] / ctx["window_s"])
