"""Share of the profiled rounds in which no kernel, copy or memset runs on
the device, in percent."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
