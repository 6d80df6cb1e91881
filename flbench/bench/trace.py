"""The device trace of a few whole rounds, and what is read from it.

:func:`profile_rounds` runs rounds under ``torch.profiler`` (CPU and CUDA
activity), each inside a ``flbench.round`` range, exports the Chrome
trace under ``TMPDIR`` and reduces it with :func:`reduce_trace`, then
deletes the file.  The window is from the first round's start to the
last round's end; the device is busy where any kernel, copy or memset
runs, the union of their intervals (overlapping kernels count once).
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list[dict]) -> dict:
    """Window, busy time, kernel time by name and idle gaps by host phase
    (seconds) from Chrome-trace events (microseconds)."""
    rounds = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == "flbench.round" and "dur" in e]
    if not rounds:
        return {}
    w0, w1 = min(s for s, _ in rounds), max(e for _, e in rounds)
    dev, by_name = [], defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                dev.append((s, t))
                if e["cat"] == "kernel":
                    by_name[e["name"]] += (t - s) * 1e-6
    phases = [(e["ts"], e["ts"] + e["dur"], e["name"][len("flbench."):])
              for e in events if e.get("name", "").startswith("flbench.")
              and e.get("name") != "flbench.round" and "dur" in e]
    gaps = defaultdict(float)
    busy = merged(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        inside = [p for p in phases if p[0] <= mid <= p[1]]
        gaps[inside[0][2] if inside else "round_loop"] += (t - s) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": union_length(dev) * 1e-6,
            "kernels": dict(by_name),
            "idle_by_phase": dict(gaps)}


def device_by_phase(events: list[dict]) -> dict:
    """Device seconds (the union of their intervals) of the kernels,
    copies and memsets launched inside each ``flbench.<phase>``
    annotation but the round, by phase: a device event is tied to its
    runtime launch by the trace's ``correlation`` and goes to the
    innermost annotation around the launch on the host."""
    phases = [(e["ts"], e["ts"] + e["dur"], e["name"][len("flbench."):])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("flbench.")
              and e["name"] != "flbench.round" and "dur" in e]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    by = defaultdict(list)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        inside = [p for p in phases if t is not None and p[0] <= t <= p[1]]
        if inside:
            name = min(inside, key=lambda p: p[1] - p[0])[2]
            by[name].append((e["ts"], e["ts"] + e["dur"]))
    return {k: union_length(v) * 1e-6 for k, v in by.items()}


def profile_rounds(step, n_rounds: int, reducers: dict | None = None
                   ) -> dict:
    """Run ``step()`` ``n_rounds`` times under the profiler; the reduced
    trace, with ``{key: reducer(events)}`` beside it for each of
    ``reducers``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(n_rounds):
            with record_function("flbench.round"):
                step()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="flbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = reduce_trace(events)
    for key, fn in (reducers or {}).items():
        out[key] = fn(events)
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
