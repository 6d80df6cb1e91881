"""The device trace read by the program's own spans.

The port's spans (``repro_torch.telemetry.wallclock``) land in a
``torch.profiler`` trace as ``user_annotation`` events on the kernels'
clock.  :func:`reduce_spans` reads the idle device and the host's waits
on it inside the program's ``round`` spans:

* each idle gap (no kernel, copy or memset running) is cut at the span
  boundaries and each piece goes to the innermost program span over it
  (``idle_self``); a span's ``idle`` also holds its children's pieces;
* each CUDA runtime synchronisation (:data:`SYNC_CALLS`) counts for
  every span its host interval lies in (``syncs``).

A program span's tree on the host is one thread's, so the spans nest:
between any two boundaries one span is the innermost.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from bench.trace import DEVICE_CATS, merged

#: runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def segments(spans: list[tuple[float, float, str]]
             ) -> list[tuple[float, float, tuple]]:
    """Cut the time the ``(start, end, name)`` spans cover into pieces,
    each with the path of names from the outermost span over it to the
    innermost.  A span that ends after the one around it is cut at that
    one's end (the clock's rounding)."""
    out = []
    stack: list[tuple[float, tuple]] = []      # (end, path)
    cursor = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, path = stack.pop()
            if end > cursor:
                out.append((cursor, end, path))
                cursor = end
        if stack and s > cursor:
            out.append((cursor, s, stack[-1][1]))
        cursor = s
        if stack:
            stack.append((min(e, stack[-1][0]), stack[-1][1] + (name,)))
        else:
            stack.append((e, (name,)))
    while stack:
        end, path = stack.pop()
        if end > cursor:
            out.append((cursor, end, path))
            cursor = end
    return out


def device_busy(events: list[dict]) -> list[list[float]]:
    """The union of the kernel, copy and memset intervals, in order."""
    return merged((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATS and "dur" in e)


def idle_inside(busy: list[list[float]], s: float, t: float) -> float:
    """How long the device is idle in [s, t] (the trace's unit)."""
    k = max(bisect.bisect_right([b[0] for b in busy], s) - 1, 0)
    covered = 0.0
    while k < len(busy) and busy[k][0] < t:
        covered += max(0.0, min(busy[k][1], t) - max(busy[k][0], s))
        k += 1
    return (t - s) - covered


def reduce_spans(events: list[dict], names) -> dict:
    """Idle device time (seconds) and runtime syncs by program span, over
    the program's ``round`` spans, from Chrome-trace events
    (microseconds); ``names`` are the program's span names."""
    names = set(names)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and "dur" in e
             and e.get("name") in names]
    rounds = merged((s, t) for s, t, n in spans if n == "round")
    if not rounds:
        return {}
    segs = segments(spans)
    starts = [s for s, _, _ in segs]

    def pieces(s, t):
        """The segments over [s, t], cut to it."""
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(segs) and segs[k][0] < t:
            a, b, path = segs[k]
            lo, hi = max(a, s), min(b, t)
            if hi > lo:
                yield lo, hi, path
            k += 1

    busy = device_busy(events)
    idle_self, idle = defaultdict(float), defaultdict(float)
    idle_rounds = 0.0
    j = 0
    for r0, r1 in rounds:
        cur = r0
        while j < len(busy) and busy[j][1] <= r0:
            j += 1
        k = j
        gaps = []
        while cur < r1:
            if k < len(busy) and busy[k][0] < r1:
                if busy[k][0] > cur:
                    gaps.append((cur, busy[k][0]))
                cur = max(cur, busy[k][1])
                k += 1
            else:
                gaps.append((cur, r1))
                cur = r1
        for g0, g1 in gaps:
            idle_rounds += g1 - g0
            for lo, hi, path in pieces(g0, g1):
                idle_self[path[-1]] += (hi - lo) * 1e-6
                for name in set(path):
                    idle[name] += (hi - lo) * 1e-6
    syncs = defaultdict(int)
    for e in events:
        if e.get("cat") != "cuda_runtime" or e.get("name") not in SYNC_CALLS:
            continue
        mid = e["ts"] + 0.5 * e.get("dur", 0.0)
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid < segs[k][1]:
            for name in set(segs[k][2]):
                syncs[name] += 1
    return {"idle_rounds_s": idle_rounds * 1e-6,
            "idle_self": dict(idle_self), "idle": dict(idle),
            "syncs": dict(syncs),
            "sync_events": sum(e.get("cat") == "cuda_runtime"
                               and e.get("name") in SYNC_CALLS
                               for e in events)}
