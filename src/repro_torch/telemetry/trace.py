"""Structured trace sink: simulated-timeline spans -> Perfetto/JSONL.

The discrete-event orchestrator's timeline is simulated seconds; this
sink collects it as structured **spans** (a named interval on a track:
a device training, an uplink in flight, a backhaul shipment) and
**instants** (a point event: HANDOVER, CHURN, RETRY, EDGE_MERGE), then
exports:

* ``to_perfetto()`` — the Chrome Trace Event JSON that
  `ui.perfetto.dev <https://ui.perfetto.dev>`_ (and ``chrome://tracing``)
  loads directly: one *process* per track group (``devices``, ``cells``,
  ``server``), one *thread* (= timeline row) per device/cell, complete
  ``ph: "X"`` events for spans and ``ph: "i"`` for instants, simulated
  seconds mapped onto microseconds.
* ``write_jsonl()`` — one self-describing JSON object per line
  (``{"type": "span"|"instant", "track", "name", "t0", "t1", "args"}``)
  for ad-hoc analysis without a trace viewer.

Tracks are free-form strings; the ``group/index`` convention
(``device/3``, ``cell/1``, ``server``) is what maps them onto Perfetto
process/thread rows.  The sink is append-only host-side Python — it
never touches simulation state, so tracing a seeded run cannot change
its timeline.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

_US = 1e6            # simulated seconds -> trace microseconds


@dataclasses.dataclass(frozen=True)
class Span:
    track: str
    name: str
    t0: float
    t1: float
    args: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class Instant:
    track: str
    name: str
    t: float
    args: Optional[dict] = None


class TraceSink:
    """Append-only collector of spans/instants on named tracks.

    An optional :class:`~repro_torch.telemetry.sampling.TraceSampler` bounds
    the high-cardinality ``device/<id>`` rows: events on sampled-out
    tracks are dropped at emission (never buffered), the decision being
    the deterministic ``blake2b(seed, device_id) < rate`` hash — so a
    replay of a seeded run traces the same devices and the resulting
    timelines stay directly comparable."""

    def __init__(self, sampler=None):
        self.spans: list[Span] = []
        self.instants: list[Instant] = []
        self.sampler = sampler

    def __len__(self) -> int:
        return len(self.spans) + len(self.instants)

    def span(self, track: str, name: str, t0: float, t1: float,
             **args) -> None:
        """Record a ``[t0, t1]`` interval (simulated seconds) on a track."""
        if self.sampler is not None and not self.sampler.keep(track):
            return
        self.spans.append(Span(track, name, float(t0), float(t1),
                               args or None))

    def instant(self, track: str, name: str, t: float, **args) -> None:
        """Record a point event at simulated time ``t`` on a track."""
        if self.sampler is not None and not self.sampler.keep(track):
            return
        self.instants.append(Instant(track, name, float(t), args or None))

    # ------------------------------------------------------------- exports

    def tracks(self) -> list[str]:
        seen = {s.track for s in self.spans} \
            | {i.track for i in self.instants}
        return sorted(seen, key=_track_sort_key)

    def to_perfetto(self) -> dict:
        """Chrome Trace Event JSON (the dict; caller serializes)."""
        events: list[dict] = []
        pids: dict[str, int] = {}
        tids: dict[str, tuple[int, int]] = {}
        for track in self.tracks():
            group, _, index = track.partition("/")
            if group not in pids:
                pid = len(pids) + 1
                pids[group] = pid
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": group}})
            pid = pids[group]
            tid = sum(1 for t, (p, _) in tids.items() if p == pid) + 1
            tids[track] = (pid, tid)
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"name": track}})
            events.append({"name": "thread_sort_index", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"sort_index": _track_index(index)}})
        for s in self.spans:
            pid, tid = tids[s.track]
            ev = {"name": s.name, "cat": "sim", "ph": "X",
                  "ts": s.t0 * _US, "dur": max(s.t1 - s.t0, 0.0) * _US,
                  "pid": pid, "tid": tid}
            if s.args:
                ev["args"] = _jsonable_args(s.args)
            events.append(ev)
        for i in self.instants:
            pid, tid = tids[i.track]
            ev = {"name": i.name, "cat": "sim", "ph": "i", "s": "t",
                  "ts": i.t * _US, "pid": pid, "tid": tid}
            if i.args:
                ev["args"] = _jsonable_args(i.args)
            events.append(ev)
        other = {"clock": "simulated",
                 "time_unit": "1 sim second = 1 us x 1e6"}
        if self.sampler is not None:
            other["trace_sample"] = self.sampler.describe()
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    def write_perfetto(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)

    def write_jsonl(self, path: str) -> int:
        """One JSON object per span/instant, time-ordered; line count."""
        rows = [{"type": "span", "track": s.track, "name": s.name,
                 "t0": s.t0, "t1": s.t1, "args": s.args or {}}
                for s in self.spans]
        rows += [{"type": "instant", "track": i.track, "name": i.name,
                  "t0": i.t, "t1": i.t, "args": i.args or {}}
                 for i in self.instants]
        rows.sort(key=lambda r: (r["t0"], r["track"], r["name"]))
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(_jsonable_args(row)) + "\n")
        return len(rows)


def _track_sort_key(track: str) -> tuple:
    group, _, index = track.partition("/")
    return (group, _track_index(index), track)


def _track_index(index: str) -> int:
    try:
        return int(index)
    except ValueError:
        return 0


def _jsonable_args(args: dict) -> dict:
    out = {}
    for k, v in args.items():
        item = getattr(v, "item", None)
        if callable(item) and not isinstance(v, (int, float, str, bool)):
            try:
                v = item()
            except Exception:
                v = repr(v)
        elif isinstance(v, dict):
            v = _jsonable_args(v)
        elif not isinstance(v, (int, float, str, bool, type(None),
                                list, tuple)):
            v = repr(v)
        out[k] = v
    return out
