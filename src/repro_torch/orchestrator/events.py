"""Deterministic heap-based discrete-event engine.

The simulated timeline is a priority queue of :class:`Event` records.
Client-completion times come from the ``sysmodel`` latency model (Eq. 6-9):
``T_cmp = alpha * tau * D * W / f`` and ``T_com = bits / rate``, so the
event order is a pure function of the fleet draw and the per-round channel
realizations — two runs with the same seed produce identical traces.

Determinism rules:

* ties on ``time`` break on the monotonically increasing ``seq`` assigned
  at push time (insertion order), never on payload identity;
* the queue records every pop into ``trace`` so tests can assert that two
  seeded runs replay the exact same event sequence;
* no wall-clock reads anywhere — simulated time only enters through
  ``push(time, ...)``.

Trace retention is configurable: by default every pop is retained (the
pre-telemetry behaviour), but a million-event run would grow ``trace``
without bound, so ``EventQueue(trace_limit=N)`` keeps only the newest
``N`` records and folds evicted ones into a rolling blake2b digest.
``trace_signature()`` stays usable for determinism tests either way —
the full tuple when everything is retained, a stable
``("blake2b", n_events, hexdigest)`` triple once eviction kicked in
(two seeded runs still compare equal iff their full pop sequences do).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Any, Optional

# rounding applied to event times before hashing/signing — absorbs float
# repr noise; must match between eviction-time hashing and signature time
_SIG_DIGITS = 9

# event kinds used by the runner
COMPLETE = "complete"     # a client's (T_cmp + T_com) elapsed; update arrived
RETRY = "retry"           # infeasible budgets this draw; re-probe the channel
CHURN = "churn"           # device left the cell mid-round; round aborted
EDGE_MERGE = "edge_merge"  # an edge cell's partial landed at the cloud
                           # (hierarchical topologies; client = cell id)
HANDOVER = "handover"      # a mobile device re-homed to a new cell at a
                           # round boundary (payload = (old, new) cells)


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    client: int = dataclasses.field(compare=False, default=-1)
    payload: Any = dataclasses.field(compare=False, default=None)


class EventQueue:
    """Min-heap of events with a deterministic pop trace.

    ``trace_limit=None`` (default) retains every popped record;
    ``trace_limit=N`` bounds ``trace`` to the newest N records, folding
    evicted ones into a rolling hash so the replay signature survives.
    """

    def __init__(self, trace_limit: Optional[int] = None):
        if trace_limit is not None and trace_limit < 1:
            raise ValueError("trace_limit must be >= 1 (or None for "
                             "unbounded retention)")
        self._heap: list[Event] = []
        self._seq = 0
        self.trace: list[tuple[float, int, str, int]] = []
        self.trace_limit = trace_limit
        self.n_evicted = 0
        self._rolling: Optional["hashlib.blake2b"] = None

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, kind: str, client: int = -1,
             payload: Any = None) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind,
                   client=client, payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        ev = heapq.heappop(self._heap)
        self.trace.append((ev.time, ev.seq, ev.kind, ev.client))
        if self.trace_limit is not None \
                and len(self.trace) > self.trace_limit:
            if self._rolling is None:
                self._rolling = hashlib.blake2b(digest_size=16)
            t, s, k, c = self.trace[0]
            self._rolling.update(_canon(t, s, k, c))
            del self.trace[0]
            self.n_evicted += 1
        return ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0].time if self._heap else None

    def trace_signature(self, digits: int = _SIG_DIGITS):
        """Hashable replay signature (times rounded to absorb repr noise).

        Full retention returns the record tuple (pre-telemetry format,
        bitwise-stable); once eviction kicked in it returns
        ``("blake2b", n_events, hexdigest)`` over the complete pop
        sequence — equal across runs iff the sequences are.
        """
        if self._rolling is None:
            return tuple((round(t, digits), s, k, c)
                         for t, s, k, c in self.trace)
        if digits != _SIG_DIGITS:
            raise ValueError(
                f"bounded-retention signatures hash evicted records at "
                f"digits={_SIG_DIGITS}; a different tail rounding would "
                f"not compose")
        h = self._rolling.copy()
        for t, s, k, c in self.trace:
            h.update(_canon(t, s, k, c))
        return ("blake2b", self.n_evicted + len(self.trace),
                h.hexdigest())


def _canon(t: float, s: int, k: str, c: int) -> bytes:
    """Canonical bytes of one trace record for the rolling digest."""
    return repr((round(t, _SIG_DIGITS), s, k, c)).encode()
