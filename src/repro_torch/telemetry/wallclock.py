"""Machine time of the port's own phases: host-clock spans and counters,
on the profiler's timeline.

:class:`~repro_torch.telemetry.Telemetry` keeps the paper's *simulated*
timeline; this module keeps the machine's.  The round loop, the client
pool, the update decode, the aggregation, the evaluation and set-up open
dotted spans, the layer first (``round``, ``prepare.h2d``,
``train.step``, ``materialize.costs``, ``setup.kernels``), and add to
counters (``h2d_bytes``).  What a span costs depends on who listens:

* nobody (no recorder active, no profiler recording): :func:`span`
  returns one shared no-op object, allocating nothing and reading no
  clock, and :func:`count` returns at once;
* a ``torch.profiler`` recording: each span also opens
  ``torch.profiler.record_function(name)``, so the Chrome trace holds it
  as a ``user_annotation`` on the same clock as the kernels it launched;
* a :class:`Recorder` active (``with recording() as rec:``): each span's
  start and end (``time.perf_counter_ns``) and its parent are kept, and
  aggregated by name into calls, total and self time (the duration less
  its children's); counters are summed by name.  Raw records go into a
  buffer of fixed capacity that counts what it drops, so a recorder's
  memory is bounded by the number of names and the capacity.

Spans draw no random number, read no tensor and launch nothing, so a
seeded run gives the same result bit for bit with recording on or off.
They nest on the thread that opens them, the round loop's: a recorder
assumes one such thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Iterable, Iterator, NamedTuple, Optional

import torch

#: raw span records a recorder keeps before it counts drops instead
CAPACITY = 1 << 16

_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span: ``index`` counts the recorder's spans in the order
    they opened, ``parent`` is the enclosing span's index (-1 at the
    top), ``info`` what the call site noted (a ``train.group``'s width,
    lanes and steps)."""
    index: int
    parent: int
    name: str
    start_ns: int
    end_ns: int
    info: Optional[dict] = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class SpanStat(NamedTuple):
    """A name's spans: how many closed, their summed duration, and that
    less the time inside their child spans."""
    calls: int
    total_ns: int
    self_ns: int


class Recorder:
    """What the spans and counters recorded while it was active."""

    def __init__(self):
        self._stack: list = []          # the open spans, innermost last
        self._opened = 0
        self._stats: dict[str, list] = {}
        self._counters: dict[str, float] = {}
        self._records: list[SpanRecord] = []
        self.dropped = 0

    def spans(self) -> dict[str, SpanStat]:
        """Name -> :class:`SpanStat`, in the order the names first closed."""
        return {k: SpanStat(*v) for k, v in self._stats.items()}

    def counters(self) -> dict[str, float]:
        return dict(self._counters)

    def records(self) -> list[SpanRecord]:
        """The raw records, in the order the spans closed (at most
        :data:`CAPACITY`; ``dropped`` counts the rest)."""
        return list(self._records)


class _Off:
    """The span nobody listens to."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_OFF = _Off()
_active: Optional[Recorder] = None


class _Span:
    __slots__ = ("name", "info", "_rec", "_rf", "_index", "_parent",
                 "_t0", "_child_ns")

    def __init__(self, name: str, info: Optional[dict],
                 rec: Optional[Recorder], profiling: bool):
        self.name, self.info, self._rec = name, info, rec
        self._rf = torch.autograd.profiler.record_function(name) \
            if profiling else None
        self._child_ns = 0

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        rec = self._rec
        if rec is not None:
            stack = rec._stack
            self._parent = stack[-1] if stack else None
            self._index = rec._opened
            rec._opened += 1
            stack.append(self)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self._rec
        if rec is not None:
            dur = time.perf_counter_ns() - self._t0
            rec._stack.pop()
            parent = self._parent
            if parent is not None:
                parent._child_ns += dur
            stat = rec._stats.get(self.name)
            if stat is None:
                stat = rec._stats[self.name] = [0, 0, 0]
            stat[0] += 1
            stat[1] += dur
            stat[2] += dur - self._child_ns
            if len(rec._records) < CAPACITY:
                rec._records.append(SpanRecord(
                    self._index, -1 if parent is None else parent._index,
                    self.name, self._t0, self._t0 + dur, self.info))
            else:
                rec.dropped += 1
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        return False


def span(name: str, info: Optional[dict] = None):
    """A context manager timing the block as ``name`` (see the module's
    docstring for what it costs).  ``info`` is kept in the raw record;
    a call site builds it only where that is cheap, since it is built
    whether anyone listens or not."""
    rec = _active
    profiling = _profiler_enabled()
    if rec is None and not profiling:
        return _OFF
    return _Span(name, info, rec, profiling)


def spanned(name: str) -> Callable:
    """Decorate a function so that each call runs inside a span
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def loop(name: str, items: Iterable) -> Iterator:
    """Iterate ``items``, each pass of the caller's loop body inside a
    span ``name`` (a ``break`` closes the open one as the loop drops the
    iterator)."""
    for item in items:
        with span(name):
            yield item


def count(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` while a recorder is active."""
    rec = _active
    if rec is not None:
        rec._counters[name] = rec._counters.get(name, 0) + n


def counting() -> bool:
    """Whether a recorder is active: a call site that must compute what it
    counts (a tensor's reduction) asks first."""
    return _active is not None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Activate a fresh :class:`Recorder` for the block (the one active
    before comes back after it)."""
    global _active
    prev, rec = _active, Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = prev
