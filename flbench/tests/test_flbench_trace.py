"""The device trace's reduction: the busy time is a union of intervals."""
import pytest

from bench import trace


def test_union_counts_overlaps_once():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([(0, 10), (2, 3)]) == 10
    assert trace.union_length([]) == 0


def _ev(name, ts, dur, cat="kernel"):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat}


def test_reduce_trace_window_busy_and_gaps():
    events = [
        _ev("flbench.round", 0, 100, "user_annotation"),
        _ev("flbench.round", 100, 100, "user_annotation"),
        _ev("flbench.train", 0, 50, "user_annotation"),
        _ev("flbench.materialize", 50, 150, "user_annotation"),
        _ev("k1", 10, 20), _ev("k2", 20, 25),          # overlap: 10..45
        _ev("copy", 60, 10, "gpu_memcpy"),
        _ev("k1", 150, 100),                           # cut at 200
        _ev("cpu_op", 0, 200, "cpu_op"),
    ]
    r = trace.reduce_trace(events)
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx((35 + 10 + 50) * 1e-6)
    assert r["kernels"]["k1"] == pytest.approx(70e-6)
    assert r["kernels"]["k2"] == pytest.approx(25e-6)
    # idle: 0..10 (train), 45..60 and 70..150 (materialize)
    assert r["idle_by_phase"] == pytest.approx(
        {"train": 10e-6, "materialize": 95e-6})


def test_reduce_trace_without_rounds_reads_nothing():
    assert trace.reduce_trace([_ev("k", 0, 1)]) == {}


def test_top_keeps_the_largest():
    d = {str(i): float(i) for i in range(20)}
    top = trace.top(d)
    assert len(top) == 10 and top[0] == ["19", 19.0]
