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


def _launch(ts, corr):
    return {"name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "cat": "cuda_runtime", "args": {"correlation": corr}}


def _kernel(ts, dur, corr):
    return {"name": "k", "ts": ts, "dur": dur, "cat": "kernel",
            "args": {"correlation": corr}}


def test_device_time_goes_to_the_annotation_of_its_launch():
    events = [
        _ev("flbench.round", 0, 100, "user_annotation"),
        _ev("flbench.grad", 0, 40, "user_annotation"),
        _ev("flbench.sync", 40, 20, "user_annotation"),
        _launch(5, 1), _kernel(10, 30, 1),      # grad, runs past its span
        _launch(6, 2), _kernel(20, 30, 2),      # grad, overlaps: once
        _launch(45, 3), _kernel(50, 10, 3),     # sync
        _launch(70, 4), _kernel(75, 5, 4),      # outside any phase
        _kernel(90, 5, 99),                     # no launch in the trace
    ]
    assert trace.device_by_phase(events) == pytest.approx(
        {"grad": 40e-6, "sync": 10e-6})
    assert trace.device_by_phase([_kernel(0, 1, 1)]) == {}


def test_idle_and_mfu_read_the_windows_rounds():
    """The device's busy time and the operations a profiled round, over
    the untraced window's seconds a round."""
    import roofline
    from metrics import device_idle, round_mfu
    peak = roofline.PEAKS["f32_flops_per_s"]
    ctx = {"window_s": 10.0, "window_rounds": 5, "profiled_rounds": 2,
           "trace": {"busy_s": 3.0, "window_s": 8.0},
           "shape": {"flops": 2.0 * peak, "peak": "f32_flops_per_s"}}
    assert device_idle.read(ctx) == pytest.approx(25.0)
    assert round_mfu.read(ctx) == pytest.approx(50.0)
    # nothing ran on a device: neither is read, neither reads 0
    ctx["trace"]["busy_s"] = 0.0
    assert device_idle.read(ctx) is None and round_mfu.read(ctx) is None
