"""``bench/spans``: the device trace read by the program's own spans, and
``spans.py``, the run that reports them, at a small size on the CPU."""
import pytest

from bench import spans


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


def _runtime(name, ts, dur=1.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur}


def test_segments_give_the_innermost_path():
    segs = spans.segments([(0, 100, "round"), (10, 40, "train"),
                           (15, 20, "train.step"), (50, 60, "eval")])
    assert segs == [(0, 10, ("round",)), (10, 15, ("round", "train")),
                    (15, 20, ("round", "train", "train.step")),
                    (20, 40, ("round", "train")), (40, 50, ("round",)),
                    (50, 60, ("round", "eval")), (60, 100, ("round",))]


def test_a_gap_goes_to_the_innermost_span_and_splits_at_its_edges():
    names = {"round", "train", "train.step", "materialize", "eval"}
    events = [
        _span("round", 0, 100), _span("train", 10, 40),
        _span("train.step", 15, 10), _span("materialize", 60, 20),
        _span("flbench.round", 0, 100),      # not the program's
        _kernel(0, 12), _kernel(18, 4), _kernel(30, 35), _kernel(70, 30),
    ]
    out = spans.reduce_spans(events, names)
    # gaps: [12, 18] (train, then train.step from 15), [22, 30] (in
    # train.step to 25, then train), [65, 70] (materialize)
    assert out["idle_self"] == pytest.approx(
        {"train": 3e-6 + 5e-6, "train.step": 3e-6 + 3e-6,
         "materialize": 5e-6})
    assert out["idle"] == pytest.approx(
        {"round": 19e-6, "train": 14e-6, "train.step": 6e-6,
         "materialize": 5e-6})
    assert out["idle_rounds_s"] == pytest.approx(19e-6)
    assert sum(out["idle_self"].values()) == pytest.approx(
        out["idle_rounds_s"])


@pytest.mark.parametrize("t0", [0.0, 1.46e12])   # a trace's microseconds
def test_syncs_count_for_every_span_around_them(t0):
    names = {"round", "prepare", "prepare.h2d", "materialize"}
    events = [
        _span("round", 0, 100), _span("prepare", 0, 30),
        _span("prepare.h2d", 10, 10), _span("materialize", 50, 20),
        _runtime("cudaStreamSynchronize", 12), _runtime("cudaMemcpy", 14),
        _runtime("cudaStreamSynchronize", 55),
        _runtime("cudaMemcpyAsync", 56),      # does not wait
        _runtime("cudaDeviceSynchronize", 90),
        _runtime("cudaStreamSynchronize", 150),   # outside the rounds
        _kernel(0, 100),
    ]
    for e in events:
        e["ts"] += t0
    out = spans.reduce_spans(events, names)
    assert out["syncs"] == {"round": 4, "prepare": 2, "prepare.h2d": 2,
                            "materialize": 1}
    assert out["sync_events"] == 5
    assert out["idle_rounds_s"] == 0.0


def test_without_program_rounds_nothing_is_read():
    assert spans.reduce_spans([_span("flbench.round", 0, 10)],
                              {"round"}) == {}


def test_a_small_run_reads_its_spans(small):
    import spans as tool
    out = tool.measure("vgg9-heterofl-sync60", 3100000211, 0.05,
                       device="cpu", overrides=small)
    assert out["run"]["correct"]
    got = out["readings"]
    assert got["setup_data_s"] > 0
    assert got["setup_kernels_s"] is None       # no library on the CPU
    # 6 devices x 4 steps x 8 images of 32 x 32 x 3 float32, int32 labels
    assert got["h2d_mib"] == pytest.approx(
        6 * 4 * 8 * (32 * 32 * 3 * 4 + 4) / 2 ** 20)
    assert got["train_idle_ms"] > 0             # no device: all idle
    assert out["checks"]["window_round_s"] > 0
    assert out["checks"]["idle_by_all_spans_ms"] == pytest.approx(
        out["checks"]["idle_in_rounds_ms"])
    listed = {s["span"] for s in out["program_spans"]}
    assert len(listed) == tool.TOP
    assert {"round", "train", "materialize"} <= listed
    assert out["setup"]["build_s"] >= out["setup"]["data_s"] > 0
    groups = out["train_groups"]
    assert sum(g["lanes"] for g in groups) == 6
    assert all(g["host_ms"] > 0 and g["idle_ms"] > 0 for g in groups)


def test_idle_inside_an_interval():
    busy = spans.device_busy([_kernel(0, 10), _kernel(5, 10),
                              _kernel(30, 5), _span("round", 0, 100)])
    assert busy == [[0, 15], [30, 35]]
    assert spans.idle_inside(busy, 10, 40) == 20
    assert spans.idle_inside(busy, 16, 29) == 13
    assert spans.idle_inside(busy, 0, 15) == 0
