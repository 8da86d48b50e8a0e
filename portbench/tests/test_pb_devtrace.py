"""The reduction of a profiler trace: busy time is the union of kernels,
copies and fills inside the window; kernel time their sum; idle gaps are
named by the innermost host operation of the main thread."""

import math

import pytest

from portbench import devtrace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_reduce_events():
    ev = [
        _x("user_annotation", devtrace.WINDOW, 0, 1000),
        _x("kernel", "k2", 100, 300, tid=7),
        _x("kernel", "k2", 350, 100, tid=8),      # overlaps the first: busy counts it once
        _x("gpu_memcpy", "Memcpy DtoH", 600, 100, tid=7),
        _x("kernel", "late", 950, 200, tid=7),    # cut at the window's end
        _x("gpu_user_annotation", "ignored", 0, 1000, tid=7),
        _x("cpu_op", "aten::topk", 450, 200),      # over the gap 450..600
        _x("cpu_op", "outer", 400, 600),
        _x("cpu_op", "other thread", 700, 250, tid=2),
    ]
    t = devtrace.reduce_events(ev)
    assert math.isclose(t.window_s, 1e-3)
    assert math.isclose(t.busy_s, (350 + 100 + 50) * 1e-6)
    assert math.isclose(t.kernel_s, (300 + 100 + 50) * 1e-6)
    assert t.device_ops[0][0] == "k2" and math.isclose(t.device_ops[0][1], 400e-6)
    gaps = dict(t.idle_gaps)
    assert math.isclose(gaps["aten::topk"], 150e-6)
    assert math.isclose(gaps["outer"], 250e-6)       # 700..950: only "outer" on the main thread
    assert math.isclose(gaps["no host op"], 100e-6)  # 0..100
    assert math.isclose(sum(gaps.values()) + t.busy_s, t.window_s)


def test_a_gap_is_split_among_the_host_operations_under_it():
    ev = [
        _x("user_annotation", devtrace.WINDOW, 0, 400),
        _x("kernel", "k", 0, 100, tid=7),
        _x("kernel", "k", 300, 100, tid=7),
        _x("cpu_op", "outer", 100, 200),
        _x("cpu_op", "inner", 100, 50),   # starts with its parent
        _x("cpu_op", "later", 200, 50),
    ]
    gaps = dict(devtrace.reduce_events(ev).idle_gaps)
    assert gaps.keys() == {"outer", "inner", "later"}
    assert math.isclose(gaps["inner"], 50e-6)
    assert math.isclose(gaps["later"], 50e-6)
    assert math.isclose(gaps["outer"], 100e-6)


def test_no_window_is_an_error():
    with pytest.raises(ValueError):
        devtrace.reduce_events([_x("kernel", "k", 0, 1)])
