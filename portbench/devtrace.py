"""The device trace of a traced run: ``torch.profiler`` over the measured
loop, reduced to what the per-layer metrics and the result's
``breakdown`` read. Kernels, copies and fills are found by the profiler's
activity kind, never by name, so a fused, split or renamed kernel reads
the same."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10
GAP_SAMPLE_US = 50.0  # a gap is named at points this far apart (at most 64 a gap)
NAME_CHARS = 160     # a kernel's name is cut to this many characters in the breakdown


@dataclasses.dataclass
class DeviceTrace:
    window_s: float           # the traced window, on the trace's clock
    busy_s: float             # union of kernels, copies and fills inside it
    kernel_s: float           # summed durations of the kernels inside it
    device_ops: list          # [[name, seconds]] of the device operations that took most time
    idle_gaps: list           # [[host activity, seconds]] of the idle time, by what the host ran


def profiled(fn, device):
    """Run ``fn()`` under ``torch.profiler`` (host and device activity) and
    return (its result, :class:`DeviceTrace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, reduce_events(events)


def _union(iv: np.ndarray) -> tuple[float, np.ndarray]:
    """(covered length, gaps [g, 2]) of intervals [k, 2] sorted by start."""
    if not len(iv):
        return 0.0, np.zeros((0, 2))
    covered, gaps = 0.0, []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            covered += e - s
            gaps.append((e, a))
            s, e = a, b
        else:
            e = max(e, b)
    covered += e - s
    return covered, np.asarray(gaps, dtype=float).reshape(-1, 2)


def _attribute(gaps: np.ndarray, host: list):
    """Yield (name, seconds): each idle gap split among the innermost host
    operations of the main thread running during it, sampled at points
    ``GAP_SAMPLE_US`` apart, by one sweep over the (nested) host ranges."""
    points = []
    for a, b in gaps:
        k = int(min(64, max(1, np.ceil((b - a) / GAP_SAMPLE_US))))
        step = (b - a) / k
        points += [(a + (i + 0.5) * step, step * 1e-6) for i in range(k)]
    points.sort()
    stack: list = []
    h = 0
    for t, weight in points:
        while h < len(host) and host[h][0] <= t:
            while stack and stack[-1][1] < host[h][0]:
                stack.pop()
            stack.append(host[h])
            h += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        yield (stack[-1][2] if stack else "no host op"), weight


def reduce_events(events: list) -> DeviceTrace:
    """Reduce Chrome-trace events (µs) to a :class:`DeviceTrace`."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    dev, names = [], []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_KINDS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
            if b > a:
                dev.append((a, b, e["cat"] == "kernel"))
                names.append(e.get("name", "?")[:NAME_CHARS])
    iv = np.asarray([(a, b) for a, b, _ in dev], dtype=float).reshape(-1, 2)
    order = np.argsort(iv[:, 0], kind="stable")
    busy, gaps = _union(iv[order])
    kernel = sum(b - a for a, b, k in dev if k)
    by_op: dict = defaultdict(float)
    for (a, b, _), name in zip(dev, names):
        by_op[name] += (b - a) * 1e-6
    # leading and trailing idle time of the window are gaps too
    if len(iv):
        edges = [(w0, float(iv[:, 0].min())), (float(iv[:, 1].max()), w1)]
    else:
        edges = [(w0, w1)]
    gaps = np.concatenate([gaps, np.asarray([g for g in edges if g[1] > g[0]],
                                            dtype=float).reshape(-1, 2)])
    # by start, the outer of two ranges that start together first
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e["name"][:NAME_CHARS])
                   for e in events if e.get("ph") == "X" and e.get("cat") in HOST_KINDS
                   and e.get("tid") == main_tid and e.get("name") != WINDOW),
                  key=lambda r: (r[0], -r[1]))
    by_gap: dict = defaultdict(float)
    for label, seconds in _attribute(gaps, host):
        by_gap[label] += seconds
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return DeviceTrace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernel_s=kernel * 1e-6,
                       device_ops=top(by_op), idle_gaps=top(by_gap))
