#!/usr/bin/env python3
"""What the program's spans cost, and which host waits on the card they
do not mark, in one process on one card.

    python3 scripts/torch_span_cost.py [--rows 16384] [--bits 1048576] [--reps 3]

1. Microseconds a span point (``utils.profiling.span``, ``stage``, ``wait``
   with its counter, ``count``): off, inside ``profiling.record()``, and
   under an active ``torch.profiler`` session (host and device activity).
2. A streamed top-16 job (``stream_topk_neighbors``, superblock 4096,
   ``kernel="auto"``) over a random panel of ``--rows`` x ``--bits``, and a
   lookup of 64 new rows against it (``cross_topk_neighbors``, k = 16):
   the spans a stripe and a request record, and the host-clock ms of a job
   and of a lookup off, recorded and profiled (each side ``--reps``
   times, in turns), with the answers of each mode held equal.
3. ``torch.cuda.set_sync_debug_mode("warn")`` over one job and one lookup
   under ``record()``: every place the host synchronised with the card,
   by file and line, and whether a ``stpu.wait.*`` span was open there.

Prints the card's name and power limit first and one JSON line last
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _point_us(n: int) -> dict:
    """µs a call of each span point in the current mode."""
    import torch

    from stormtpu_torch.utils import profiling

    dev = torch.device("cpu")
    points = {
        "span": lambda: profiling.span("stpu.stream.stripe", 0, 1, 2),
        "stage": lambda: profiling.stage("stream", "kernel", dev),
        "wait": lambda: profiling.wait("download"),
    }
    out = {}
    for name, make in points.items():
        t0 = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        out[name] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        profiling.count("h2d_bytes", 8)
    out["count"] = (time.perf_counter() - t0) / n * 1e6
    return out


def _modes():
    """(name, context) of the three modes."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stormtpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return [("off", contextlib.nullcontext), ("record", profiling.record),
            ("profiler", lambda: profile(activities=acts))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--bits", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="span_cost.json")
    args = ap.parse_args(argv)

    import torch

    import stormtpu_torch as st
    from stormtpu_torch import stream_query
    from stormtpu_torch.utils import profiling

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu for a rehearsal)", file=sys.stderr)
        return 2
    card = _card_line() if dev.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    result: dict = {"card": card, "rows": args.rows, "bits": args.bits}

    result["point_us"] = {}
    for name, ctx in _modes():
        with ctx():
            result["point_us"][name] = _point_us(args.points)
    print("point us:", result["point_us"], flush=True)

    rng = np.random.default_rng(7)
    words = args.bits // 32
    packed = rng.integers(0, 2**32, (args.rows, words), dtype=np.uint32)
    queries = rng.integers(0, 2**32, (64, words), dtype=np.uint32)
    bm = st.BitMatrix.from_packed(packed, args.bits)

    def job():
        return stream_query.stream_topk_neighbors(bm, 16, superblock_rows=4096, kernel="auto",
                                                  device=dev)

    def lookup():
        q = st.BitMatrix.from_packed(queries, args.bits)
        return st.cross_topk_neighbors(q, bm, 16, device=dev)

    want = {"job": job(), "lookup": lookup()}  # warm: the resident operand, the builds
    times: dict = {m: {"job": [], "lookup": []} for m, _ in _modes()}
    counts = {}
    for _ in range(args.reps):
        for name, ctx in _modes():
            for what, fn in (("job", job), ("lookup", lookup)):
                profiling.reset_profiled()
                with ctx() as rec:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    got = fn()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    times[name][what].append(time.perf_counter() - t0)
                for a, b in zip(got, want[what]):
                    np.testing.assert_array_equal(a, b)
                if name == "record":
                    unit = "stpu.stream.stripe" if what == "job" else "stpu.cross.request"
                    n_units = sum(s.name == unit for s in rec.spans)
                    counts[what] = {"spans": len(rec.spans), "units": n_units,
                                    "spans_per_unit": len(rec.spans) / max(n_units, 1),
                                    "by_name": dict(Counter(s.name for s in rec.spans)),
                                    "counters": rec.counters}
    result["ms"] = {m: {w: [t * 1e3 for t in v] for w, v in d.items()}
                    for m, d in times.items()}
    result["recorded"] = counts
    print("ms:", result["ms"], flush=True)

    if dev.type == "cuda":
        seen = []

        def show(message, category, filename, lineno, file=None, line=None):
            # the innermost frame of the program (the warning names torch's own)
            mine = [f for f in traceback.extract_stack() if "stormtpu_torch" in f.filename]
            where = f"{os.path.relpath(filename)}:{lineno}"
            if mine:
                where += f" from {os.path.relpath(mine[-1].filename)}:{mine[-1].lineno}"
            seen.append((time.time_ns(), where))

        with profiling.record() as rec, warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                job()
                lookup()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits = [(s.start_ns, s.end_ns) for s in rec.spans if s.name.startswith("stpu.wait.")]
        sites: dict = {}
        for t, where in seen:
            inside = any(a <= t <= b for a, b in waits)
            c = sites.setdefault(where, {"n": 0, "in_wait": 0})
            c["n"] += 1
            c["in_wait"] += inside
        result["sync_sites"] = sites
        for where, c in sorted(sites.items(), key=lambda kv: -kv[1]["n"]):
            print(f"sync {where}: {c['n']} ({c['in_wait']} inside a stpu.wait span)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "recorded"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
