"""Profiling and timing (port of ``stormtpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the wrapped region
and writes it to ``log_dir`` as a Chrome trace (no-op when ``log_dir`` is
``None``). The timers return seconds a call of ``fn``:

- on the card: CUDA events around back-to-back launches of ``fn`` over the
  inputs ``xs[1:]``, after one warm call on ``xs[0]``;
- on the CPU: ``time.perf_counter`` around the same calls.

The device is the device of ``xs[0]``. ``timeit_sustained`` is the slope
between two chain lengths, which cancels any fixed cost a chain carries;
when the slope is not above noise it returns the conservative ``t(c2)/c2``.
The JAX package's in-``jit`` chains and salted forms exist for a TPU reached
through a relay that memoises identical executions and adds a fixed cost to
every dispatch; the card has neither, so they are not ported.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "timeit_chain", "timeit_sustained", "timeit_sustained_auto"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the wrapped region into ``log_dir/trace.json`` (a Chrome
    trace of the host and, where a card is present, its kernels); a no-op
    when ``log_dir`` is ``None`` or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _is_cuda(x) -> bool:
    while isinstance(x, (tuple, list)):
        x = x[0]
    return isinstance(x, torch.Tensor) and x.is_cuda


def timeit_chain(fn, xs, chain: int) -> float:
    """Mean seconds of ``chain`` back-to-back calls ``fn(x)``, over the
    inputs ``xs[1:]`` (``xs[0]`` warms the call)."""
    if len(xs) < 2 or chain < 1:
        raise ValueError("timeit_chain needs a warm input, a timed input and chain >= 1")
    fn(xs[0])
    if _is_cuda(xs[0]):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in xs[1:]:
            for _ in range(chain):
                fn(x)
        stop.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(stop) * 1e-3
    else:
        t0 = time.perf_counter()
        for x in xs[1:]:
            for _ in range(chain):
                fn(x)
        seconds = time.perf_counter() - t0
    return seconds / (len(xs) - 1)


def timeit_sustained(fn, xs, c1: int = 2, c2: int = 10) -> float:
    """Seconds a call from the slope between chains of ``c1`` and ``c2``
    calls; ``t(c2)/c2`` when the slope is not positive (noise)."""
    if not 1 <= c1 < c2:
        raise ValueError(f"want 1 <= c1 < c2, got c1={c1}, c2={c2}")
    t1 = timeit_chain(fn, xs, c1)
    t2 = timeit_chain(fn, xs, c2)
    slope = (t2 - t1) / (c2 - c1)
    return slope if slope > 0 else t2 / c2


def timeit_sustained_auto(
    fn,
    xs,
    *,
    target_marginal_s: float = 0.02,
    c2_min: int = 2,
    c2_max: int = 256,
) -> float:
    """:func:`timeit_sustained` with ``c2`` chosen from a one-call probe so
    that the longer chain adds about ``target_marginal_s`` to the shorter."""
    t1 = timeit_chain(fn, xs[:2], 1)
    c2 = int(min(c2_max, max(c2_min, -(-target_marginal_s // max(t1, 1e-7)) + 1)))
    return timeit_sustained(fn, xs, c1=max(1, c2 // 8), c2=c2)
