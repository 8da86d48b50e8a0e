"""Profiling, timing and the program's own spans and counters (port of
``stormtpu/utils/profiling.py``, grown by the recorder).

``trace(log_dir)`` records a ``torch.profiler`` trace of the wrapped region
and writes it to ``log_dir`` as a Chrome trace, with the program's spans
and counters beside it (no-op when ``log_dir`` is ``None``). The timers
return seconds a call of ``fn``:

- on the card: CUDA events around back-to-back launches of ``fn`` over the
  inputs ``xs[1:]``, after one warm call on ``xs[0]``;
- on the CPU: ``time.perf_counter`` around the same calls.

The device is the device of ``xs[0]``. ``timeit_sustained`` is the slope
between two chain lengths, which cancels any fixed cost a chain carries;
when the slope is not above noise it returns the conservative ``t(c2)/c2``.
The JAX package's in-``jit`` chains and salted forms exist for a TPU reached
through a relay that memoises identical executions and adds a fixed cost to
every dispatch; the card has neither, so they are not ported.

**Spans and counters.** The program marks its layer boundaries with spans
named ``stpu.<layer>.<what>`` (:func:`span`, :func:`stage`, :func:`wait`)
and counts bytes, waits and routes there (:func:`count`). One set of span
points serves three modes:

- *off* (the default): a span point reads two flags and returns one shared
  no-op context; a counter reads the same two flags and returns.
- *synchronised* (:func:`record_stages`): the stage spans (:func:`stage`)
  synchronise the device at both ends and sum host seconds and CUDA-event
  milliseconds by stage name into a :class:`StageTimes`, and the stripe
  writer completes stripes in order (:func:`synchronised`). A measuring
  tool: the walk it measures is a serialised one.
- *unsynchronised* (:func:`record`, and whenever a ``torch.profiler``
  session is active): each span is kept in memory (name, parent, ids, host
  start and end in ``time.time_ns()``, which is the profiler's clock), the
  counters by name, and the kernel launches of each job and request
  (``kernels.launch_counts()``), with nothing synchronised or reordered.
  Under a profiler each span is also a ``record_function`` range, so the
  trace holds it beside the kernels; what was recorded while a profiler
  was active is :func:`profiled_recording`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, NamedTuple, Optional

import torch

__all__ = [
    "trace",
    "timeit_chain",
    "timeit_sustained",
    "timeit_sustained_auto",
    "record",
    "record_stages",
    "profiled_recording",
    "reset_profiled",
    "Recording",
    "SpanRecord",
    "StageTimes",
    "DeviceClock",
]

# Spans one recording keeps; later ones are counted in ``dropped``.
SPAN_CAP = 1_000_000

# The spans that number themselves (their first id) and record the kernel
# launches made inside them.
_NUMBERED = ("stpu.stream.job", "stpu.cross.request")


class StageTimes:
    """What :func:`record_stages` collects over the walks run inside it,
    summed over their stripes: ``seconds[stage]`` on the host clock with
    the device synchronised at both ends of the stage, ``device_ms[stage]``
    by CUDA events around the same stage (card only), ``stripes`` computed
    (resumed ones are not), ``launched``, those that ran a kernel, and
    ``routes``: how many stripes or chunks took each dispatch route of a
    reduction over K2-tri's tiles (``kernels.mxu.topk_route`` and
    ``hist_route``)."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.device_ms: dict[str, float] = {}
        self.stripes = 0
        self.launched = 0
        self.routes: dict[str, int] = {}


class SpanRecord(NamedTuple):
    """One finished span: ``seq`` numbers the spans of the process in the
    order they opened, ``parent`` is the enclosing span's ``seq`` (−1 at
    the top), ``start_ns`` and ``end_ns`` are ``time.time_ns()``."""

    seq: int
    name: str
    parent: int
    ids: tuple
    start_ns: int
    end_ns: int


class Recording:
    """The spans (:class:`SpanRecord`, in the order they closed), counters
    and dropped spans of an unsynchronised recording."""

    def __init__(self) -> None:
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0

    def copy(self) -> "Recording":
        out = Recording()
        out.spans, out.counters, out.dropped = list(self.spans), dict(self.counters), self.dropped
        return out


# ``_ap._is_profiler_enabled`` is the flag torch sets while a profiler runs:
# reading it costs a module attribute, where ``record_function`` costs µs.
_ap = torch.autograd.profiler
_record_function = _ap.record_function

_live = 0                             # open record() and record_stages() contexts
_sync: Optional[StageTimes] = None    # the innermost record_stages()
_records: list[Recording] = []        # the open record() contexts
_profiled = Recording()               # what was recorded under a profiler
_lock = threading.Lock()              # counters and span lists
_local = threading.local()            # each thread's stack of open span numbers
_seq = itertools.count()
_numbers = {name: itertools.count() for name in _NUMBERED}


def _targets() -> list[Recording]:
    out = list(_records)
    if _ap._is_profiler_enabled:
        out.append(_profiled)
    return out


class _Noop:
    """The span of the off mode: one shared instance, no state."""

    __slots__ = ()
    number = None

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def add_ids(self, a, b) -> None:
        pass


_NOOP = _Noop()


class _Span:
    """A span of the synchronised or unsynchronised mode (or both)."""

    __slots__ = ("name", "ids", "stage", "dev", "number", "targets", "seq", "parent", "t0",
                 "range", "events", "host0", "launches")

    def __init__(self, name: str, ids: tuple, stage: Optional[str] = None, dev=None):
        self.name, self.ids, self.stage, self.dev = name, ids, stage, dev
        self.number = None

    def add_ids(self, a, b) -> None:
        """Append two ids known only once the span is open."""
        self.ids += (a, b)

    def __enter__(self) -> "_Span":
        self.targets = _targets()
        self.range = self.events = self.launches = None
        if self.name in _numbers:
            self.number = next(_numbers[self.name])
            self.ids = (self.number,) + self.ids
            if self.targets:
                from stormtpu_torch.kernels import launch_counts

                self.launches = launch_counts()
        if _ap._is_profiler_enabled:
            self.range = _record_function(self.name)
            self.range.__enter__()
        if self.stage is not None and _sync is not None:
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
            self.host0 = time.perf_counter()
        stack = _stack()
        self.parent = stack[-1] if stack else -1
        self.seq = next(_seq)
        stack.append(self.seq)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.time_ns()
        stack = _stack()
        if stack and stack[-1] == self.seq:
            stack.pop()
        rec = _sync
        if self.stage is not None and rec is not None and exc_type is None:
            if self.events is not None:
                self.events[1].record()
                torch.cuda.synchronize(self.dev)
                ms = self.events[0].elapsed_time(self.events[1])
                rec.device_ms[self.stage] = rec.device_ms.get(self.stage, 0.0) + ms
            rec.seconds[self.stage] = (rec.seconds.get(self.stage, 0.0)
                                       + time.perf_counter() - self.host0)
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        if self.targets:
            done = SpanRecord(self.seq, self.name, self.parent, self.ids, self.t0, t1)
            launched = {}
            if self.launches is not None:
                from stormtpu_torch.kernels import launch_counts

                launched = {f"launches.{k}": v - self.launches.get(k, 0)
                            for k, v in launch_counts().items() if v != self.launches.get(k, 0)}
            with _lock:
                for r in self.targets:
                    if len(r.spans) < SPAN_CAP:
                        r.spans.append(done)
                    else:
                        r.dropped += 1
                    for k, v in launched.items():
                        r.counters[k] = r.counters.get(k, 0) + v
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, a=None, b=None, c=None):
    """A span named ``name`` (``stpu.<layer>.<what>``) with up to three
    ids, as a context manager. ``stpu.stream.job`` and
    ``stpu.cross.request`` number themselves: the number is their first id
    and the context's ``number`` (None when off)."""
    if not _live and not _ap._is_profiler_enabled:
        return _NOOP
    return _Span(name, () if a is None else (a,) if b is None else (a, b) if c is None
                 else (a, b, c))


def stage(layer: str, name: str, dev):
    """The span ``stpu.<layer>.<name>`` of a stage of work on ``dev``;
    under :func:`record_stages` also the stage ``name``'s times. Modules
    bind their layer: ``_stage = functools.partial(stage, "stream")``."""
    if not _live and not _ap._is_profiler_enabled:
        return _NOOP
    return _Span(f"stpu.{layer}.{name}", (), name, torch.device(dev))


def wait(what: str):
    """The span ``stpu.wait.<what>`` round a point where the host waits
    for the device (a download, an event, a read-back); counts ``waits``."""
    if not _live and not _ap._is_profiler_enabled:
        return _NOOP
    count("waits")
    return _Span(f"stpu.wait.{what}", ())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of every open recording."""
    if not _live and not _ap._is_profiler_enabled:
        return
    targets = _targets()
    if not targets:
        return
    with _lock:
        for r in targets:
            r.counters[name] = r.counters.get(name, 0) + int(n)


def count_stripe(launched: bool) -> None:
    """Count one stripe computed, and whether it ran a kernel."""
    if not _live and not _ap._is_profiler_enabled:
        return
    if _sync is not None:
        _sync.stripes += 1
        _sync.launched += bool(launched)
    count("stripes")
    if launched:
        count("launched")


def route(name: str) -> None:
    """Count one stripe or chunk on the reduction route ``name``."""
    if not _live and not _ap._is_profiler_enabled:
        return
    if _sync is not None:
        _sync.routes[name] = _sync.routes.get(name, 0) + 1
    count(f"routes.{name}")


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor ``t`` on ``device`` in one copy: from pageable memory
    the host waits for the copy (``stpu.wait.upload``); counts
    ``h2d_bytes``."""
    if not _live and not _ap._is_profiler_enabled:
        return t.to(device)
    count("h2d_bytes", t.numel() * t.element_size())
    with wait("upload"):
        return t.to(device)


class _EventPair:
    __slots__ = ("clock", "counter", "start")

    def __init__(self, clock: "DeviceClock", counter: str):
        self.clock, self.counter = clock, counter

    def __enter__(self) -> "_EventPair":
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.clock.pairs.setdefault(self.counter, []).append((self.start, end))
        return False


class DeviceClock:
    """Device time of chosen points of one job, as counters: each
    :meth:`time` context records a pair of CUDA events round what it
    encloses, and :meth:`count` adds each counter's summed µs to the open
    recordings. It records only on a card and while the span points
    record (inside :func:`record` or :func:`record_stages`, or under a
    ``torch.profiler`` session), and it synchronises nothing itself: call
    :meth:`count` where the host has waited for the device anyway."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda" and bool(_live or _ap._is_profiler_enabled)
        self.pairs: dict = {}

    def time(self, counter: str):
        """A context whose device time adds to the counter ``counter``."""
        return _EventPair(self, counter) if self.on else _NOOP

    def count(self) -> None:
        for counter, pairs in self.pairs.items():
            pairs[-1][1].synchronize()
            us = 1e3 * sum(a.elapsed_time(b) for a, b in pairs)
            count(counter, int(round(us)))
        self.pairs = {}


def synchronised() -> bool:
    """Whether a :func:`record_stages` context is open."""
    return _sync is not None


def counting() -> bool:
    """Whether a counter would be kept now: a caller whose count costs a
    read-back from the card asks first."""
    return bool(_live or _ap._is_profiler_enabled)


@contextlib.contextmanager
def record_stages() -> Iterator[StageTimes]:
    """Measure the stages of every walk run in this context. A measuring
    tool: a recorded walk runs its stages one after another (it
    synchronises the device around each stage and waits for each stripe's
    file before it goes on), so it is slower than a plain one."""
    global _sync, _live
    previous, _sync = _sync, StageTimes()
    _live += 1
    try:
        yield _sync
    finally:
        _sync = previous
        _live -= 1


@contextlib.contextmanager
def record() -> Iterator[Recording]:
    """Record the program's spans and counters in this context without
    synchronising anything."""
    global _live
    rec = Recording()
    _records.append(rec)
    _live += 1
    try:
        yield rec
    finally:
        _records.remove(rec)
        _live -= 1


def profiled_recording() -> Recording:
    """A copy of what was recorded while a ``torch.profiler`` session was
    active, since the process started or :func:`reset_profiled`."""
    with _lock:
        return _profiled.copy()


def reset_profiled() -> None:
    """Forget what :func:`profiled_recording` holds."""
    global _profiled
    with _lock:
        _profiled = Recording()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the wrapped region into ``log_dir``: ``trace.json`` (a
    Chrome trace of the host, the program's ``stpu.*`` spans and, where a
    card is present, its kernels), ``spans.jsonl`` (one span a line:
    ``seq``, ``name``, ``parent``, ``ids``, ``start_us``, ``end_us`` on the
    trace's clock, its ``ts``) and ``counters.json`` (the counters, and
    ``dropped_spans``); a no-op when ``log_dir`` is ``None`` or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof, record() as rec:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for s in rec.spans:
            f.write(json.dumps({"seq": s.seq, "name": s.name, "parent": s.parent,
                                "ids": list(s.ids), "start_us": (s.start_ns - base_ns) / 1e3,
                                "end_us": (s.end_ns - base_ns) / 1e3}) + "\n")
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(dict(rec.counters, dropped_spans=rec.dropped), f, indent=1, sort_keys=True)


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
