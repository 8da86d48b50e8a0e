"""What the program's own spans and counters say about the profiled
window: ``stormtpu_torch.utils.profiling.profiled_recording()``, which
holds what the program recorded while a ``torch.profiler`` session was
active. The traced run's window (``devtrace.profiled``) is the process's
only profiler session; set-up, the stage pass and the check run outside
it. Each reading is normalised by the spans it counts. A program without
the recorder, a window without the spans, or a recording that dropped
spans reads None."""

from __future__ import annotations

WAIT = "stpu.wait."
STRIPE = "stpu.stream.stripe"
REQUEST = "stpu.cross.request"
FROM_PACKED = "stpu.layout.from_packed"


def recording():
    """The program's record of the profiled window, or None."""
    try:
        from stormtpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "profiled_recording", None)
    if get is None:
        return None
    rec = get()
    return None if rec.dropped else rec


def _named(rec, name: str) -> list:
    return [s for s in rec.spans if s.name == name]


def busy_ms(rec, name: str):
    """Mean host ms of the spans ``name`` outside the waits inside them:
    each span's length less that of its outermost ``stpu.wait.*``
    descendants."""
    if rec is None:
        return None
    spans = _named(rec, name)
    if not spans:
        return None
    by_seq = {s.seq: s for s in rec.spans}
    waited = dict.fromkeys((s.seq for s in spans), 0)
    for w in rec.spans:
        if not w.name.startswith(WAIT):
            continue
        p = by_seq.get(w.parent)
        while p is not None and p.seq not in waited and not p.name.startswith(WAIT):
            p = by_seq.get(p.parent)
        if p is not None and p.seq in waited:
            waited[p.seq] += w.end_ns - w.start_ns
    total = sum(s.end_ns - s.start_ns - waited[s.seq] for s in spans)
    return total / len(spans) / 1e6


def mean_ms(rec, name: str):
    """Mean host ms of the spans ``name``."""
    if rec is None:
        return None
    spans = _named(rec, name)
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def per_span(rec, counter: str, name: str):
    """The counter ``counter`` over the number of spans ``name``; None
    where the program never counted it or opened no such span."""
    if rec is None or counter not in rec.counters:
        return None
    n = len(_named(rec, name))
    return rec.counters[counter] / n if n else None
