"""What the metric files read a run by (``harness.Run``). A reader that
finds nothing to read returns None, and the metric is left out of the
result line."""

from __future__ import annotations

import numpy as np

from portbench import roofline


def pairs_per_s(run):
    """Pairs answered over the whole measured loop, every unit whole."""
    if not run.units or run.elapsed_s <= 0:
        return None
    return sum(u.pairs for u in run.units) / run.elapsed_s


def latency_ms(run, q: float):
    """The ``q``-th percentile of every unit's latency, in ms."""
    if not run.units:
        return None
    return float(np.percentile([u.seconds for u in run.units], q)) * 1e3


def roofline_pct(run):
    """The least time for the answers of the traced loop (``roofline``)
    over the summed time of every kernel in it, in %."""
    t = run.trace
    if t is None or t.kernel_s <= 0 or not run.units:
        return None
    ops, nbytes = run.work
    n = len(run.units)
    return 100.0 * roofline.least_seconds(n * ops, n * nbytes) / t.kernel_s


def idle_pct(run):
    """Share of the traced window with no kernel, copy or fill on the card."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def stage_ms_per_stripe(run, stages: set, inside: bool, device_clock: bool):
    """ms a stripe of the stage pass (``record_stages``) in the stages
    named (``inside``) or in all others: CUDA-event ms, or host seconds
    with the device synchronised round each stage."""
    s = run.stages
    if not s or not s["stripes"]:
        return None
    times = s["device_ms"] if device_clock else {k: v * 1e3 for k, v in s["seconds"].items()}
    picked = [v for k, v in times.items() if (k in stages) == inside]
    if not picked:
        return None
    return sum(picked) / s["stripes"]


def stage_ms_per_unit(run, stage: str):
    """Host ms a request of one stage of the stage pass."""
    s = run.stages
    if not s or not s["units"] or stage not in s["seconds"]:
        return None
    return s["seconds"][stage] * 1e3 / s["units"]


def span_ms(run, name: str):
    """Mean host ms a unit of the driver's own span ``name`` in the traced loop."""
    got = [u.spans[name] for u in run.units if name in u.spans]
    return 1e3 * sum(got) / len(got) if got else None
