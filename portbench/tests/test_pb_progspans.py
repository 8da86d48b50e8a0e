"""The metrics read from the program's own spans and counters: the
reader's normalisation on made-up recordings, and the five metrics on
the tiny cells, each a number or None where the tiny route has no such
span."""

import time

import pytest
import torch

from portbench import harness, progspans
from portbench.tests.tiny import TINY_TRAFFIC, merged_spec

NEW = ("stream_query.host_busy_ms", "stream_query.waits_per_stripe", "cross.host_busy_ms",
       "layout.from_packed_ms", "kernels.pad_gb.lookup")


def _rec(spans, counters=None, dropped=0):
    from stormtpu_torch.utils.profiling import Recording, SpanRecord

    rec = Recording()
    rec.spans = [SpanRecord(*s) for s in spans]
    rec.counters = dict(counters or {})
    rec.dropped = dropped
    return rec


MS = 1_000_000
# two stripes of one job: the first 10 ms with a 3-ms wait under a stage
# and a 1-ms wait nested in that wait; the second 6 ms with a 2-ms wait
SPANS = [
    (0, "stpu.stream.job", -1, (0,), 0, 30 * MS),
    (1, "stpu.stream.stripe", 0, (0, 0, 0), 0, 10 * MS),
    (2, "stpu.stream.plan", 1, (), 0, 5 * MS),
    (3, "stpu.wait.upload", 2, (), 1 * MS, 4 * MS),
    (4, "stpu.wait.download", 3, (), 2 * MS, 3 * MS),
    (5, "stpu.stream.stripe", 0, (0, 0, 1), 10 * MS, 16 * MS),
    (6, "stpu.wait.copy", 5, (), 12 * MS, 14 * MS),
    (7, "stpu.wait.download", 0, (), 20 * MS, 25 * MS),  # the job's own wait
]


def test_busy_ms_takes_the_outermost_waits_inside_each_span():
    rec = _rec(SPANS)
    assert progspans.busy_ms(rec, progspans.STRIPE) == pytest.approx(((10 - 3) + (6 - 2)) / 2)
    assert progspans.busy_ms(rec, "stpu.stream.job") == pytest.approx(30 - 3 - 2 - 5)
    assert progspans.mean_ms(rec, progspans.STRIPE) == pytest.approx(8)
    assert progspans.busy_ms(rec, progspans.REQUEST) is None
    assert progspans.mean_ms(rec, progspans.FROM_PACKED) is None


@pytest.mark.parametrize("counters,want", [({"waits": 5}, 2.5), ({"waits": 0}, 0.0), ({}, None)])
def test_counters_are_normalised_by_the_spans_they_count(counters, want):
    assert progspans.per_span(_rec(SPANS, counters), "waits", progspans.STRIPE) == want
    assert progspans.per_span(_rec(SPANS, counters), "waits", progspans.REQUEST) is None


def test_a_recording_that_dropped_spans_or_a_program_without_one_reads_none(monkeypatch):
    from stormtpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "profiled_recording", lambda: _rec(SPANS, dropped=1))
    assert progspans.recording() is None
    monkeypatch.delattr(profiling, "profiled_recording")
    assert progspans.recording() is None
    run = harness.Run(None, 0.0, [], 0.0, (0, 0))
    for name in NEW:
        assert harness.load_metric(progspans_root(), name).read(run) is None


def progspans_root():
    from portbench.tests.tiny import ROOT

    return ROOT


@pytest.mark.parametrize("workload", ["c4.topk16_stream", "c4.screen_stream", "c4.lookup64"])
def test_the_tiny_cells_report_the_new_metrics(tiny_root, workload):
    from stormtpu_torch.utils import profiling

    profiling.reset_profiled()
    out = harness.run_cell(tiny_root, workload, 2**33 + 7, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"]
    mine = {m["name"] for m in harness.metrics_of(merged_spec(), workload, True)} & set(NEW)
    assert mine
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    assert set(got) <= mine
    rec = profiling.profiled_recording()
    if workload == "c4.lookup64":
        # the tiny panel takes the plain product on the CPU: nothing is padded
        assert {"cross.host_busy_ms", "layout.from_packed_ms"} <= set(got)
        assert "kernels.pad_gb.lookup" not in got
        # the profiled window's requests; the stage pass after it records nothing
        n = sum(s.name == progspans.REQUEST for s in rec.spans)
        assert n == out["attempted"] - TINY_TRAFFIC["lookup64"]["stage_units"]
    else:
        assert set(got) == mine
        assert got["stream_query.host_busy_ms"] > 0
        assert got["stream_query.waits_per_stripe"] >= 0
        assert sum(s.name == progspans.STRIPE for s in rec.spans) == rec.counters["stripes"]
    assert all(v >= 0 for v in got.values())
