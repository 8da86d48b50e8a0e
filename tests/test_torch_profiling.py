"""The program's spans and counters (``stormtpu_torch.utils.profiling``):
off, a span point touches no torch function; unsynchronised (``record()``
and under ``torch.profiler``), the walks and the cross queries record
their stripes, stages, waits and bytes without changing an answer or the
order of the stripe writer; synchronised (``record_stages()``), the stage
times are what they were; ``trace(log_dir)`` writes the three files."""

import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

import stormtpu_torch as st
import stormtpu_torch.stream as ts
import stormtpu_torch.stream_query as tsq
from stormtpu_torch.kernels import mxu
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.utils import download, profiling

CFG = st.EngineConfig(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)
SB = 64


def _dense(n=150, m=640, seed=3):
    return (np.random.default_rng(seed).random((n, m)) < 0.3).astype(np.uint8)


def _topk(bm):
    return tsq.stream_topk_neighbors(bm, 4, superblock_rows=SB, kernel="mxu", config=CFG,
                                     device="cpu")


def _screen(bm):
    return tsq.stream_pairs_above(bm, 60, superblock_rows=SB, kernel="mxu", config=CFG,
                                  device="cpu")


def _hist(bm):
    xd = bm.device_padded2d(192, 32, device="cpu")  # cached on the matrix
    return ts.stream_count_histogram(xd, bm.n, bm.m_bits, n_bins=16, superblock_rows=SB,
                                     config=CFG, device="cpu")["hist"]


WALKS = {"topk": _topk, "screen": _screen, "hist": _hist}
N_STRIPES = 6  # 150 rows in superblocks of 64: three, so 3 · 4 / 2 stripes


def _raise(*args, **kwargs):
    raise AssertionError("a torch function was called on the off path")


def test_the_off_path_calls_no_profiler_and_no_event(monkeypatch):
    dense = _dense()
    for mod, name in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (profiling, "_record_function"), (torch.cuda, "Event"),
                      (torch.cuda, "synchronize")):
        monkeypatch.setattr(mod, name, _raise)
    before = profiling.profiled_recording()
    bm = st.BitMatrix.from_packed(st.BitMatrix.from_dense(dense).packed, dense.shape[1])
    rows, cols = np.nonzero(dense)
    st.BitMatrix.from_positions(rows, cols, dense.shape[0], dense.shape[1])
    for walk in WALKS.values():
        walk(bm)
    st.cross_topk_neighbors(st.BitMatrix.from_dense(dense[:20]), bm, 4, device="cpu")
    assert profiling.span("stpu.stream.job") is profiling.span("stpu.cross.request")
    assert profiling.stage("stream", "kernel", "cpu") is profiling.wait("download")
    after = profiling.profiled_recording()
    assert (len(after.spans), after.counters) == (len(before.spans), before.counters)


@pytest.mark.parametrize("name", sorted(WALKS))
def test_a_walk_under_the_profiler_records_its_stripes(tmp_path, name):
    bm = st.BitMatrix.from_dense(_dense())
    bm.device_padded2d(192, 32, device="cpu")  # the histogram's operand, made beforehand
    profiling.reset_profiled()
    with torch.profiler.profile() as prof:
        WALKS[name](bm)
    rec = profiling.profiled_recording()
    by_seq = {s.seq: s for s in rec.spans}
    (job,) = [s for s in rec.spans if s.name == "stpu.stream.job"]
    stripes = [s for s in rec.spans if s.name == "stpu.stream.stripe"]
    assert len(stripes) == N_STRIPES == rec.counters["stripes"]
    assert sorted(s.ids for s in stripes) == [(job.ids[0], i, j) for i in range(3)
                                              for j in range(i, 3)]
    assert all(s.parent == job.seq for s in stripes)
    for s in stripes:
        assert job.start_ns <= s.start_ns <= s.end_ns <= job.end_ns
        children = {c.name for c in rec.spans if c.parent == s.seq}
        assert {"stpu.stream.plan", "stpu.stream.kernel"} <= children
    waits = [s for s in rec.spans if s.name.startswith("stpu.wait.")]
    assert waits and len(waits) == rec.counters["waits"]
    # every wait lies under the job
    for w in waits:
        p = w
        while p.parent != -1 and p.seq != job.seq:
            p = by_seq[p.parent]
        assert p.seq == job.seq
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marked = Counter(e["name"] for e in events
                     if e.get("cat") == "user_annotation" and e["name"].startswith("stpu."))
    assert marked == Counter(s.name for s in rec.spans)


def test_the_unsynchronised_mode_changes_no_answer_and_no_order(tmp_path, monkeypatch):
    bm = st.BitMatrix.from_dense(_dense())
    plain = {name: walk(bm) for name, walk in WALKS.items()}
    with profiling.record() as rec:
        got = {name: walk(bm) for name, walk in WALKS.items()}
    for name in WALKS:
        for a, b in zip(np.atleast_1d(plain[name]), np.atleast_1d(got[name])):
            np.testing.assert_array_equal(a, b)
    assert rec.counters["stripes"] == 3 * N_STRIPES
    # the stripe writer: slow saves pile up beside the walk unless record_stages() holds it
    save_file, save, held = ts._save_stripe, ts._StripeWriter.save, []

    def slow_save(*args):
        time.sleep(0.02)
        save_file(*args)

    def watch(self, path, **members):
        save(self, path, **members)
        held.append(len(self.pending))

    monkeypatch.setattr(ts, "_save_stripe", slow_save)
    monkeypatch.setattr(ts._StripeWriter, "save", watch)
    kw = dict(superblock_rows=32, kernel="mxu", config=CFG, device="cpu", compress=False)
    with profiling.record():
        ts.stream_count_matrix(bm, str(tmp_path / "u"), **kw)
    assert max(held) > 1
    held.clear()
    with profiling.record_stages():
        ts.stream_count_matrix(bm, str(tmp_path / "s"), **kw)
    assert max(held) == 0


def test_record_stages_keeps_its_keys_beside_a_recording():
    bm = st.BitMatrix.from_dense(_dense())
    with profiling.record_stages() as alone:
        _topk(bm)
    with profiling.record() as rec, profiling.record_stages() as both:
        _topk(bm)
    assert set(both.seconds) == set(alone.seconds) >= {"plan", "kernel", "reduce", "merge"}
    assert both.stripes == alone.stripes == rec.counters["stripes"] == N_STRIPES
    assert both.routes == alone.routes == {mxu.ROUTE_TOPK: N_STRIPES}
    assert rec.counters[f"routes.{mxu.ROUTE_TOPK}"] == N_STRIPES
    assert not profiling.synchronised()


@pytest.mark.parametrize("na,nb,w", [(40, 100, 10), (64, 64, 8), (33, 250, 20)])
def test_byte_counters_equal_what_the_shapes_give(na, nb, w):
    rng = np.random.default_rng(na)
    a = rng.integers(0, 2**32, (na, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, (nb, w), dtype=np.uint32)
    ti, wk = mxu.k2_tile_shape(st.default_config(), max(na, nb), w)
    w_pad = -(-w // wk) * wk
    pads = [4 * (-(-r // ti) * ti) * w_pad for r in (na, nb)
            if (-(-r // ti) * ti, w_pad) != (r, w)]
    with profiling.record() as rec:
        ad, bd = to_device_words(a, "cpu"), to_device_words(b, "cpu")
        out = download(mxu.count_block_pallas_mxu(ad, bd))
    assert out.shape == (na, nb)
    assert rec.counters["h2d_bytes"] == a.nbytes + b.nbytes
    assert rec.counters["d2h_bytes"] == 4 * na * nb
    assert rec.counters.get("pad_bytes", 0) == sum(pads)
    assert sum(s.name == "stpu.kernels.pad" for s in rec.spans) == len(pads)
    assert rec.counters["waits"] == 3  # two uploads, one download


def test_the_layout_api_and_cross_spans_nest():
    dense = _dense(60, 300)
    rows, cols = np.nonzero(dense)
    with profiling.record() as rec:
        bm = st.BitMatrix.from_positions(rows, cols, 60, 300)
        st.BitMatrix.from_packed(bm.packed, 300)
        st.intersect_count_matrix(bm, device="cpu")
        st.cross_topk_neighbors(st.BitMatrix.from_dense(dense[:10]), bm, 3, device="cpu")
    by_seq = {s.seq: s for s in rec.spans}

    def children(name):
        (top,) = [s for s in rec.spans if s.name == name]
        return top, {s.name for s in rec.spans if s.parent == top.seq}

    _, kids = children("stpu.layout.from_positions")
    assert {"stpu.layout.pack", "stpu.layout.row_counts", "stpu.layout.coo_copy"} <= kids
    assert sum(s.name == "stpu.layout.from_packed" for s in rec.spans) == 2  # and from_dense
    _, kids = children("stpu.api.intersect_count_matrix")
    assert "stpu.dispatch.route" in kids
    assert sum(v for k, v in rec.counters.items() if k.startswith("dispatch.")) == 1
    request, kids = children("stpu.cross.request")
    assert request.ids[1:] == (10, 60)
    assert {"stpu.cross.plan", "stpu.cross.kernel", "stpu.cross.merge"} <= kids
    merge = next(s for s in rec.spans if s.name == "stpu.cross.merge")
    assert any(by_seq[s.parent] is merge for s in rec.spans if s.name == "stpu.wait.download")


def test_trace_writes_the_trace_the_spans_and_the_counters(tmp_path):
    bm = st.BitMatrix.from_dense(_dense())
    with profiling.trace(str(tmp_path)):
        _topk(bm)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [json.loads(line) for line in (tmp_path / "spans.jsonl").read_text().splitlines()]
    counters = json.loads((tmp_path / "counters.json").read_text())
    assert counters["stripes"] == N_STRIPES and counters["dropped_spans"] == 0
    assert {"seq", "name", "parent", "ids", "start_us", "end_us"} == set(spans[0])
    marks = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("stpu."):
            marks.setdefault(e["name"], []).append(float(e["ts"]))
    assert Counter(s["name"] for s in spans) == Counter({k: len(v) for k, v in marks.items()})
    # the spans' clock is the trace's: each starts within a few ms of a range of its name
    for s in spans:
        assert min(abs(t - s["start_us"]) for t in marks[s["name"]]) < 5e3
