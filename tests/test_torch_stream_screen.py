"""The streamed screen's compaction on the CPU (``kernels.screen``'s plain
form and ``stream_query._ScreenHits``): the hits of a stripe equal the
packed-bitmap screen's that it replaced, for every measure; a walk whose
hit buffer starts too small screens its stripes again and gives the same
answer; and the stripe files of ``out_dir`` keep their format (global
rows, columns and counts, int64, row-major), array for array.

Counts are integers and the screen values are compared as the walk
compares them, so every comparison is exact."""

import os

import numpy as np
import pytest
import torch

import stormtpu_torch as st
import stormtpu_torch.stream_query as tsq
from stormtpu_torch.kernels import screen
from stormtpu_torch.query import (_expand_words, _pack_bit_rows, _screen_vals,
                                  _validate_screen)
from stormtpu_torch.utils import profiling

SCREENS = [("count", 30), ("jaccard", 0.22), ("dice", 0.36), ("cosine", 0.36),
           ("overlap", 0.4), ("phi", 0.1), ("r2", 0.02)]
CFG = st.EngineConfig(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)


def _stripe(sb, seed, diagonal):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, (sb, sb)).astype(np.int32)
    counts[rng.random((sb, sb)) < 0.2] = 0
    if diagonal:
        counts = np.triu(counts) + np.triu(counts, 1).T
    nnz = rng.integers(60, 200, 2 * sb).astype(np.int32)
    return torch.from_numpy(counts), torch.from_numpy(nnz)


def _bitmap_screen(counts, nnz_i, nnz_j, row0, col0, n, thresh, m_f, measure):
    """The packed-bitmap screen the compaction replaced: the hit bits of the
    float32 values in the global strict upper triangle, expanded on the
    host row-major, their counts gathered."""
    vals = _screen_vals(counts, nnz_i, nnz_j, m_f, measure)
    rows = torch.arange(counts.shape[0])[:, None] + row0
    cols = torch.arange(counts.shape[1])[None, :] + col0
    bits = _pack_bit_rows((vals >= thresh) & (cols > rows) & (rows < n) & (cols < n))
    li, lj = _expand_words(bits.numpy().view(np.uint32), counts.shape[1])
    return li, lj, counts.numpy()[li, lj].astype(np.int64)


@pytest.mark.parametrize("n,diagonal", [(180, False), (180, True), (250, False)])
@pytest.mark.parametrize("measure,threshold", [("count", 40), ("jaccard", 0.2), ("dice", 0.3),
                                               ("cosine", 0.3), ("overlap", 0.4),
                                               ("phi", 0.1), ("r2", 0.05)])
def test_compaction_equals_the_bitmap_screen(measure, threshold, n, diagonal):
    sb = 96
    counts, nnz = _stripe(sb, seed=len(measure) + n, diagonal=diagonal)
    row0, col0 = (96, 96) if diagonal else (0, 96)
    t = float(_validate_screen(measure, threshold))
    args = (nnz[:sb], nnz[sb:], row0, col0, n, t, 4096.0)
    want = _bitmap_screen(counts, *args, measure)
    assert want[0].size > 0
    out = screen.hit_buffer(sb * sb, "cpu")
    screen.stripe_screen(counts, *args, measure, out)
    total = int(out[0])
    assert total == want[0].size
    got = out[1:1 + 3 * total].view(total, 3).numpy()
    for k in range(3):
        assert np.array_equal(got[:, k], want[k])
    hits = tsq._ScreenHits(torch.device("cpu"))
    for g, w in zip(hits.collect(hits.launch(counts, *args, measure)), want):
        assert g.dtype == np.int64 and np.array_equal(g, w)


def _spy_screens(monkeypatch):
    """The stripe screens a walk's buffers run, counted."""
    screens = []
    real = tsq._stripe_screen
    monkeypatch.setattr(tsq, "_stripe_screen", lambda *a, **k: screens.append(1) or real(*a, **k))
    return screens


def test_compaction_buffer_past_its_end(monkeypatch):
    """The total counts every hit; only the first ``cap`` are written. A
    walk's first stripe past its buffers is screened again into a buffer
    grown to fit; the next stripe's copy holds as many hits. A stripe past
    its copy but not its grown buffer (here after a stripe of no hit) has
    the rest read from that buffer, without a second screen. Both count
    ``screen_refetch``."""
    sb = 64
    counts, nnz = _stripe(sb, seed=3, diagonal=False)
    args = (counts, nnz[:sb], nnz[sb:], 0, sb, 2 * sb, 40.0, 4096.0, "count")
    none = args[:6] + (1e6,) + args[7:]
    full = screen.hit_buffer(sb * sb, "cpu")
    screen.stripe_screen(*args, full)
    small = screen.hit_buffer(3, "cpu")
    screen.stripe_screen(*args, small)
    assert int(small[0]) == int(full[0]) > 3
    assert torch.equal(small[1:], full[1:10])
    monkeypatch.setattr(tsq, "_SCREEN_HITS", 3)
    screens = _spy_screens(monkeypatch)
    hits = tsq._ScreenHits(torch.device("cpu"))
    want = _bitmap_screen(*args)
    with profiling.record() as rec:
        for a in (args, args, none, args):
            for g, w in zip(hits.collect(hits.launch(*a)), want if a is args else [[]] * 3):
                assert g.dtype == np.int64 and np.array_equal(g, w)
    assert rec.counters["screen_refetch"] == 2 and len(screens) == 5
    assert hits.cap >= int(full[0])


def test_copies_follow_the_walks_hits(monkeypatch):
    """After a stripe of many hits the copy holds as many; after a stripe
    of few it shrinks back to its least, and a stripe of few hits comes
    back in that one small copy, screened once."""
    sb = 64
    counts, nnz = _stripe(sb, seed=5, diagonal=False)
    many = (counts, nnz[:sb], nnz[sb:], 0, sb, 2 * sb, 40.0, 4096.0, "count")
    few = (counts, nnz[:sb], nnz[sb:], 0, sb, sb + 4, 58.0, 4096.0, "count")
    monkeypatch.setattr(tsq, "_SCREEN_HITS", 8)
    hits = tsq._ScreenHits(torch.device("cpu"))
    hits.collect(hits.launch(*many))
    assert hits.cap >= hits.last > 8
    want = _bitmap_screen(*few)
    assert 0 < want[0].size <= 8
    screens = _spy_screens(monkeypatch)
    copied = []
    for a in (many, few, few):
        with profiling.record() as rec:
            hits.collect(hits.launch(*a))
        copied.append(rec.counters["d2h_bytes"])
        assert "screen_refetch" not in rec.counters
    assert copied == [4 * (1 + 3 * hits.cap)] * 2 + [4 * (1 + 3 * 8)] and len(screens) == 3
    for g, w in zip(hits.collect(hits.launch(*few)), want):
        assert g.dtype == np.int64 and np.array_equal(g, w)


def test_compaction_refuses_what_the_kernel_does_not_take():
    counts, nnz = _stripe(32, seed=4, diagonal=False)
    out = screen.hit_buffer(8, "cpu")
    with pytest.raises(ValueError, match="unknown measure"):
        screen.stripe_screen(counts, nnz[:32], nnz[32:], 0, 32, 64, 1.0, 64.0, "hamming", out)
    with pytest.raises(ValueError, match="int32 stripe"):
        screen.stripe_screen(counts.long(), nnz[:32], nnz[32:], 0, 32, 64, 1.0, 64.0, "count",
                             out)
    with pytest.raises(ValueError, match="nnz_cols"):
        screen.stripe_screen(counts, nnz[:32], nnz[:31], 0, 32, 64, 1.0, 64.0, "count", out)
    with pytest.raises(ValueError, match="hit buffer"):
        screen.stripe_screen(counts, nnz[:32], nnz[32:], 0, 32, 64, 1.0, 64.0, "count",
                             out.long())


def _bm(n=60, m=600, seed=74):
    bits = np.random.default_rng(seed).random((n, m)) < 0.3
    return st.BitMatrix.from_dense(bits)


def _walk(bm, threshold, measure, out_dir=None):
    return tsq.stream_pairs_above(bm, threshold, measure=measure, superblock_rows=16,
                                  kernel="mxu", config=CFG, out_dir=out_dir, device="cpu")


def _stripe_files(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.startswith("hits_"))


@pytest.mark.parametrize("measure,threshold", SCREENS)
def test_refetch_from_a_small_buffer_equals_the_unpatched_walk(tmp_path, monkeypatch, measure,
                                                               threshold):
    """Initial room for no hit: stripes with any are screened again into a
    grown buffer (``screen_refetch``); the arrays and stripe files equal a
    walk's that never refetches."""
    bm = _bm()
    want = _walk(bm, threshold, measure, str(tmp_path / "want"))
    monkeypatch.setattr(tsq, "_SCREEN_HITS", 0)
    with profiling.record() as rec:
        got = _walk(bm, threshold, measure, str(tmp_path / "got"))
    assert 1 <= rec.counters.get("screen_refetch", 0) <= rec.counters["stripes"]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert _stripe_files(tmp_path / "got") == _stripe_files(tmp_path / "want")
    for name in _stripe_files(tmp_path / "want"):
        with np.load(tmp_path / "got" / name) as zg, np.load(tmp_path / "want" / name) as zw:
            for key in ("ii", "jj", "counts"):
                assert zg[key].dtype == zw[key].dtype and zg[key].tobytes() == zw[key].tobytes()


@pytest.mark.parametrize("measure,threshold", SCREENS)
def test_stripe_files_keep_their_row_major_format(tmp_path, measure, threshold):
    """Each ``hits_{i}_{j}.npz`` holds the stripe's float32-screen candidates
    as global rows ``ii``, columns ``jj`` and counts, int64, row-major:
    built here from the whole count matrix, byte for byte."""
    bm = _bm(seed=93)
    _walk(bm, threshold, measure, str(tmp_path))
    sb, n_super = 32, 2  # 60 rows in superblocks of 32 (the K2 tile), padded to 64
    dense = np.unpackbits(bm.packed.view(np.uint8), axis=1, bitorder="little")[:, :bm.m_bits]
    c = torch.zeros((sb * n_super, sb * n_super), dtype=torch.int32)
    c[:bm.n, :bm.n] = torch.from_numpy(dense.astype(np.int32) @ dense.astype(np.int32).T)
    nnz = torch.zeros(sb * n_super, dtype=torch.int32)
    nnz[:bm.n] = torch.from_numpy(bm.row_nnz.astype(np.int32))
    t = float(_validate_screen(measure, threshold))
    names = _stripe_files(tmp_path)
    assert len(names) == n_super * (n_super + 1) // 2
    for i in range(n_super):
        for j in range(i, n_super):
            r, q = slice(i * sb, (i + 1) * sb), slice(j * sb, (j + 1) * sb)
            li, lj, cv = _bitmap_screen(c[r, q], nnz[r], nnz[q], i * sb, j * sb, bm.n, t,
                                        float(np.float32(bm.m_bits)), measure)
            want = {"ii": li + i * sb, "jj": lj + j * sb, "counts": cv}
            with np.load(tmp_path / f"hits_{i:05d}_{j:05d}.npz") as z:
                assert sorted(z.files) == sorted(want)
                for key, w in want.items():
                    assert z[key].dtype == np.int64 and z[key].shape == w.shape
                    assert z[key].tobytes() == w.astype(np.int64).tobytes()
