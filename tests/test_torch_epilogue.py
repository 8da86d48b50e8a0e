"""The reductions K2-topk and K2-hist fuse into K2's tile walk
(``stormtpu_torch.kernels.mxu``: ``count_tiles_topk``, ``count_tiles_hist``),
on the CPU, where the wrappers take their plain versions.

- The plain versions against ``count_tiles_plain`` followed by the
  reductions they replace (the tile walk's masks and ``query._top_rows``,
  the sinks' masked ``stream_hist._bin_counts``), and the top-k's tie rule
  (value descending, then the lower index) against numpy's.
- The rerouted paths against numpy's exact values and, on a subset of the
  cases, the JAX package's functions on the same inputs (its Pallas
  kernels in interpret mode): ``topk_neighbors`` on the tile walk,
  ``stream_topk_neighbors`` on K2 stripes (resident and on two slices),
  ``stream_count_histogram`` and ``stream_hist_streamed``.

Inputs are numpy arrays made from seeds. Counts are exact: values and
histograms are compared with tolerance 0. Top-k indices are validated
(distinct, never the row, each realizing its value), not compared with
the JAX package's: the order among equal values depends on the route."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.config as jconf
import stormtpu.dispatch as jdispatch
import stormtpu.stream as js
import stormtpu.stream_hist as jsh
import stormtpu.stream_query as jsq
import stormtpu_torch as st
import stormtpu_torch.config as tconf
import stormtpu_torch.dispatch as tdispatch
import stormtpu_torch.stream as ts
import stormtpu_torch.stream_hist as tsh
import stormtpu_torch.stream_query as tsq
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch.kernels import mxu
from stormtpu_torch.query import _top_rows
from stormtpu_torch.stream_hist import _bin_counts
from stormtpu_torch.utils import round_up, triangular_tile_ids

# K2 tiles of 32 rows (the port's K2 takes multiples of 32), so that small
# panels cross tile and superblock edges; K steps of 8 words
FIELDS = dict(k2_tile_rows=32, k2_tile_words=8)
KS = (1, 8, 16, 32, 33)  # 33 crosses to the store route
# the cases also run through the JAX package (in interpret mode, a second
# or two a call); every case is held to numpy's exact values
JAX_KS = (8, 33)


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


# the panels: F1's (N no multiple of the tile, sparse rows), all zeros, dense
PANELS = {
    "sparse70": lambda: _uniform(70, 512, 0.01, seed=0),
    "zeros33": lambda: np.zeros((33, 512), np.uint8),
    "dense100": lambda: _uniform(100, 600, 0.3, seed=3),
}


def _scores(dense):
    d = dense.astype(np.int64)
    c = d @ d.T
    np.fill_diagonal(c, -1)
    return c


def _assert_topk(vals, idx, dense, k):
    """Values are each row's k best counts off the diagonal (0 where a row
    has fewer than k partners); every partner set is valid: distinct,
    never the row, each index realizing its value."""
    c = _scores(dense)
    n = c.shape[0]
    assert vals.dtype == idx.dtype == np.int32 and vals.shape == idx.shape == (n, k)
    assert np.array_equal(vals, np.maximum(-np.sort(-c, axis=1)[:, :k], 0))
    if n > k:
        assert np.array_equal(c[np.arange(n)[:, None], idx], vals)
        for r in range(n):
            assert len(set(idx[r].tolist())) == k and r not in set(idx[r].tolist())


def _operand(dense, ti, wk):
    bm = st.BitMatrix.from_dense(dense)
    xp = torch.zeros((round_up(bm.n, ti), round_up(bm.n_words, wk)), dtype=torch.int32)
    xp[: bm.n, : bm.n_words] = torch.from_numpy(bm.packed.view(np.int32))
    return bm, xp


def _tile_lists(nb, seed):
    """The upper triangle, and every pair shuffled (tiles on both sides of
    the diagonal, as a stripe's list with local ids)."""
    tri = triangular_tile_ids(nb)
    ib, jb = (g.ravel().astype(np.int32) for g in np.meshgrid(np.arange(nb), np.arange(nb),
                                                              indexing="ij"))
    perm = np.random.default_rng(seed).permutation(ib.size)
    return {"tri": tri, "grid": (ib[perm], jb[perm])}


# ------------------------------------------------- the plain versions
@pytest.mark.parametrize("order", ("tri", "grid"))
@pytest.mark.parametrize("k", (1, 8, 16, 32))
@pytest.mark.parametrize("panel,ti,offsets,cut", [
    ("sparse70", 32, (0, 0), 0), ("dense100", 64, (0, 0), 7), ("dense100", 32, (2, 1), 0),
    ("zeros33", 32, (0, 0), 0), ("dense100", 160, (0, 0), 0),
])
def test_topk_plain_equals_tiles_then_the_store_routes_reduction(panel, ti, offsets, cut, k,
                                                                  order):
    """``count_tiles_topk_plain`` = ``count_tiles_plain``, the tile walk's
    masks (self pair, global row or column ≥ n_real) and its per-side top-k
    (``query._top_rows``) a sub-tile: equal values; indices that are the
    lower-index-first ranking of numpy's stable sort."""
    dense = PANELS[panel]()
    _, xp = _operand(dense, ti, 8)
    ib, jb = _tile_lists(xp.shape[0] // ti, seed=k)[order]
    ibs, jbs = torch.from_numpy(ib), torch.from_numpy(jb)
    n_real = dense.shape[0] - cut
    row_off, col_off = offsets[0] * ti, offsets[1] * ti
    got = mxu.count_tiles_topk_plain(xp, ibs, jbs, tile_rows=ti, tile_words=8, k=k,
                                     n_real=n_real, row_off=row_off, col_off=col_off)
    tiles = mxu.count_tiles_plain(xp, ibs, jbs, tile_rows=ti, tile_words=8)
    kk = min(k, ti)
    bm_, bn_ = mxu.EPI_BLOCK
    lane = np.arange(ti)
    for t in range(ib.size):
        gr = row_off + ib[t] * ti + lane
        gc = col_off + jb[t] * ti + lane
        bad = (gr[:, None] == gc[None, :]) | (gr[:, None] >= n_real) | (gc[None, :] >= n_real)
        m = np.where(bad, -1, tiles[t].numpy())
        for s, c0 in enumerate(range(0, ti, bn_)):
            block = m[:, c0 : c0 + bn_]
            v, _ = _top_rows(torch.from_numpy(block), kk)
            assert np.array_equal(got.row_v[t, s].numpy(), v.numpy())
            order_ = np.argsort(-block, axis=1, kind="stable")[:, :kk]
            assert np.array_equal(got.row_i[t, s].numpy(), gc[c0 + order_])
        diag = gr[0] == gc[0]
        for s, r0 in enumerate(range(0, ti, bm_)):
            block = m[r0 : r0 + bm_].T
            if diag:
                assert (got.col_v[t, s] == -1).all() and (got.col_i[t, s] == -1).all()
                continue
            v, _ = _top_rows(torch.from_numpy(np.ascontiguousarray(block)), kk)
            assert np.array_equal(got.col_v[t, s].numpy(), v.numpy())
            order_ = np.argsort(-block, axis=1, kind="stable")[:, :kk]
            assert np.array_equal(got.col_i[t, s].numpy(), gr[r0 + order_])


@pytest.mark.parametrize("n_bins,bin_width", [(64, None), (1, None), (5, 1 << 20), (600, 1),
                                              (3, 2)])
@pytest.mark.parametrize("panel,offsets,cut", [("sparse70", (0, 0), 0), ("dense100", (2, 1), 9),
                                               ("zeros33", (0, 0), 0)])
def test_hist_plain_equals_tiles_then_the_store_routes_bin_count(panel, offsets, cut, n_bins,
                                                                  bin_width):
    """``count_tiles_hist_plain`` = ``count_tiles_plain`` and the sinks'
    masked bin count (valid pairs: global row < global column < n_real;
    ``_bin_counts`` with a spare bin for the rest): one bin, a width past
    M, a bin a value, crowded bins."""
    dense = PANELS[panel]()
    _, xp = _operand(dense, 32, 8)
    ib, jb = _tile_lists(xp.shape[0] // 32, seed=n_bins)["grid"]
    ibs, jbs = torch.from_numpy(ib), torch.from_numpy(jb)
    n_real = dense.shape[0] - cut
    width = bin_width or ts.default_hist_bin_width(dense.shape[1], n_bins)
    row_off, col_off = offsets[0] * 32, offsets[1] * 32
    got = mxu.count_tiles_hist_plain(xp, ibs, jbs, tile_rows=32, tile_words=8, n_real=n_real,
                                     bin_width=width, n_bins=n_bins, row_off=row_off,
                                     col_off=col_off)
    tiles = mxu.count_tiles_plain(xp, ibs, jbs, tile_rows=32, tile_words=8)
    lane = torch.arange(32)
    rows_g = row_off + ibs.long()[:, None] * 32 + lane
    cols_g = col_off + jbs.long()[:, None] * 32 + lane
    valid = (rows_g[:, :, None] < cols_g[:, None, :]) & (cols_g[:, None, :] < n_real)
    bins = torch.clamp(tiles // width, max=n_bins - 1)
    want = _bin_counts(torch.where(valid, bins, n_bins), n_bins + 1)[:n_bins]
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int(got.sum()) == int(valid.sum())


@pytest.mark.parametrize("panel,ti", [("dense100", 32), ("sparse70", 160)])
def test_wrappers_on_cpu_tensors_take_the_plain_versions(panel, ti):
    """On CPU tensors ``count_tiles_topk`` and ``count_tiles_hist`` return
    their plain versions' results, and count no launch."""
    dense = PANELS[panel]()
    _, xp = _operand(dense, ti, 8)
    ib, jb = _tile_lists(xp.shape[0] // ti, seed=ti)["grid"]
    ibs, jbs = torch.from_numpy(ib), torch.from_numpy(jb)
    kw = dict(tile_rows=ti, tile_words=8, n_real=dense.shape[0] - 3, row_off=ti, col_off=0)
    mxu.reset_launches()
    got = mxu.count_tiles_topk(xp, ibs, jbs, k=8, **kw)
    want = mxu.count_tiles_topk_plain(xp, ibs, jbs, k=8, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    hkw = dict(bin_width=3, n_bins=17, **kw)
    got_h = mxu.count_tiles_hist(xp, ibs, jbs, **hkw)
    assert torch.equal(got_h, mxu.count_tiles_hist_plain(xp, ibs, jbs, **hkw))
    assert mxu.LAUNCHES["k2_topk"] == mxu.LAUNCHES["k2_hist"] == 0


def test_epilogue_wrappers_refuse_past_their_limits():
    xp = torch.zeros((64, 8), dtype=torch.int32)
    ids = torch.zeros(1, dtype=torch.int32)
    kw = dict(tile_rows=32, tile_words=8, n_real=64)
    with pytest.raises(ValueError, match="k=33"):
        mxu.count_tiles_topk(xp, ids, ids, k=mxu.TOPK_EPI_MAX + 1, **kw)
    with pytest.raises(ValueError, match="k=0"):
        mxu.count_tiles_topk(xp, ids, ids, k=0, **kw)
    with pytest.raises(ValueError, match="n_bins"):
        mxu.count_tiles_hist(xp, ids, ids, bin_width=1, n_bins=mxu.HIST_EPI_MAX_BINS + 1, **kw)
    with pytest.raises(ValueError, match="bin_width"):
        mxu.count_tiles_hist(xp, ids, ids, bin_width=0, n_bins=4, **kw)
    with pytest.raises(ValueError, match="tile ids"):
        mxu.count_tiles_topk(xp, ids + 2, ids, k=4, **kw)
    assert mxu.topk_route(32) == mxu.ROUTE_TOPK and mxu.topk_route(33) != mxu.ROUTE_TOPK
    assert mxu.topk_route(8, partial=True) != mxu.ROUTE_TOPK
    assert mxu.hist_route(mxu.HIST_EPI_MAX_BINS) == mxu.ROUTE_HIST
    assert mxu.hist_route(mxu.HIST_EPI_MAX_BINS + 1) != mxu.ROUTE_HIST


# ------------------------------------------- the paths against the JAX package
@pytest.fixture
def tile_route(monkeypatch):
    """Both packages at 32-row tiles, D1 forced to the K2 tile walk."""
    monkeypatch.setattr(jconf, "_DEFAULT", jconf.EngineConfig(**FIELDS))
    monkeypatch.setattr(tconf, "_DEFAULT", tconf.EngineConfig(**FIELDS))
    monkeypatch.setattr(jdispatch, "choose_strategy", lambda *a, **k: "pallas_mxu")
    monkeypatch.setattr(tdispatch, "choose_strategy", lambda *a, **k: "pallas_mxu")


@pytest.mark.parametrize("panel,k", [(p, k) for p in ("sparse70", "zeros33", "dense100")
                                     for k in KS if k < PANELS[p]().shape[0]])
def test_topk_neighbors_tile_walk_equals_numpy_and_jax(tile_route, panel, k):
    dense = PANELS[panel]()
    with ts.record_stages() as rec:
        vals, idx = st.topk_neighbors(dense, k, device="cpu")
    assert set(rec.routes) == {mxu.topk_route(k)}
    if k in JAX_KS:
        assert np.array_equal(vals, stormtpu.topk_neighbors(dense, k)[0])
    _assert_topk(vals, idx, dense, k)


@pytest.mark.parametrize("k", (1, 16, 29))
def test_topk_neighbors_diagonal_only_walk_equals_jax(tile_route, k):
    """One row block: the walk's one tile is diagonal and offers its rows'
    side only."""
    dense = _uniform(30, 700, 0.2, seed=k)
    vals, idx = st.topk_neighbors(dense, k, device="cpu")
    assert np.array_equal(vals, stormtpu.topk_neighbors(dense, k)[0])
    _assert_topk(vals, idx, dense, k)


@functools.lru_cache(maxsize=None)
def _jax_stream_topk(panel, k):
    """The JAX package's streamed top-k of a panel (one call serves the
    resident and the two-slice cases)."""
    return jsq.stream_topk_neighbors(stormtpu.BitMatrix.from_dense(PANELS[panel]()), k,
                                     superblock_rows=64, kernel="mxu",
                                     config=JaxConfig(**FIELDS), interpret=True)


@pytest.mark.parametrize("k", (8, 32))
def test_topk_neighbors_tile_walk_at_two_sub_tile_rows(monkeypatch, k):
    """256-row tiles: each tile has two 128-row sub-tiles, so a column gets
    two sets a tile, cut to one before the merge."""
    fields = dict(k2_tile_rows=256, k2_tile_words=8)
    monkeypatch.setattr(tconf, "_DEFAULT", tconf.EngineConfig(**fields))
    monkeypatch.setattr(tdispatch, "choose_strategy", lambda *a, **kw: "pallas_mxu")
    dense = _uniform(300, 256, 0.2, seed=k)
    with ts.record_stages() as rec:
        vals, idx = st.topk_neighbors(dense, k, device="cpu")
    assert rec.routes == {mxu.ROUTE_TOPK: 1}
    _assert_topk(vals, idx, dense, k)


def _port_stream_topk(bm, k, sb, **kw):
    return tsq.stream_topk_neighbors(bm, k, superblock_rows=sb, kernel="mxu",
                                     config=st.EngineConfig(**FIELDS), device="cpu", **kw)


@pytest.mark.parametrize("streaming", (False, True), ids=("resident", "slices"))
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("panel", ("sparse70", "dense100"))
def test_stream_topk_on_k2_stripes_equals_numpy_and_jax(monkeypatch, panel, k, streaming):
    """Superblocks of 64 rows: diagonal and off-diagonal stripes, both
    orientations, a partial last superblock."""
    dense = PANELS[panel]()
    bj = stormtpu.BitMatrix.from_dense(dense)
    bt = st.BitMatrix.from_packed(bj.packed, bj.m_bits)
    if streaming:
        monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
    calls = []
    real = tsq._stripe_topk_sets
    monkeypatch.setattr(tsq, "_stripe_topk_sets",
                        lambda src, *a: calls.append(src.streaming) or real(src, *a))
    with ts.record_stages() as rec:
        got = _port_stream_topk(bt, k, 64)
    assert set(rec.routes) == {mxu.topk_route(k)}
    assert calls == ([streaming] * 3 if k <= mxu.TOPK_EPI_MAX else [])
    if k in JAX_KS:
        assert np.array_equal(got[0], _jax_stream_topk(panel, k)[0])
    _assert_topk(*got, dense, k)


def test_stream_topk_diagonal_only_walk_and_zero_panel():
    """One superblock (a diagonal stripe alone); an all-zero panel, whose
    stripes are all co-empty and skipped."""
    dense = _uniform(60, 500, 0.3, seed=4)
    got = _port_stream_topk(st.BitMatrix.from_dense(dense), 8, 64)
    _assert_topk(*got, dense, 8)
    zeros = PANELS["zeros33"]()
    with ts.record_stages() as rec:
        vals, idx = _port_stream_topk(st.BitMatrix.from_dense(zeros), 8, 32)
    assert rec.launched == 0 and not vals.any() and not idx.any()


def _hist_inputs(panel):
    dense = PANELS[panel]()
    bj = stormtpu.BitMatrix.from_dense(dense)
    xp = np.zeros((round_up(dense.shape[0], 64), round_up(bj.n_words, 8)), np.uint32)
    xp[: dense.shape[0], : bj.n_words] = bj.packed
    return dense, bj, xp


HIST_CASES = [(64, None), (1, None), (4, 1 << 12), (600, 1), (6, 3)]
JAX_HIST_CASES = HIST_CASES[::4]


def _oracle_hist(dense, n_bins, bin_width):
    d = dense.astype(np.int64)
    up = (d @ d.T)[np.triu_indices(dense.shape[0], 1)]
    width = bin_width or ts.default_hist_bin_width(dense.shape[1], n_bins)
    return np.bincount(np.minimum(up // width, n_bins - 1), minlength=n_bins)


@functools.lru_cache(maxsize=None)
def _jax_hist(panel, n_bins, bin_width):
    """The JAX package's histogram sink of a panel at superblock 64 (the
    streamed walk's histogram is the same)."""
    dense, _, xp = _hist_inputs(panel)
    return js.stream_count_histogram(jnp.asarray(xp), *dense.shape, config=JaxConfig(**FIELDS),
                                     interpret=True, n_bins=n_bins, bin_width=bin_width,
                                     superblock_rows=64)["hist"]


@pytest.mark.parametrize("n_bins,bin_width", HIST_CASES)
@pytest.mark.parametrize("panel", ("sparse70", "dense100"))
def test_stream_count_histogram_equals_numpy_and_jax(panel, n_bins, bin_width):
    """The resident sink through K2-hist: one bin, a width past M (every
    pair in bin 0), a bin a value, crowded bins."""
    dense, bj, xp = _hist_inputs(panel)
    n, m = dense.shape
    kw = dict(n_bins=n_bins, bin_width=bin_width, superblock_rows=64)
    with ts.record_stages() as rec:
        got = ts.stream_count_histogram(xp, n, m, config=st.EngineConfig(**FIELDS),
                                        device="cpu", **kw)
    assert set(rec.routes) == {mxu.ROUTE_HIST}
    assert np.array_equal(got["hist"], _oracle_hist(dense, n_bins, bin_width))
    if (n_bins, bin_width) in JAX_HIST_CASES:
        assert np.array_equal(got["hist"], _jax_hist(panel, n_bins, bin_width))
    assert got["hist"].dtype == np.int64 and int(got["hist"].sum()) == n * (n - 1) // 2


@pytest.mark.parametrize("n_bins,bin_width", HIST_CASES)
def test_stream_hist_streamed_equals_numpy_and_jax(n_bins, bin_width):
    """The two-slice walk's dense stripes (``_PairStripes``) through
    K2-hist, the j slice's tiles shifted by a superblock."""
    dense, bj, _ = _hist_inputs("dense100")
    kw = dict(n_bins=n_bins, bin_width=bin_width, superblock_rows=64)
    with ts.record_stages() as rec:
        got = tsh.stream_hist_streamed(st.BitMatrix.from_packed(bj.packed, bj.m_bits),
                                       config=st.EngineConfig(**FIELDS), device="cpu", **kw)
    assert set(rec.routes) == {mxu.ROUTE_HIST}
    assert np.array_equal(got["hist"], _oracle_hist(dense, n_bins, bin_width))
    if (n_bins, bin_width) in JAX_HIST_CASES:
        assert np.array_equal(got["hist"], _jax_hist("dense100", n_bins, bin_width))
    if (n_bins, bin_width) == HIST_CASES[0]:
        want = jsh.stream_hist_streamed(bj, config=JaxConfig(**FIELDS), interpret=True, **kw)
        assert np.array_equal(got["hist"], want["hist"])


def test_histogram_store_route_above_the_bin_cap(monkeypatch):
    """Past ``HIST_EPI_MAX_BINS`` the sinks bin the stored tiles: the same
    histogram."""
    dense, bj, xp = _hist_inputs("dense100")
    n, m = dense.shape
    kw = dict(n_bins=40, superblock_rows=64, config=st.EngineConfig(**FIELDS), device="cpu")
    want = ts.stream_count_histogram(xp, n, m, **kw)
    monkeypatch.setattr(mxu, "HIST_EPI_MAX_BINS", 39)
    with ts.record_stages() as rec:
        got = ts.stream_count_histogram(xp, n, m, **kw)
    assert set(rec.routes) == {"store (n_bins > 39)"}
    assert np.array_equal(got["hist"], want["hist"])
