"""The port's queries (``stormtpu_torch.query``: ``pair_counts``,
``topk_neighbors``, ``pairs_above``) against the JAX package's on the CPU,
on shared seeded numpy inputs, route by route: the block form, the
triangular K2 tile walk (forced, at 32-row tiles, with chunks of one, a
few and all tiles), the block-clustered host route, the sparse host
filter, the similarity top-k, the two-phase fetch and its dense-screen
fallback. The JAX side runs its Pallas kernels in interpret mode.

Counts and float64 values are compared exactly (tolerance 0). Top-k values
are compared exactly; indices are validated (distinct, never the row
itself, and the count at each index is its value), never compared: the
order among equal counts depends on the route, in the reference too."""

import numpy as np
import pytest

import stormtpu
import stormtpu.config as jconf
import stormtpu.dispatch as jdispatch
import stormtpu.query as jq
import stormtpu_torch as st
import stormtpu_torch.config as tconf
import stormtpu_torch.dispatch as tdispatch
import stormtpu_torch.query as tq

SIM_OPS = ("jaccard", "dice", "cosine", "overlap", "phi", "r2")
TILE = dict(k2_tile_rows=32, k2_tile_words=8)
CLUSTERED = dict(k2_tile_rows=32, k2_tile_words=128)


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


def _block_diagonal(n, m, n_blocks, density, seed):
    """Row block b occupies only bit stripe b (the LD-panel shape)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, m), np.uint8)
    rows = np.linspace(0, n, n_blocks + 1).astype(int)
    cols = np.linspace(0, m, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        r0, r1, c0, c1 = rows[b], rows[b + 1], cols[b], cols[b + 1]
        dense[r0:r1, c0:c1] = rng.random((r1 - r0, c1 - c0)) < density
    return dense


def _counts(dense):
    d = dense.astype(np.int64)
    return d @ d.T


@pytest.fixture
def configs(monkeypatch):
    """Set both packages' default configuration to the same fields."""
    def use(fields):
        monkeypatch.setattr(jconf, "_DEFAULT", jconf.EngineConfig(**fields))
        monkeypatch.setattr(tconf, "_DEFAULT", tconf.EngineConfig(**fields))
    return use


@pytest.fixture
def tile_route(monkeypatch, configs):
    """Force the K2 tile-walk routes of both packages at 32-row tiles."""
    configs(TILE)
    monkeypatch.setattr(jdispatch, "choose_strategy", lambda *a, **k: "pallas_mxu")
    monkeypatch.setattr(tdispatch, "choose_strategy", lambda *a, **k: "pallas_mxu")


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert np.array_equal(g, w)


def _assert_valid_topk(vals, idx, score, k):
    """Each row's indices are distinct, never the row, and score[i, idx]
    equals the value; values sorted descending."""
    n = score.shape[0]
    assert vals.shape == idx.shape == (n, k) and idx.dtype == np.int32
    assert np.array_equal(score[np.arange(n)[:, None], idx], vals)
    assert np.all(np.diff(vals, axis=1) <= 0)
    for r in range(n):
        assert len(set(idx[r].tolist())) == k and r not in set(idx[r].tolist())


# ------------------------------------------------------------ pair counts
def test_pair_counts_equal_jax_and_numpy():
    dense = _uniform(90, 700, 0.3, seed=1)
    rng = np.random.default_rng(2)
    ii, jj = rng.integers(0, 90, 777), rng.integers(0, 90, 777)
    got = st.pair_counts(dense, ii, jj, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, stormtpu.pair_counts(dense, ii, jj))
    assert np.array_equal(got, _counts(dense)[ii, jj])


def test_pair_counts_chunked_gather(monkeypatch):
    dense = _uniform(50, 1000, 0.4, seed=3)
    bm = st.BitMatrix.from_dense(dense)
    monkeypatch.setattr(tq, "_PAIR_GATHER_MAX_WORDS", 16 * bm.n_words)  # 16 rows a chunk
    rng = np.random.default_rng(4)
    ii, jj = rng.integers(0, 50, 101), rng.integers(0, 50, 101)
    assert np.array_equal(st.pair_counts(bm, ii, jj, device="cpu"), _counts(dense)[ii, jj])


def test_pair_counts_reuse_a_larger_padded_copy():
    dense = _uniform(40, 300, 0.5, seed=5)
    bm = st.BitMatrix.from_dense(dense)
    bigger = bm.device_padded2d(64, 16, device="cpu")
    assert bm.device_padded(40, device="cpu", reuse_larger=True) is bigger
    ii = np.arange(40)
    assert np.array_equal(st.pair_counts(bm, ii, ii[::-1], device="cpu"),
                          _counts(dense)[ii, ii[::-1]])


def test_pair_counts_validation_and_empty():
    dense = _uniform(10, 64, 0.5, seed=6)
    assert st.pair_counts(dense, [], [], device="cpu").shape == (0,)
    for fn, kw in ((st.pair_counts, {"device": "cpu"}), (stormtpu.pair_counts, {})):
        with pytest.raises(ValueError, match="out of range"):
            fn(dense, [0, 10], [1, 2], **kw)
        with pytest.raises(ValueError, match="equal-length"):
            fn(dense, [0, 1], [1], **kw)


# ------------------------------------------------------------ top-k
@pytest.mark.parametrize("k", [1, 6, 129])
def test_topk_block_route_equals_jax(k):
    dense = _uniform(130, 700, 0.3, seed=7)
    vals, idx = st.topk_neighbors(dense, k, device="cpu")
    want, _ = stormtpu.topk_neighbors(dense, k)
    assert vals.dtype == np.int32 and np.array_equal(vals, want)
    _assert_valid_topk(vals, idx, _counts(dense), k)


def test_topk_block_rows_crosses_blocks():
    dense = _uniform(100, 500, 0.3, seed=8)
    vals, idx = st.topk_neighbors(dense, 4, block_rows=32, device="cpu")
    assert np.array_equal(vals, stormtpu.topk_neighbors(dense, 4, block_rows=32)[0])
    _assert_valid_topk(vals, idx, _counts(dense), 4)


@pytest.mark.parametrize("chunk_tiles", [1, 4, 10_000])
@pytest.mark.parametrize("n,k", [(130, 6), (130, 129), (33, 31)])
def test_topk_tile_route_equals_jax(tile_route, monkeypatch, chunk_tiles, n, k):
    monkeypatch.setattr(tq, "_SCREEN_TILE_CHUNK_BYTES", chunk_tiles * 4 * 32 * 32)
    dense = _uniform(n, 600, 0.3, seed=n + k)
    vals, idx = st.topk_neighbors(dense, k, device="cpu")
    want, _ = stormtpu.topk_neighbors(dense, k)
    assert np.array_equal(vals, want)
    _assert_valid_topk(vals, idx, _counts(dense), k)


def test_topk_tile_walk_merges_every_tile_once(tile_route):
    """k above the tile side: the transposed side offers min(k, ti) a tile."""
    dense = _uniform(100, 300, 0.5, seed=9)
    vals, idx = st.topk_neighbors(dense, 40, device="cpu")
    assert np.array_equal(vals, stormtpu.topk_neighbors(dense, 40)[0])
    _assert_valid_topk(vals, idx, _counts(dense), 40)


def test_blocked_tile_order_lists_each_upper_tile_once():
    ib, jb = tq._blocked_tile_ids(37, 8)
    assert sorted(zip(ib.tolist(), jb.tolist())) == [(i, j) for i in range(37)
                                                    for j in range(i, 37)]
    block = (ib // 8) * 5 + jb // 8
    assert np.all(np.diff(block) >= 0)  # block-row major, one block after the other


# sparse and empty rows with N not a multiple of the block: padded rows
# count 0 and tie with real partners of count 0, and must never be ranked
F1_PANELS = {
    "sparse70": lambda: _uniform(70, 512, 0.01, seed=0),
    "zeros5": lambda: np.zeros((5, 64), np.uint8),
}


@pytest.mark.parametrize("route", ["block", "tile"])
@pytest.mark.parametrize("panel,k", [("sparse70", 8), ("zeros5", 3)])
def test_topk_never_ranks_padding(monkeypatch, configs, panel, k, route):
    dense = F1_PANELS[panel]()
    if route == "tile":
        configs(TILE)
        monkeypatch.setattr(tdispatch, "choose_strategy", lambda *a, **k_: "pallas_mxu")
    vals, idx = st.topk_neighbors(dense, k, device="cpu")
    assert np.array_equal(vals, stormtpu.topk_neighbors(dense, k)[0])
    _assert_valid_topk(vals, idx, _counts(dense), k)


@pytest.mark.parametrize("measure", ["count", "topk"])
def test_tile_walks_in_blocked_order_equal_jax(tile_route, monkeypatch, measure):
    """Tile blocks of 2 × 2 and chunks of 3 tiles: a chunk holds parts of
    several blocks, and a row block's tiles are not one run."""
    monkeypatch.setattr(tq, "_TILE_GROUP", 2)
    monkeypatch.setattr(tq, "_SCREEN_TILE_CHUNK_BYTES", 3 * 4 * 32 * 32)
    dense = _uniform(200, 600, 0.3, seed=23)
    if measure == "topk":
        vals, idx = st.topk_neighbors(dense, 9, device="cpu")
        assert np.array_equal(vals, stormtpu.topk_neighbors(dense, 9)[0])
        _assert_valid_topk(vals, idx, _counts(dense), 9)
    else:
        _assert_same(st.pairs_above(dense, 60, device="cpu"), stormtpu.pairs_above(dense, 60))


def test_topk_clustered_host_route_equals_jax(configs):
    configs(CLUSTERED)
    dense = _block_diagonal(128, 16384, 3, 0.3, seed=10)
    bm = st.BitMatrix.from_dense(dense)
    assert tdispatch.choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm,
                                     device="cpu") == "clustered"
    vals, idx = st.topk_neighbors(bm, 5, device="cpu")
    assert np.array_equal(vals, stormtpu.topk_neighbors(dense, 5)[0])
    _assert_valid_topk(vals, idx, _counts(dense), 5)


@pytest.mark.parametrize("measure", SIM_OPS)
def test_topk_measure_route_equals_jax(measure):
    dense = _uniform(60, 400, 0.3, seed=11)
    dense[3] = 0
    vals, idx = st.topk_neighbors(dense, 7, measure=measure, device="cpu")
    want, _ = stormtpu.topk_neighbors(dense, 7, measure=measure)
    assert vals.dtype == np.float64 and np.array_equal(vals, want)
    sim = stormtpu.similarity_matrix(dense, measure)
    np.fill_diagonal(sim, -np.inf)
    _assert_valid_topk(vals, idx, sim, 7)


def test_topk_measure_above_the_host_ceiling(monkeypatch):
    dense = _uniform(20, 64, 0.5, seed=12)
    monkeypatch.setattr(tq, "_MEASURE_HOST_N_CEILING", 16)
    monkeypatch.setattr(jq, "_MEASURE_HOST_N_CEILING", 16)
    # above the ceiling both packages take their streamed walk
    vals, idx = st.topk_neighbors(dense, 3, measure="r2", device="cpu")
    want, _ = stormtpu.topk_neighbors(dense, 3, measure="r2")
    assert vals.dtype == np.float64 and np.array_equal(vals, want)
    sim = stormtpu.similarity_matrix(dense, "r2")
    np.fill_diagonal(sim, -np.inf)
    _assert_valid_topk(vals, idx, sim, 3)
    for fn, kw in ((st.topk_neighbors, {"device": "cpu"}), (stormtpu.topk_neighbors, {})):
        with pytest.raises(ValueError, match="on_host_limit='raise'"):
            fn(dense, 3, measure="r2", on_host_limit="raise", **kw)
    # the count route has no host ceiling
    assert st.topk_neighbors(dense, 3, device="cpu")[0].shape == (20, 3)


@pytest.mark.parametrize("measure", ["count", "jaccard"])
def test_topk_one_and_two_rows_equal_jax(measure):
    dense = _uniform(2, 100, 0.5, seed=13)
    for n in (1, 2):
        got = st.topk_neighbors(dense[:n], 1, measure=measure, device="cpu")
        _assert_same(got, stormtpu.topk_neighbors(dense[:n], 1, measure=measure))


def test_topk_validation_matches_jax():
    dense = _uniform(5, 64, 0.5, seed=14)
    for fn, kw in ((st.topk_neighbors, {"device": "cpu"}), (stormtpu.topk_neighbors, {})):
        for k in (0, 5):
            with pytest.raises(ValueError, match="k must be"):
                fn(dense, k, **kw)
        with pytest.raises(ValueError, match="on_host_limit"):
            fn(dense, 2, on_host_limit="spill", **kw)


# ------------------------------------------------------------ screens
THRESHOLDS = {"count": 60, "jaccard": 0.2, "dice": 0.34, "cosine": 0.34, "overlap": 0.36,
              "phi": 0.05, "r2": 0.004}


@pytest.mark.parametrize("measure", ["count", *SIM_OPS])
def test_pairs_above_block_screen_equals_jax(measure):
    dense = _uniform(130, 700, 0.3, seed=15)
    got = st.pairs_above(dense, THRESHOLDS[measure], measure=measure, device="cpu")
    want = stormtpu.pairs_above(dense, THRESHOLDS[measure], measure=measure)
    assert 0 < want[0].size < 130 * 129 // 2
    _assert_same(got, want)


@pytest.mark.parametrize("chunk_tiles", [1, 6, 10_000])
@pytest.mark.parametrize("measure", ["count", "jaccard", "phi", "r2"])
def test_pairs_above_tile_screen_equals_jax(tile_route, monkeypatch, measure, chunk_tiles):
    monkeypatch.setattr(tq, "_SCREEN_TILE_CHUNK_BYTES", chunk_tiles * 4 * 32 * 32)
    dense = _uniform(130, 700, 0.3, seed=16)
    got = st.pairs_above(dense, THRESHOLDS[measure], measure=measure, device="cpu")
    want = stormtpu.pairs_above(dense, THRESHOLDS[measure], measure=measure)
    assert want[0].size > 0
    _assert_same(got, want)


def test_pairs_above_block_rows_crosses_blocks():
    dense = _uniform(100, 500, 0.3, seed=17)
    _assert_same(st.pairs_above(dense, 45, block_rows=32, device="cpu"),
                 stormtpu.pairs_above(dense, 45, block_rows=32))


@pytest.mark.parametrize("measure,threshold", [("count", 1), ("r2", 0.05), ("jaccard", 0.02)])
def test_pairs_above_sparse_host_filter_equals_jax(measure, threshold):
    dense = _uniform(150, 8192, 0.0008, seed=18)
    bm = st.BitMatrix.from_dense(dense)
    assert tdispatch.choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm,
                                     device="cpu") == "sparse"
    got = st.pairs_above(bm, threshold, measure=measure, device="cpu")
    want = stormtpu.pairs_above(dense, threshold, measure=measure)
    assert want[0].size > 0
    _assert_same(got, want)


@pytest.mark.parametrize("measure,threshold", [("count", 505), ("r2", 0.0015)])
def test_pairs_above_clustered_host_filter_equals_jax(configs, measure, threshold):
    configs(CLUSTERED)
    dense = _block_diagonal(128, 16384, 3, 0.3, seed=19)
    got = st.pairs_above(dense, threshold, measure=measure, device="cpu")
    want = stormtpu.pairs_above(dense, threshold, measure=measure)
    assert want[0].size > 0
    _assert_same(got, want)


def test_pairs_above_dense_screen_downloads_the_bitmap(monkeypatch):
    """Nearly every pair hits: the summary finds more nonzero words than the
    word-by-word gather is worth, and the bitmap itself comes down."""
    dense = _uniform(100, 400, 0.5, seed=20)
    seen = []
    real = tq._expand_words
    monkeypatch.setattr(tq, "_expand_words", lambda rows, width: seen.append(width) or
                        real(rows, width))
    got = st.pairs_above(dense, 1, device="cpu")
    _assert_same(got, stormtpu.pairs_above(dense, 1))
    assert got[0].size == 100 * 99 // 2
    assert seen[-1] == 100  # the second expansion was of the bitmap's bits


def test_pairs_above_empty_and_tiny_equal_jax():
    dense = _uniform(60, 300, 0.3, seed=21)
    for measure, th in (("count", 300), ("jaccard", 1.0)):
        got = st.pairs_above(dense, th, measure=measure, device="cpu")
        assert got[0].size == 0
        _assert_same(got, stormtpu.pairs_above(dense, th, measure=measure))
    for n in (1, 2):
        _assert_same(st.pairs_above(dense[:n], 1, device="cpu"),
                     stormtpu.pairs_above(dense[:n], 1))


def test_pairs_above_validation_matches_jax():
    dense = _uniform(6, 64, 0.5, seed=22)
    for fn, kw in ((st.pairs_above, {"device": "cpu"}), (stormtpu.pairs_above, {})):
        with pytest.raises(ValueError, match="count threshold"):
            fn(dense, 0, **kw)
        with pytest.raises(ValueError, match=r"\(0, 1\]"):
            fn(dense, 1.5, measure="r2", **kw)
        with pytest.raises(ValueError, match="unknown measure"):
            fn(dense, 0.5, measure="tanimoto", **kw)


def test_pack_bit_rows_sets_bit_31_as_uint32():
    import torch

    mask = torch.zeros((2, 64), dtype=torch.bool)
    mask[0, 31] = mask[0, 0] = mask[1, 63] = True
    words = tq._pack_bit_rows(mask).numpy().view(np.uint32)
    assert words.tolist() == [[0x80000001, 0], [0, 0x80000000]]
    assert np.array_equal(st.unpack_bits(words, 64).astype(bool), mask.numpy())
