"""Property-based invariants of the port (hypothesis), the counterpart of
``tests/test_properties.py``: ``stormtpu_torch`` on the CPU
(``device="cpu"``) held to the NumPy oracle, and to ``stormtpu`` where a
value is compared, on shapes that no unit test chose.

The matrices draw each row's density from {0, 0.5%, 5%, 50%} (empty and
sparse rows beside dense ones) and N across the 32-row tiles and blocks
used here, so that padded rows tie with real partners of count 0. Every
top-k, on every route (the block form, the K2 tile walk, the one-rank
ring, the streamed walk, the cross form), is checked for its values and
for its partners: distinct, never the row itself, each realizing its
value (the streamed walk may also give a zero value the (0, 0) "no
partner" entry its docstring names). Counts are exact integers; float64 similarities are compared
exactly, and the pairwise-complete r² to 1e-9 against a per-pair formula
that sums in another order."""

import functools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import stormtpu
import stormtpu_torch as tst
import stormtpu_torch.config as tconf
import stormtpu_torch.dispatch as tdispatch
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.layout import BitMatrix, pack_bits, unpack_bits
from stormtpu_torch.oracle import oracle_count_matrix

CPU = "cpu"
_TILE_CFG = EngineConfig(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=128)
_TI = _TILE_CFG.k2_tile_rows           # 32
_KSTEP = _TILE_CFG.k2_tile_words * 32  # 4096 bits
_DENSITIES = (0.0, 0.005, 0.05, 0.5)


@st.composite
def bit_matrices(draw, max_m=200):
    """N × M 0/1 rows, each at its own density: N of 1-12 or across the
    32-row tile and block boundaries."""
    n = draw(st.one_of(st.integers(1, 12), st.sampled_from([_TI - 1, _TI + 1, 2 * _TI + 5])))
    m = draw(st.integers(1, max_m))
    dens = draw(st.lists(st.sampled_from(_DENSITIES), min_size=n, max_size=n))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    return (rng.random((n, m)) < np.asarray(dens)[:, None]).astype(np.uint8)


@st.composite
def boundary_matrices(draw):
    """N at the 32-row tile boundaries and M at the word and K-step
    boundaries of ``_TILE_CFG``, with set bits in the last row and column
    and at the first K-step's last word."""
    n = draw(st.one_of(st.integers(1, 12), st.sampled_from(
        [_TI - 1, _TI, _TI + 1, 2 * _TI - 1, 2 * _TI, 2 * _TI + 1])))
    m = draw(st.one_of(st.sampled_from([31, 32, 33, 63, 65]),
                       st.sampled_from([_KSTEP - 32, _KSTEP, _KSTEP + 32, 2 * _KSTEP + 32])))
    dens = draw(st.lists(st.sampled_from(_DENSITIES), min_size=n, max_size=n))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    dense = (rng.random((n, m)) < np.asarray(dens)[:, None]).astype(np.uint8)
    dense[-1, -1] = 1
    dense[0, min(m, _KSTEP) - 1] = 1
    return dense


def _counts(dense):
    d = dense.astype(np.int64)
    return d @ d.T


def _assert_valid_topk(vals, idx, score, k, no_partner=False):
    """Each row's indices are distinct, never the row, and score[i, idx]
    equals the value; values sorted descending. ``no_partner``: a value-0
    entry may also be (0, 0), the streamed walk's documented "no partner"
    entry (a stripe that is skipped, or ranked from its nonzeros, offers no
    zero-count partner)."""
    n = score.shape[0]
    assert vals.shape == idx.shape == (n, k) and idx.dtype == np.int32
    assert np.all(np.diff(vals, axis=1) <= 0)
    real = ~((vals == 0) & (idx == 0)) if no_partner else np.ones((n, k), bool)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, k))
    assert np.array_equal(score[rows[real], idx[real]], vals[real])
    for r in range(n):
        got = idx[r][real[r]].tolist()
        assert len(set(got)) == len(got) and r not in got, (r, idx[r])


def _top_values(score, k):
    s = score.copy()
    np.fill_diagonal(s, -np.inf if s.dtype.kind == "f" else -1)
    return -np.sort(-s, axis=1)[:, :k]


@functools.lru_cache(maxsize=None)
def _one_rank_mesh():
    from stormtpu_torch.parallel import make_row_mesh

    return make_row_mesh(1, device=CPU)


def _topk_route(bm, k, route, block_rows, measure="count"):
    """``topk_neighbors`` by ``route``: "block" (D1's dense choice, the
    block form on the CPU), "tile" (the K2 tile walk at 32-row tiles),
    "ring" (``parallel.distributed_topk_neighbors`` on one rank) or
    "stream" (``stream_query.stream_topk_neighbors``, superblock 32)."""
    from stormtpu_torch.parallel import distributed_topk_neighbors
    from stormtpu_torch.stream_query import stream_topk_neighbors

    if route == "ring":
        return distributed_topk_neighbors(bm, k, mesh=_one_rank_mesh(), block_rows=block_rows,
                                          measure=measure)
    if route == "stream":
        return stream_topk_neighbors(bm, k, superblock_rows=32, config=_TILE_CFG,
                                     measure=measure, device=CPU)
    with pytest.MonkeyPatch.context() as mp:
        if route == "tile":
            mp.setattr(tconf, "_DEFAULT", _TILE_CFG)
            mp.setattr(tdispatch, "choose_strategy", lambda *a, **k_: "pallas_mxu")
        return tst.topk_neighbors(bm, k, measure=measure, block_rows=block_rows, device=CPU)


@given(bit_matrices())
@settings(max_examples=30, deadline=None)
def test_pack_roundtrip_property(dense):
    packed = pack_bits(dense)
    assert np.array_equal(packed, stormtpu.pack_bits(dense))
    np.testing.assert_array_equal(unpack_bits(packed, dense.shape[1]), dense)


@given(bit_matrices())
@settings(max_examples=15, deadline=None)
def test_count_matrix_properties(dense):
    bm = BitMatrix.from_dense(dense)
    c = tst.intersect_count_matrix(bm, strategy="popcount", device=CPU)
    np.testing.assert_array_equal(c, c.T)
    np.testing.assert_array_equal(np.diag(c), bm.row_nnz)
    assert (c >= 0).all()
    assert (c <= np.minimum(bm.row_nnz[:, None], bm.row_nnz[None, :])).all()
    np.testing.assert_array_equal(c, oracle_count_matrix(bm.packed))


@given(bit_matrices(), st.integers(min_value=0, max_value=100))
@settings(max_examples=15, deadline=None)
def test_count_invariant_under_column_permutation(dense, seed):
    perm = np.random.default_rng(seed).permutation(dense.shape[1])
    a = tst.intersect_count_matrix(dense, strategy="mxu", device=CPU)
    b = tst.intersect_count_matrix(dense[:, perm], strategy="mxu", device=CPU)
    np.testing.assert_array_equal(a, b)


@pytest.mark.heavy
@given(bit_matrices())
@settings(max_examples=8, deadline=None)
def test_all_strategies_agree(dense):
    """D1's semantics-free contract: every strategy returns the identical
    exact matrix."""
    bm = BitMatrix.from_dense(dense)
    want = oracle_count_matrix(bm.packed)
    for strategy in tdispatch.STRATEGIES:
        got = tst.intersect_count_matrix(bm, strategy=strategy, device=CPU)
        np.testing.assert_array_equal(got, want, err_msg=f"strategy {strategy} diverged")


@pytest.mark.heavy
@given(boundary_matrices())
@settings(max_examples=6, deadline=None)
def test_all_strategies_agree_across_tile_boundaries(dense):
    bm = BitMatrix.from_dense(dense)
    want = oracle_count_matrix(bm.packed)
    for strategy in tdispatch.STRATEGIES:
        got = tst.intersect_count_matrix(bm, strategy=strategy, config=_TILE_CFG, device=CPU)
        np.testing.assert_array_equal(got, want, err_msg=f"strategy {strategy} diverged at "
                                      f"boundary shape {dense.shape}")


@given(bit_matrices(), st.integers(min_value=1, max_value=8),
       st.sampled_from(["block", "tile", "ring", "stream"]), st.sampled_from([None, 8, 32]))
@settings(max_examples=24, deadline=None)
def test_topk_property(dense, k, route, block_rows):
    """Top-k values equal each row's sorted counts (self excluded) and the
    reference's, and every partner set is valid, on every route."""
    n = dense.shape[0]
    if n < 2:
        return
    k = min(k, n - 1)
    c = _counts(dense)
    vals, idx = _topk_route(BitMatrix.from_dense(dense), k, route, block_rows)
    np.testing.assert_array_equal(vals, _top_values(c, k))
    _assert_valid_topk(vals, idx, c, k, no_partner=route == "stream")
    if route == "block":
        np.testing.assert_array_equal(vals, stormtpu.topk_neighbors(dense, k)[0])


@given(boundary_matrices(), st.integers(min_value=1, max_value=5),
       st.sampled_from(["block", "tile", "ring"]))
@settings(max_examples=6, deadline=None)
def test_topk_property_across_tile_boundaries(dense, k, route):
    n = dense.shape[0]
    if n < 2:
        return
    k = min(k, n - 1)
    c = _counts(dense)
    vals, idx = _topk_route(BitMatrix.from_dense(dense), k, route, 32)
    np.testing.assert_array_equal(vals, _top_values(c, k))
    _assert_valid_topk(vals, idx, c, k)


@given(bit_matrices(), st.integers(min_value=1, max_value=40), st.sampled_from([None, 8]))
@settings(max_examples=12, deadline=None)
def test_pairs_above_property(dense, threshold, block_rows):
    """The count screen returns exactly the upper-triangle pairs with
    count ≥ threshold, as the reference does."""
    if dense.shape[0] < 2:
        return
    c = _counts(dense)
    ii, jj, vv = tst.pairs_above(dense, threshold, block_rows=block_rows, device=CPU)
    wi, wj = np.nonzero(np.triu(c, 1) >= threshold)
    np.testing.assert_array_equal(ii, wi.astype(np.int32))
    np.testing.assert_array_equal(jj, wj.astype(np.int32))
    np.testing.assert_array_equal(vv, c[wi, wj])
    for g, w in zip((ii, jj, vv), stormtpu.pairs_above(dense, threshold, block_rows=block_rows)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.heavy
@given(boundary_matrices(), st.integers(min_value=1, max_value=5),
       st.integers(min_value=1, max_value=60))
@settings(max_examples=4, deadline=None)
def test_stream_queries_property(dense, k, threshold):
    """The streamed top-k and screen equal the oracle on stripe walks that
    cross superblock and tile boundaries, with valid partner sets."""
    from stormtpu_torch.stream_query import stream_pairs_above

    n = dense.shape[0]
    if n < 2:
        return
    k = min(k, n - 1)
    bm = BitMatrix.from_dense(dense)
    c = _counts(dense)
    vals, idx = _topk_route(bm, k, "stream", None)
    np.testing.assert_array_equal(vals, _top_values(c, k))
    _assert_valid_topk(vals, idx, c, k, no_partner=True)
    ii, jj, vv = stream_pairs_above(bm, threshold, superblock_rows=32, config=_TILE_CFG,
                                    device=CPU)
    wi, wj = np.nonzero(np.triu(c, 1) >= threshold)
    np.testing.assert_array_equal(ii, wi.astype(np.int32))
    np.testing.assert_array_equal(jj, wj.astype(np.int32))
    np.testing.assert_array_equal(vv, c[wi, wj])


@pytest.mark.heavy
@given(bit_matrices(), bit_matrices(), st.integers(1, 5))
@settings(max_examples=12, deadline=None)
def test_cross_queries_property(da, db, k):
    """Cross top-k values, partners and count screens equal the dense
    oracle on independently shaped operands sharing a universe."""
    m = max(da.shape[1], db.shape[1])
    a = np.zeros((da.shape[0], m), np.uint8)
    a[:, : da.shape[1]] = da
    b = np.zeros((db.shape[0], m), np.uint8)
    b[:, : db.shape[1]] = db
    c = a.astype(np.int64) @ b.T
    kk = min(k, b.shape[0])
    vals, idx = tst.cross_topk_neighbors(BitMatrix.from_dense(a), BitMatrix.from_dense(b), kk,
                                         device=CPU)
    np.testing.assert_array_equal(vals, -np.sort(-c, axis=1)[:, :kk])
    np.testing.assert_array_equal(c[np.arange(a.shape[0])[:, None], idx], vals)
    assert all(len(set(r.tolist())) == kk for r in idx)
    thr = max(int(c.max()) // 2, 1)
    ii, jj, vv = tst.cross_pairs_above(BitMatrix.from_dense(a), BitMatrix.from_dense(b), thr,
                                       device=CPU)
    wi, wj = np.nonzero(c >= thr)
    np.testing.assert_array_equal(ii, wi)
    np.testing.assert_array_equal(jj, wj)
    np.testing.assert_array_equal(vv, c[wi, wj])


@pytest.mark.heavy
@given(bit_matrices(), st.integers(0, 2**60 - 1))
@settings(max_examples=12, deadline=None)
def test_complete_similarity_property(dense, mask_seed):
    """Pairwise-complete r² equals the per-pair formula over co-observed
    columns; the screen agrees with thresholding the matrix form."""
    n, m = dense.shape
    rng = np.random.default_rng(mask_seed % (2**32))
    observed = (rng.random((n, m)) > 0.25).astype(np.uint8)
    data = dense & observed
    bm_d, bm_m = BitMatrix.from_dense(data), BitMatrix.from_dense(observed)
    got = tst.similarity_matrix_complete(bm_d, bm_m, "r2", device=CPU)
    for i in range(n):
        for j in range(n):
            co = observed[i].astype(bool) & observed[j].astype(bool)
            a, b = data[i, co].astype(np.float64), data[j, co].astype(np.float64)
            mm, ca, cb, it = co.sum(), a.sum(), b.sum(), (a * b).sum()
            den = ca * cb * (mm - ca) * (mm - cb)
            want = ((mm * it - ca * cb) ** 2 / den) if den > 0 else 0.0
            assert abs(got[i, j] - want) < 1e-9, (i, j)
    if n >= 2:
        ii, jj, _ = tst.pairs_above_complete(bm_d, bm_m, 0.5, measure="r2", device=CPU)
        wi, wj = np.nonzero(np.triu(got, 1) >= 0.5)
        np.testing.assert_array_equal(ii, wi)
        np.testing.assert_array_equal(jj, wj)


@given(bit_matrices(), st.integers(min_value=1, max_value=4),
       st.sampled_from(["jaccard", "cosine", "r2", "phi"]),
       st.sampled_from(["block", "ring", "stream"]))
@settings(max_examples=12, deadline=None)
def test_measure_topk_property(dense, k, measure, route):
    """Similarity top-k: the exact float64 top-k of the derived similarity
    matrix, each value the score at its index, on the host ranking, the
    certified ring and the streamed walk."""
    from stormtpu_torch.setops import derive_similarity

    n = dense.shape[0]
    if n < 2:
        return
    k = min(k, n - 1)
    bm = BitMatrix.from_dense(dense)
    sim = derive_similarity(oracle_count_matrix(bm.packed), bm.row_nnz[:, None],
                            bm.row_nnz[None, :], bm.m_bits, measure)
    np.fill_diagonal(sim, -np.inf)
    vals, idx = _topk_route(bm, k, route, 8, measure=measure)
    np.testing.assert_array_equal(vals, -np.sort(-sim, axis=1)[:, :k])
    _assert_valid_topk(vals, idx, sim, k, no_partner=route == "stream")
