"""The streamed queries' sparse route in the port: K4 on the host
(``stream._SparseStripePlan``) for the stripes where the cost model says
so, the device stripe for the rest, against the JAX package's on the CPU,
with both packages' K4 cost constants pinned to the same values so that
their stripe choices compare: the top-k by count and by measure (phi and
r² through the zero-intersection staircase), the screens (r²'s
anti-correlated pairs K4 never emits), ``auto`` taking the route, resume,
the buffer-free emission path, the host helpers one by one, and the cost
model's ``extra_emissions`` / ``emission_path`` arguments.

Counts and float64 values are compared exactly (tolerance 0); top-k
indices are validated, never compared."""

import json

import jax
import numpy as np
import pytest

import stormtpu.stream as js
import stormtpu.stream_query as jsq
import stormtpu_torch as st
import stormtpu_torch.stream as ts
import stormtpu_torch.stream_query as tsq
from conftest import random_bitmatrix
from stormtpu import tuning as jtuning
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu.oracle import oracle_count_matrix
from stormtpu.setops import derive_similarity
from stormtpu_torch import tuning as ttuning

FIELDS = dict(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)
FORCE_K4 = dict(c_sort_s_per_nnz=0.0, c_n2_s_per_elem=0.0, c_emit_s_per_emission=0.0,
                k2_int8_ops_per_s=1.0, dispatch_floor_s=100.0, h2d_bytes_per_s=1e9)
FORCE_DENSE = dict(c_sort_s_per_nnz=1.0, c_n2_s_per_elem=1.0, c_emit_s_per_emission=1.0,
                   k2_int8_ops_per_s=1e30, dispatch_floor_s=0.0, h2d_bytes_per_s=1e30)
# the dense stripe costs 32²·M/1e12 + 1e-4 s: K4 wins a stripe of few emissions
MIXED = dict(c_sort_s_per_nnz=0.0, c_n2_s_per_elem=0.0, c_emit_s_per_emission=1e-6,
             k2_int8_ops_per_s=1e12, dispatch_floor_s=1e-4, h2d_bytes_per_s=4e9)


@pytest.fixture
def pin(tmp_path, monkeypatch):
    """Pin both packages' K4 cost constants to the same values."""
    cache = tmp_path / "tuning.json"
    monkeypatch.setenv(jtuning.CACHE_ENV, str(cache))

    def write(consts):
        cache.write_text(json.dumps({"device": str(jax.devices()[0]),
                                     "k4_cost_model": consts}))
        for k, v in consts.items():
            monkeypatch.setitem(ttuning.K4_DEFAULTS, k, v)

    return write


def _pair(bj):
    return bj, st.BitMatrix.from_packed(bj.packed, bj.m_bits)


def _jax(fn, bm, *args, **kw):
    return getattr(jsq, fn)(bm, *args, config=JaxConfig(**FIELDS), interpret=True, **kw)


def _port(fn, bm, *args, **kw):
    return getattr(tsq, fn)(bm, *args, config=st.EngineConfig(**FIELDS), device="cpu", **kw)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def _scores(bm, measure):
    c = oracle_count_matrix(bm.packed).astype(np.int64)
    if measure == "count":
        np.fill_diagonal(c, -1)
        return c
    s = derive_similarity(c, bm.row_nnz[:, None], bm.row_nnz[None, :], bm.m_bits, measure)
    np.fill_diagonal(s, -np.inf)
    return s


def _check_topk(bm, got, want, k, measure="count"):
    vals, idx = got
    assert vals.dtype == want[0].dtype and np.array_equal(vals, want[0])
    s = _scores(bm, measure)
    top = -np.sort(-s, axis=1)[:, :k]
    top = np.maximum(top, 0) if measure == "count" else np.where(np.isfinite(top), top, 0.0)
    assert np.array_equal(vals, top)
    assert np.all((idx >= 0) & (idx < bm.n))
    for r in range(bm.n):
        real = vals[r] > 0 if measure == "count" else (vals[r] != 0) | (idx[r] != 0)
        assert np.array_equal(s[r, idx[r][real]], vals[r][real])
        assert len(set(idx[r][real].tolist())) == int(real.sum())


def _k4_stripes(monkeypatch):
    """Record which stripes the port's walk takes through K4."""
    seen = []
    real = tsq._k4_stripe

    def spy(plan, i, j, sb):
        seen.append((i, j))
        return real(plan, i, j, sb)

    monkeypatch.setattr(tsq, "_k4_stripe", spy)
    return seen


@pytest.mark.parametrize("force", ("k4", "dense"))
def test_stream_topk_sparse_outer_equals_jax(pin, monkeypatch, force):
    pin(FORCE_K4 if force == "k4" else FORCE_DENSE)
    bj, bt = _pair(random_bitmatrix(80, 2048, 0.003, seed=81))  # 80 → 96 rows: ragged
    seen = _k4_stripes(monkeypatch)
    got = _port("stream_topk_neighbors", bt, 5, superblock_rows=32, kernel="sparse_outer")
    assert len(seen) == (6 if force == "k4" else 0)
    _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 5, superblock_rows=32,
                              kernel="sparse_outer"), 5)


def test_stream_topk_sparse_mixed_stripes(pin, monkeypatch):
    """One dense superblock in an ultra-sparse panel: its stripes take the
    device, the rest K4; the values are seamless across the boundary."""
    pin(MIXED)
    rng = np.random.default_rng(82)
    dense = (rng.random((96, 1024)) < 0.002).astype(np.uint8)
    dense[:32] = rng.random((32, 1024)) < 0.4
    bj, bt = _pair(JaxBitMatrix.from_dense(dense))
    seen = _k4_stripes(monkeypatch)
    got = _port("stream_topk_neighbors", bt, 4, superblock_rows=32, kernel="sparse_outer")
    assert 0 < len(seen) < 6
    _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 4, superblock_rows=32,
                              kernel="sparse_outer"), 4)


@pytest.mark.parametrize("measure,threshold", [
    ("count", 4), ("jaccard", 0.05), ("dice", 0.1), ("cosine", 0.1), ("overlap", 0.12),
    ("phi", 0.08), ("r2", 0.007),
])
def test_stream_screen_sparse_outer_equals_jax(pin, measure, threshold):
    pin(FORCE_K4)
    bj, bt = _pair(random_bitmatrix(72, 2048, 0.02, seed=83))
    got = _port("stream_pairs_above", bt, threshold, measure=measure, superblock_rows=32,
                kernel="sparse_outer")
    _assert_same(got, _jax("stream_pairs_above", bj, threshold, measure=measure,
                           superblock_rows=32, kernel="sparse_outer"))
    _assert_same(got, st.pairs_above(bt, threshold, measure=measure, device="cpu"))
    assert got[0].size and np.all(got[0] < got[1])


def test_stream_screen_sparse_r2_zero_intersection_pairs(pin):
    """r² scores anti-correlated pairs that K4 never emits; the staircase
    must surface them exactly."""
    pin(FORCE_K4)
    rng = np.random.default_rng(84)
    dense = np.zeros((40, 512), dtype=np.uint8)
    dense[0, :256] = 1
    dense[1, 256:] = 1
    for r in range(2, 40):
        dense[r, rng.integers(0, 64, 2)] = 1
    bj, bt = _pair(JaxBitMatrix.from_dense(dense))
    got = _port("stream_pairs_above", bt, 0.5, measure="r2", superblock_rows=32,
                kernel="sparse_outer")
    hit = (got[0] == 0) & (got[1] == 1)
    assert hit.any() and got[2][hit][0] == 1.0
    _assert_same(got, _jax("stream_pairs_above", bj, 0.5, measure="r2", superblock_rows=32,
                           kernel="sparse_outer"))


def test_stream_screen_sparse_auto_routes_and_resumes(pin, tmp_path, monkeypatch):
    """``auto`` takes the sparse route below the density threshold (the
    manifest names it, as the JAX package's does) and resumes without
    computing a stripe again."""
    pin(FORCE_K4)
    bj, bt = _pair(random_bitmatrix(72, 4096, 0.0005, seed=85))
    out, jout = tmp_path / "t", tmp_path / "j"
    got = _port("stream_pairs_above", bt, 1, superblock_rows=32, out_dir=str(out))
    want = _jax("stream_pairs_above", bj, 1, superblock_rows=32, out_dir=str(jout))
    _assert_same(got, want)
    man = json.loads((out / "screen_manifest.json").read_text())
    assert man == json.loads((jout / "screen_manifest.json").read_text())
    assert man["kernel"] == "sparse_outer+xla_int8"
    seen = _k4_stripes(monkeypatch)
    _assert_same(_port("stream_pairs_above", bt, 1, superblock_rows=32, out_dir=str(out)),
                 want)
    assert seen == []
    # the JAX package finishes the port's directory, and the other way
    for d in (out, jout):
        (d / "hits_00000_00002.npz").unlink()
    _assert_same(_jax("stream_pairs_above", bj, 1, superblock_rows=32, out_dir=str(out)), want)
    _assert_same(_port("stream_pairs_above", bt, 1, superblock_rows=32, out_dir=str(jout)),
                 want)


def test_stream_topk_sparse_checkpoint_resume(pin, tmp_path):
    pin(FORCE_K4)
    bj, bt = _pair(random_bitmatrix(80, 2048, 0.003, seed=86))
    kw = dict(superblock_rows=32, kernel="sparse_outer", out_dir=str(tmp_path))
    a = _port("stream_topk_neighbors", bt, 4, **kw)
    b = _port("stream_topk_neighbors", bt, 4, **kw)
    _assert_same(a, b)
    with np.load(tmp_path / "topk_ckpt.npz") as z:
        assert json.loads(str(z["params"]))["kernel"] == "sparse_outer+xla_int8"
    c = _jax("stream_topk_neighbors", bj, 4, **kw)  # the JAX package reads the checkpoint
    _check_topk(bj, a, c, 4)


@pytest.mark.parametrize("measure", ("jaccard", "dice", "cosine", "overlap"))
def test_stream_topk_measure_sparse_route(pin, measure):
    """K4 stripes rank exact scores; zero-intersection pairs score 0 for
    these measures (the no-partner convention)."""
    pin(FORCE_K4)
    bj, bt = _pair(random_bitmatrix(72, 2048, 0.004, seed=96))
    got = _port("stream_topk_neighbors", bt, 4, superblock_rows=32, kernel="sparse_outer",
                measure=measure)
    want = _jax("stream_topk_neighbors", bj, 4, superblock_rows=32, kernel="sparse_outer",
                measure=measure)
    assert np.array_equal(got[0], want[0])
    s = _scores(bj, measure)
    assert np.array_equal(got[0], np.maximum(-np.sort(-s, axis=1)[:, :4], 0.0))


@pytest.mark.parametrize("measure", ("phi", "r2"))
def test_stream_topk_measure_phi_r2_sparse_route(pin, measure):
    """The zero-intersection staircase recovers the partners K4 never
    emits: complementary halves (r² 1, phi −1), an empty row, a full row,
    and for phi mostly negative scores (a padded partner's 0 would win)."""
    pin(FORCE_K4)
    rng = np.random.default_rng(97)
    dense = (rng.random((75, 512)) < 0.01).astype(np.uint8)
    dense[0] = 0
    dense[0, :256] = 1
    dense[1] = 0
    dense[1, 256:] = 1
    dense[2] = 0
    dense[3] = 1
    bj, bt = _pair(JaxBitMatrix.from_dense(dense))  # 75 rows: ragged
    got = _port("stream_topk_neighbors", bt, 3, superblock_rows=32, kernel="sparse_outer",
                measure=measure)
    _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 3, superblock_rows=32,
                              kernel="sparse_outer", measure=measure), 3, measure)
    assert np.array_equal(got[0], st.topk_neighbors(bt, 3, measure=measure, device="cpu")[0])


def test_emission_path_coostripe_with_r2_staircase(monkeypatch):
    """phi / r² on emission-eligible stripes: the staircase filters through
    the ``_CooStripe`` membership, no dense sb² buffer is built, and the
    results equal the JAX package's and the oracle's."""
    rng = np.random.default_rng(53)
    n, m = 300, 16384
    dense = np.zeros((n, m), dtype=np.uint8)
    dense[rng.integers(0, n, 450), rng.integers(0, m, 450)] = 1
    bj, bt = _pair(JaxBitMatrix.from_dense(dense))
    coo_calls, dense_calls = [], []
    real_coo, real_dense = ts._SparseStripePlan.stripe_coo, ts._SparseStripePlan.stripe_counts
    monkeypatch.setattr(ts._SparseStripePlan, "stripe_coo",
                        lambda self, i, j: coo_calls.append((i, j)) or real_coo(self, i, j))
    monkeypatch.setattr(ts._SparseStripePlan, "stripe_counts",
                        lambda self, i, j: dense_calls.append((i, j)) or real_dense(self, i, j))
    for measure in ("r2", "phi"):
        got = tsq.stream_topk_neighbors(bt, 3, measure=measure, superblock_rows=32,
                                        kernel="sparse_outer", device="cpu")
        want = jsq.stream_topk_neighbors(bj, 3, measure=measure, superblock_rows=32,
                                         kernel="sparse_outer")
        _check_topk(bj, got, want, 3, measure)
    got = tsq.stream_pairs_above(bt, 1e-9, measure="r2", superblock_rows=32,
                                 kernel="sparse_outer", device="cpu")
    _assert_same(got, jsq.stream_pairs_above(bj, 1e-9, measure="r2", superblock_rows=32,
                                             kernel="sparse_outer"))
    sim = _scores(bj, "r2")
    wi, wj = np.nonzero(np.triu(sim, 1) >= 1e-9)
    assert np.array_equal(got[0], wi) and np.array_equal(got[2], sim[wi, wj])
    assert wi.size > 100
    assert coo_calls and not dense_calls


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("kind", ("mixed", "all_k4"))
def test_use_k4_arguments_equal_jax(pin, kind):
    """``use_k4(i, j, extra_emissions, emission_path)`` decides as the JAX
    package's on every stripe, for each form of its arguments."""
    pin(MIXED)
    if kind == "mixed":
        rng = np.random.default_rng(82)
        dense = (rng.random((96, 1024)) < 0.002).astype(np.uint8)
        dense[:32] = rng.random((32, 1024)) < 0.4
        bj = JaxBitMatrix.from_dense(dense)
    else:
        bj = random_bitmatrix(96, 8192, 0.0006, seed=87)
    _, bt = _pair(bj)
    got, want = ts._SparseStripePlan(bt, 32, 3, device="cpu"), js._SparseStripePlan(bj, 32, 3)
    decisions = set()
    for i in range(3):
        for j in range(i, 3):
            for extra in (0, 50, 5000):
                for path in (False, True):
                    g = got.use_k4(i, j, extra_emissions=extra, emission_path=path)
                    assert g == want.use_k4(i, j, extra_emissions=extra, emission_path=path)
                    decisions.add(g)
            assert got.use_k4(i, j) == want.use_k4(i, j)  # the defaults
    assert decisions == {True, False}


def test_zero_staircases_and_rank_helpers_equal_jax():
    rng = np.random.default_rng(88)
    sb, m = 48, 512
    nnz_a = rng.integers(0, m + 1, sb)
    nnz_b = rng.integers(0, m + 1, sb)
    nnz_a[:3] = (0, m, 1)
    stripe = (rng.random((sb, sb)) < 0.1) * rng.integers(1, 9, (sb, sb))
    stripe = stripe.astype(np.int32)
    li, lj = np.nonzero(stripe)
    coo_t = tsq._CooStripe(li.astype(np.int32), lj.astype(np.int32), stripe[li, lj], sb)
    coo_j = jsq._CooStripe(li.astype(np.int32), lj.astype(np.int32), stripe[li, lj], sb)
    for thr in (1e-4, 0.05):
        tt, tm = tsq._r2_zero_plan(nnz_a, nnz_b, m, thr)
        jt, jm = jsq._r2_zero_plan(nnz_a, nnz_b, m, thr)
        assert tt == jt
        for st_, sj_ in ((None, None), (stripe, stripe), (coo_t, coo_j)):
            for diag in (False, True):
                _assert_same(tm(st_, diag), jm(sj_, diag))
    for measure in ("phi", "r2"):
        for st_, sj_ in ((None, None), (stripe, stripe), (coo_t, coo_j), (coo_t.T, coo_j.T)):
            for diag in (False, True):
                kw = dict(diagonal=diag, valid_a=sb - 5, valid_b=sb - 7, sb_rows=sb)
                _assert_same(tsq._k4_zero_topk(st_, nnz_a, nnz_b, m, measure, 4, **kw),
                             jsq._k4_zero_topk(sj_, nnz_a, nnz_b, m, measure, 4, **kw))
    for st_, sj_ in ((stripe, stripe), (coo_t, coo_j)):
        for diag in (False, True):
            got = tsq._stripe_topk_candidates_k4(st_, 5, diagonal=diag)
            want = jsq._stripe_topk_candidates_k4(sj_, 5, diagonal=diag)
            _assert_same([g for g in got if g is not None], [w for w in want if w is not None])
    rows, cols = rng.integers(0, sb, 200), rng.integers(0, sb, 200)
    assert np.array_equal(coo_t.is_zero(rows, cols), coo_j.is_zero(rows, cols))
    assert np.array_equal(coo_t.row_nonzero_counts(40, 30), coo_j.row_nonzero_counts(40, 30))
