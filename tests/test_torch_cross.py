"""The port's cross-set queries (``stormtpu_torch.cross``) against the JAX
package's on the CPU, on shared seeded numpy inputs: the count top-k, the
certified similarity top-k for every measure, and the rectangle screen for
every measure, each with B in one resident chunk and walked in chunks (a
lowered device budget, read by both packages). Counts and float64 values
are compared exactly; count top-k indices are validated (the order among
equal counts depends on the route); the similarity top-k and the screens
are deterministic and compared whole."""

import numpy as np
import pytest

import stormtpu
import stormtpu.cross as jx
import stormtpu_torch as st
import stormtpu_torch.cross as tx

SIM_OPS = ("jaccard", "dice", "cosine", "overlap", "phi", "r2")
THRESHOLDS = {"count": 60, "jaccard": 0.2, "dice": 0.34, "cosine": 0.34, "overlap": 0.36,
              "phi": 0.05, "r2": 0.004}


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


@pytest.fixture(params=["resident", "chunked"])
def walk(request, monkeypatch):
    """B in one resident chunk, or in 32-row chunks (a device budget of A
    plus 40 B rows, which both packages read)."""
    if request.param == "chunked":
        a, b = _operands()
        bm_a = st.BitMatrix.from_dense(a)
        bl, na_pad = tx._block_plan(bm_a.n)
        w = bm_a.n_words
        budget = 4 * (na_pad * w + bl * w) + 40 * (4 * (w + bl) + bl // 8)
        monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(budget))
        assert tx._b_chunk_rows(b.shape[0], w, bl, na_pad, True, "cpu") == 32
    return request.param


def _operands():
    return _uniform(37, 700, 0.3, seed=1), _uniform(150, 700, 0.3, seed=2)


def test_block_plan_and_chunk_rows_equal_jax(monkeypatch):
    for na in (1, 37, 4096, 5000):
        assert tx._block_plan(na) == jx._block_plan(na)
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(1 << 22))
    for nb, w, bitmap in ((150, 22, True), (5000, 100, False), (70, 8, False)):
        assert tx._b_chunk_rows(nb, w, 64, 64, bitmap, "cpu") == \
            jx._b_chunk_rows(nb, w, 64, 64, bitmap)


@pytest.mark.parametrize("k", [1, 8, 150])
def test_cross_topk_counts_equal_jax(walk, k):
    a, b = _operands()
    if walk == "chunked" and k > 32:
        for fn, kw in ((st.cross_topk_neighbors, {"device": "cpu"}),
                       (stormtpu.cross_topk_neighbors, {})):
            with pytest.raises(ValueError, match="B chunk"):
                fn(a, b, k, **kw)
        return
    vals, idx = st.cross_topk_neighbors(a, b, k, device="cpu")
    want, _ = stormtpu.cross_topk_neighbors(a, b, k)
    assert vals.dtype == idx.dtype == np.int32
    assert np.array_equal(vals, want)
    c = a.astype(np.int64) @ b.T.astype(np.int64)
    assert np.array_equal(c[np.arange(a.shape[0])[:, None], idx], vals)
    assert all(len(set(r.tolist())) == k for r in idx)


@pytest.mark.parametrize("measure", SIM_OPS)
def test_cross_topk_measure_equals_jax(walk, measure):
    a, b = _operands()
    b[7] = 0
    got = st.cross_topk_neighbors(a, b, 5, measure=measure, device="cpu")
    want = stormtpu.cross_topk_neighbors(a, b, 5, measure=measure)
    assert got[0].dtype == np.float64 and got[1].dtype == np.int32
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("measure", ["count", *SIM_OPS])
def test_cross_pairs_above_equals_jax(walk, measure):
    a, b = _operands()
    got = st.cross_pairs_above(a, b, THRESHOLDS[measure], measure=measure, device="cpu")
    want = stormtpu.cross_pairs_above(a, b, THRESHOLDS[measure], measure=measure)
    assert 0 < want[0].size < a.shape[0] * b.shape[0]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_cross_empty_results_and_validation_match_jax():
    a, b = _operands()
    for measure, th in (("count", 700), ("jaccard", 1.0)):
        got = st.cross_pairs_above(a, b, th, measure=measure, device="cpu")
        want = stormtpu.cross_pairs_above(a, b, th, measure=measure)
        assert got[0].size == 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
    for fn, kw in ((st.cross_topk_neighbors, {"device": "cpu"}),
                   (stormtpu.cross_topk_neighbors, {})):
        with pytest.raises(ValueError, match="k must be"):
            fn(a, b, 151, **kw)
        with pytest.raises(ValueError, match="bit-universe"):
            fn(a, b[:, :600], 2, **kw)
        with pytest.raises(ValueError, match="non-empty"):
            fn(a[:0], b, 2, **kw)
