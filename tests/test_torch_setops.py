"""The port's set-operation and similarity surface (``stormtpu_torch.setops``)
against the JAX package's on the CPU, on shared seeded numpy inputs: every
``CARD_OPS`` cardinality, every ``SIM_OPS`` similarity, column counts
across word-chunk edges, and the pairwise-complete (missing-data) forms.
Counts are compared exactly and float64 values exactly (tolerance 0: both
packages derive them by the same NumPy operations from the same integer
counts). Also: the port exports every name of the JAX package."""

import numpy as np
import pytest

import stormtpu
import stormtpu.setops as jso
import stormtpu_torch as st
import stormtpu_torch.setops as tso


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


def _missing_panel(n, m, seed, missing=0.05):
    """(data, mask): odd rows copy the row before them with a tenth of the
    bits redrawn (pairs in strong LD), 5% of positions unobserved."""
    rng = np.random.default_rng(seed)
    data = (rng.random((n, m)) < 0.3).astype(np.uint8)
    redraw = rng.random((n // 2, m)) < 0.1
    data[1::2][: n // 2] = np.where(redraw, rng.random((n // 2, m)) < 0.3, data[0::2][: n // 2])
    mask = (rng.random((n, m)) >= missing).astype(np.uint8)
    return data & mask, mask


def test_port_exports_every_name_of_the_jax_package():
    assert set(stormtpu.__all__) <= set(st.__all__)
    assert st.__version__ == stormtpu.__version__
    for name in st.__all__:
        assert hasattr(st, name), name


def test_op_and_measure_lists_equal_jax():
    assert tso.CARD_OPS == jso.CARD_OPS
    assert tso.SIM_OPS == jso.SIM_OPS


@pytest.mark.parametrize("op", jso.CARD_OPS)
def test_pairwise_cardinality_equals_jax(op):
    dense = _uniform(70, 613, 0.3, seed=1)
    got = st.pairwise_cardinality(dense, op, device="cpu")
    want = stormtpu.pairwise_cardinality(dense, op)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("measure", jso.SIM_OPS)
def test_similarity_matrix_equals_jax(measure):
    dense = _uniform(70, 613, 0.3, seed=2)
    dense[5] = 0   # an empty row: zero denominators
    dense[6] = 1   # a full row: phi/r2's zero denominator
    got = st.similarity_matrix(dense, measure, device="cpu")
    want = stormtpu.similarity_matrix(dense, measure)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


def test_unknown_op_and_measure_raise_as_jax():
    dense = _uniform(4, 40, 0.5, seed=3)
    for fn in (st.pairwise_cardinality, stormtpu.pairwise_cardinality):
        with pytest.raises(ValueError, match="unknown op"):
            fn(dense, "nor", **({"device": "cpu"} if fn is st.pairwise_cardinality else {}))
    with pytest.raises(ValueError, match="unknown measure"):
        st.similarity_matrix(dense, "tanimoto", device="cpu")


@pytest.mark.parametrize("m,chunk", [(613, 4096), (2000, 7), (32 * 64, 64)])
def test_column_counts_equal_jax(m, chunk):
    dense = _uniform(37, m, 0.4, seed=m)
    got = st.column_counts(dense, chunk_words=chunk, device="cpu")
    assert got.dtype == np.int32 and got.shape == (m,)
    assert np.array_equal(got, stormtpu.column_counts(dense, chunk_words=chunk))
    assert np.array_equal(got, dense.sum(axis=0))


@pytest.mark.parametrize("measure", jso.SIM_OPS)
def test_similarity_matrix_complete_equals_jax(measure):
    data, mask = _missing_panel(50, 700, seed=4)
    got = st.similarity_matrix_complete(data, mask, measure, device="cpu")
    assert np.array_equal(got, stormtpu.similarity_matrix_complete(data, mask, measure))


@pytest.mark.parametrize("measure,threshold,block_rows", [
    ("r2", 0.5, 32), ("phi", 0.6, None), ("jaccard", 0.4, 64), ("cosine", 0.55, 32),
])
def test_pairs_above_complete_equals_jax(measure, threshold, block_rows):
    data, mask = _missing_panel(130, 900, seed=5)
    got = st.pairs_above_complete(data, mask, threshold, measure=measure,
                                  block_rows=block_rows, device="cpu")
    want = stormtpu.pairs_above_complete(data, mask, threshold, measure=measure,
                                         block_rows=block_rows)
    assert want[0].size > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)
    # and against the matrix form
    sim = stormtpu.similarity_matrix_complete(data, mask, measure)
    wi, wj = np.nonzero(np.triu(sim >= threshold, 1))
    assert np.array_equal(got[0], wi) and np.array_equal(got[1], wj)


def test_pairs_above_complete_empty_and_tiny():
    data, mask = _missing_panel(40, 300, seed=6)
    got = st.pairs_above_complete(data, mask, 1.0, measure="jaccard", device="cpu")
    assert all(x.size == 0 for x in got) and got[2].dtype == np.float64
    one = st.pairs_above_complete(data[:1], mask[:1], 0.5, device="cpu")
    assert all(x.size == 0 for x in one)
    two_w = stormtpu.pairs_above_complete(data[:2], mask[:2], 0.5)
    two = st.pairs_above_complete(data[:2], mask[:2], 0.5, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(two, two_w)) and two[0].size == 1


def test_pairs_above_complete_refusals_match_jax():
    data, mask = _missing_panel(8, 64, seed=7)
    for fn, kw in ((st.pairs_above_complete, {"device": "cpu"}),
                   (stormtpu.pairs_above_complete, {})):
        with pytest.raises(ValueError, match="does not depend on the mask"):
            fn(data, mask, 3, measure="count", **kw)
        with pytest.raises(ValueError, match="power of two"):
            fn(data, mask, 0.5, block_rows=24, **kw)
        with pytest.raises(ValueError, match="unobserved"):
            fn(data | 1, mask * 0, 0.5, **kw)
        with pytest.raises(ValueError, match="identical shape"):
            fn(data[:4], mask, 0.5, **kw)
