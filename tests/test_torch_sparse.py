"""K3 and K4 of the port (``stormtpu_torch.kernels.sparse``) against the JAX
package's (``stormtpu.kernels.sparse``) on the CPU, on shared seeded
inputs: the padded position lists, K3's block and matrix, K4 on each of its
routes (the COO cache, the packed words, the NumPy fallback from either),
the refusals, and the two strategies through ``intersect_count_matrix``
with the ``ValueError`` → K2 fallback. The JAX side runs as its own tests
run it on the CPU (K3 jitted on the CPU; the K2 fallback in interpret
mode). Counts are integers: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.kernels.sparse as jsp
import stormtpu.native as jn
import stormtpu_torch as st
import stormtpu_torch.kernels.sparse as tsp
import stormtpu_torch.native as tn
from stormtpu_torch.oracle import oracle_count_matrix


def _case(name):
    """(row ids, positions, n, m_bits) of a named input; duplicates are
    part of every case with positions (packing ORs them, so counts must)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "uniform":
        n, m, k = 70, 3000, 900
        rows, pos = rng.integers(0, n, k), rng.integers(0, m, k)
    elif name == "empty_rows":
        n, m = 40, 2048
        rows = rng.choice(np.arange(0, n, 3), 300)  # two rows in three stay empty
        pos = rng.integers(0, m, 300)
    elif name == "one_row":
        n, m = 1, 500
        rows, pos = np.zeros(40, np.int64), rng.integers(0, m, 40)
    elif name == "two_rows":
        n, m = 2, 777
        rows, pos = rng.integers(0, n, 120), rng.integers(0, m, 120)
    elif name == "full_column":
        # column 5 held by every row, over a sparse background
        n, m = 50, 1500
        rows = np.r_[np.arange(n), rng.integers(0, n, 200)]
        pos = np.r_[np.full(n, 5), rng.integers(0, m, 200)]
    elif name == "all_empty":
        n, m = 9, 300
        rows = pos = np.zeros(0, np.int64)
    else:
        raise KeyError(name)
    rows, pos = np.asarray(rows, np.int64), np.asarray(pos, np.int64)
    if rows.size:
        rows, pos = np.r_[rows, rows[::7]], np.r_[pos, pos[::7]]
    return rows, pos, n, m


CASES = ("uniform", "empty_rows", "one_row", "two_rows", "full_column", "all_empty")


def _pair(name):
    rows, pos, n, m = _case(name)
    return (stormtpu.BitMatrix.from_positions(rows, pos, n, m),
            st.BitMatrix.from_positions(rows, pos, n, m))


@pytest.fixture
def no_native(monkeypatch):
    """Both packages as they run without their C++ tier."""
    monkeypatch.setattr(tn, "_load", lambda: None)
    for name in ("sparse_outer_from_packed_native", "sparse_outer_runs_native"):
        monkeypatch.setattr(jn, name, lambda *a: None)


@pytest.mark.parametrize("pad_mult", (128, 8))
@pytest.mark.parametrize("name", CASES)
def test_padded_position_lists_equal_jax(name, pad_mult):
    bj, bt = _pair(name)
    got = tsp.padded_position_lists(bt, pad_mult)
    want = jsp.padded_position_lists(bj, pad_mult)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("block_rows", (1, 3, None))
@pytest.mark.parametrize("na,nb", [(13, 40), (40, 13), (1, 7)])
def test_count_block_sparse_equals_jax(na, nb, block_rows):
    rows, pos, n, m = _case("uniform")
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    lists = tsp.padded_position_lists(bt)
    a, b = lists[:na], lists[n - nb:]
    got = tsp.count_block_sparse(torch.from_numpy(a), torch.from_numpy(b), sentinel=m,
                                 block_rows=block_rows)
    want = np.asarray(jsp.count_block_sparse(a, b, sentinel=m))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, oracle_count_matrix(bt.packed)[:na, n - nb:])


def test_count_block_sparse_of_unequal_list_lengths():
    """A's lists and B's may be padded to other lengths (the JAX package's
    K3 takes only equal ones)."""
    rows, pos, n, m = _case("uniform")
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    a = tsp.padded_position_lists(st.BitMatrix.from_packed(bt.packed[:10], m), 8)
    b = tsp.padded_position_lists(bt, 128)
    assert a.shape[1] != b.shape[1]
    got = tsp.count_block_sparse(torch.from_numpy(a), torch.from_numpy(b), sentinel=m)
    assert np.array_equal(got.numpy(), oracle_count_matrix(bt.packed)[:10])


def test_count_block_sparse_refuses_mixed_operands():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tsp.count_block_sparse(a, a.to(torch.int64), sentinel=9)
    with pytest.raises(ValueError, match="lies on"):
        tsp.count_block_sparse(a, a.to("meta"), sentinel=9)


def test_k3_blocks_follow_the_device_budget(monkeypatch):
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(4 * 19 * 40 * 128 * 5))
    assert tsp.k3_block_rows(40, 128, "cpu") == 5
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "1")
    assert tsp.k3_block_rows(40, 128, "cpu") == 1


@pytest.mark.parametrize("name", CASES)
def test_count_matrix_sparse_equals_jax(name):
    bj, bt = _pair(name)
    got = tsp.count_matrix_sparse(bt, device="cpu")
    want = jsp.count_matrix_sparse(bj)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bt.packed))


@pytest.mark.parametrize("route", ("coo", "packed", "fallback_coo", "fallback_packed"))
@pytest.mark.parametrize("name", CASES)
def test_count_matrix_sparse_outer_equals_jax(request, name, route):
    """K4 by each route: the C++ run walk over the COO cache, the C++ scan
    of the packed words (no cache), and the NumPy emission from either."""
    if route.startswith("fallback"):
        request.getfixturevalue("no_native")
    bj, bt = _pair(name)
    if route.endswith("packed"):
        bj = stormtpu.BitMatrix.from_packed(bj.packed, bj.m_bits)
        bt = st.BitMatrix.from_packed(bt.packed, bt.m_bits)
        assert bt.coo is None
    else:
        assert bt.coo is not None
    try:
        want = jsp.count_matrix_sparse_outer(bj)
    except ValueError as refused:  # a NumPy fallback's refusal: the port's too
        assert route.startswith("fallback") and name == "full_column"
        with pytest.raises(ValueError, match="occupancy") as port_refused:
            tsp.count_matrix_sparse_outer(bt, device="cpu")
        assert str(port_refused.value).split("—")[0] == str(refused).split("—")[0]
        return
    got = tsp.count_matrix_sparse_outer(bt, device="cpu")
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bt.packed))


def test_k4_refuses_more_than_32768_rows():
    bt = st.BitMatrix.from_packed(np.zeros((32769, 1), np.uint32), 32)
    bj = stormtpu.BitMatrix.from_packed(bt.packed, 32)
    for fn, bm in ((tsp.count_matrix_sparse_outer, bt), (jsp.count_matrix_sparse_outer, bj)):
        with pytest.raises(ValueError, match="n=32769"):
            fn(bm)
    with pytest.raises(ValueError, match="n=32769"):
        st.intersect_count_matrix(bt, strategy="sparse_outer", device="cpu")


def _clustered_column(n=40, m=2048, seed=3):
    """One column held by every row over a background of about one bit a
    column: the fallback's occupancy refusal."""
    rng = np.random.default_rng(seed)
    rows = np.r_[np.arange(n), rng.integers(0, n, 60)]
    pos = np.r_[np.zeros(n, np.int64), rng.integers(1, m, 60)]
    return rows, pos, n, m


def test_numpy_fallback_refusals_equal_jax(no_native):
    # a wide universe without the COO cache would be unpacked whole
    wide = np.zeros((4, (1 << 22) // 32 + 1), np.uint32)
    wide[:, 0] = 1
    refusals = [
        (st.BitMatrix.from_packed(wide, (1 << 22) + 32),
         stormtpu.BitMatrix.from_packed(wide, (1 << 22) + 32), "densify"),
    ]
    rows, pos, n, m = _clustered_column()
    refusals.append((st.BitMatrix.from_positions(rows, pos, n, m),
                     stormtpu.BitMatrix.from_positions(rows, pos, n, m), "occupancy"))
    # every row in every one of 65 columns: 65 · 2048² emission cells
    dense = np.ones((2048, 65), np.uint8)
    refusals.append((st.BitMatrix.from_dense(dense), stormtpu.BitMatrix.from_dense(dense),
                     "GiB"))
    for bt, bj, match in refusals:
        with pytest.raises(ValueError, match=match):
            jsp.count_matrix_sparse_outer(bj)
        with pytest.raises(ValueError, match=match):
            tsp.count_matrix_sparse_outer(bt, device="cpu")


# ------------------------------------------------ through the entry point
@pytest.mark.parametrize("strategy", ("sparse", "sparse_outer"))
@pytest.mark.parametrize("name", ("uniform", "empty_rows", "two_rows", "full_column"))
def test_intersect_count_matrix_sparse_strategies_equal_jax(name, strategy):
    bj, bt = _pair(name)
    got = st.intersect_count_matrix(bt, strategy=strategy, device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy=strategy)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bt.packed))


def test_api_k4_refusal_falls_back_to_the_k2_walk(no_native, monkeypatch):
    rows, pos, n, m = _clustered_column()
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    bj = stormtpu.BitMatrix.from_positions(rows, pos, n, m)
    import stormtpu_torch.kernels.mxu as tm

    walks = []
    real = tm.count_matrix_pallas_mxu
    monkeypatch.setattr(tm, "count_matrix_pallas_mxu",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    got = st.intersect_count_matrix(bt, strategy="sparse_outer", device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy="sparse_outer")
    assert walks == [1]
    assert np.array_equal(got, want) and np.array_equal(got, oracle_count_matrix(bt.packed))


def test_api_sparse_strategies_stay_off_the_dense_route(monkeypatch):
    """K4 runs on the host (no compaction scan, no operand on the device);
    K3 runs on the device it was given, under a budget that names it."""
    _, bt = _pair("uniform")
    monkeypatch.setattr(st.BitMatrix, "device_padded",
                        lambda *a, **k: pytest.fail("the packed operand went to the device"))
    st.intersect_count_matrix(bt, strategy="sparse_outer", device="cpu")
    st.intersect_count_matrix(bt, strategy="sparse", device="cpu")
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "50")
    with pytest.raises(ValueError, match="K3 position lists"):
        st.intersect_count_matrix(bt, strategy="sparse", device="cpu")
    st.intersect_count_matrix(bt, strategy="sparse_outer", device="cpu")


def test_coo_cache_is_a_copy_and_ignored_by_equality(monkeypatch):
    rows, pos, n, m = _case("uniform")
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    bj = stormtpu.BitMatrix.from_positions(rows, pos, n, m)
    for x, y in zip(bt.coo, bj.coo):
        assert x.dtype == y.dtype == np.int64 and np.array_equal(x, y)
    rows[:] = 0  # the caller's arrays change afterwards; K4 must not see it
    assert np.array_equal(tsp.count_matrix_sparse_outer(bt, device="cpu"),
                          oracle_count_matrix(bt.packed))
    same = st.BitMatrix(bt.packed, bt.n, bt.m_bits, bt.row_nnz)
    assert same.coo is None and "coo" not in repr(same)
    from stormtpu_torch.stream import _content_fingerprint

    assert _content_fingerprint(same) == _content_fingerprint(bt)
    over = np.zeros(9, np.int64)
    monkeypatch.setattr("stormtpu_torch.layout._COO_CACHE_MAX_NNZ", 8)
    assert st.BitMatrix.from_positions(over, over, 1, 10).coo is None
    assert st.BitMatrix.from_positions(over[:8], over[:8], 1, 10).coo is not None
