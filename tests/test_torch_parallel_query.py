"""``stormtpu_torch.parallel``'s queries and statistics against
``stormtpu.parallel`` on the CPU: the ring and bits-axis top-k (counts and
certified measures), the triangular ring and bits-axis screens, the
cross-set queries, row sums and the ring and stripe histograms, on 1-D
meshes of 1, 2, 3, 4, 5 and 8 ranks and on 2×2 and 4×2 grids. The top-k's
sharded form (each rank's ``RowShard``) against the host form, the JAX
package and a plain float32 product of the unpacked bits; the in-place
ring shift against ``ppermute``.

As in ``test_torch_parallel.py``: one spawned group of 8 gloo ranks runs
every case (``torch_parallel_cases.run_query``), and each case is one test
holding rank 0's result to the JAX package's. Counts, screens, row sums,
histograms and certified measure rankings must be equal; a count top-k's
values must be equal, and each row's indices distinct, never the row and
each realizing its count (tie order is each route's own). Only the values
are held to the reference there: its ring can name (0, 0) partners on rows
with fewer than k positive counts (``stormtpu/parallel/query.py``
``_ring_topk_local`` does not mask padded columns).
"""

import functools

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from stormtpu import parallel as jp
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu.oracle import oracle_count_block, oracle_count_matrix
from stormtpu_torch.parallel.dryrun import run_group

GROUP_TIMEOUT_S = 400


@pytest.fixture(scope="module")
def ranks():
    return run_group(cases.WORLD, "gloo", "cpu", cases.run_query, timeout=GROUP_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _data():
    return cases.data()


def _jbm(name):
    packed, m = _data()[name]
    return JaxBitMatrix.from_packed(packed, m)


def _jax_mesh(shape: str):
    if shape.startswith("g"):
        a, b = map(int, shape[1:].split("x"))
        return jp.make_grid_mesh(a, b)
    return jp.make_row_mesh(int(shape[1:]))


def _topk(name, k, **kw):
    return lambda mesh: jp.distributed_topk_neighbors(_jbm(name), k, mesh=mesh, **kw)


def _screen(name, threshold, **kw):
    return lambda mesh: jp.distributed_pairs_above(_jbm(name), threshold, mesh=mesh, **kw)


def _hist(name, **kw):
    def fn(mesh):
        man = jp.distributed_count_histogram(_jbm(name), mesh=mesh, **kw)
        return {k: man[k] for k in ("kernel", "hist", "bin_width", "bin_edges", "pairs",
                                    "stripes_skipped") if k in man}

    return fn


def _row_sums(mesh):
    bm = _jbm("row_sums")
    return (jp.distributed_count_row_sums(bm, mesh=mesh, chunk_words=64),
            jp.distributed_count_row_sums(bm, mesh=mesh, include_self=False))


def _cross_screen(measure, threshold):
    return lambda mesh: jp.distributed_cross_pairs_above(_jbm("cross_a"), _jbm("cross_b"),
                                                         threshold, measure=measure, mesh=mesh)


JAX = {
    "topk": _topk("topk", 5, block_rows=8),
    "topk_small_shard": _topk("topk_small", 7, block_rows=4),
    "topk_default_blocks": _topk("topk_small", 3),
    "topk_measure": _topk("measure", 5, measure="jaccard"),
    "topk_measure_r2": _topk("measure", 5, measure="r2"),
    "topk_bits": _topk("topk_bits", 5, shard_axis="bits"),
    "topk_bits_fallback": _topk("topk_small", 3, shard_axis="bits", block_rows=4),
    "topk_measure_bits": _topk("measure_bits", 4, shard_axis="bits", measure="r2"),
    "topk_grid": _topk("grid_q", 4, block_rows=8),
    "topk_sparse": _topk("topk_sparse", 8),
    "topk_sparse_bits": _topk("topk_sparse", 8, shard_axis="bits"),
    "topk_measure_grid": _topk("grid_measure", 4, measure="jaccard"),
    "screen_count": _screen("screen", 40, block_rows=8),
    "screen_jaccard": _screen("screen", 0.15, measure="jaccard", block_rows=8),
    "screen_r2": _screen("screen", 0.005, measure="r2", block_rows=8),
    "screen_empty": _screen("topk_small", 10**6, block_rows=4),
    "screen_bits": lambda mesh: _screen(
        "screen_bits", cases.threshold_of(_data(), "screen_bits", 99), shard_axis="bits")(mesh),
    "screen_bits_jaccard": _screen("screen_bits", 0.02, measure="jaccard", shard_axis="bits"),
    "screen_bits_fallback": _screen("topk_small", 50, shard_axis="bits", block_rows=4),
    "screen_grid": _screen("grid_q", 40, block_rows=8),
    "cross_topk": lambda mesh: jp.distributed_cross_topk_neighbors(_jbm("cross_a"),
                                                                   _jbm("cross_b"), 3, mesh=mesh),
    "cross_screen": _cross_screen("count", 140),
    "cross_screen_jaccard": _cross_screen("jaccard", 0.3),
    "row_sums": _row_sums,
    "hist_ring": _hist("hist", n_bins=8, block_rows=32, method="ring"),
    "hist_auto": _hist("hist", n_bins=8, block_rows=32),
    "hist_width": _hist("hist_width", n_bins=97, bin_width=1, block_rows=32),
    "hist_stripes": _hist("banded", n_bins=8, superblock_rows=64),
    "hist_ring_banded": _hist("banded", n_bins=8, method="ring", block_rows=32),
    "hist_stripes_dense": _hist("hist", n_bins=6, method="stripes", superblock_rows=32),
}

# count top-k cases: values equal, indices valid (tie order is the route's)
TIES = {"topk": "topk", "topk_small_shard": "topk_small", "topk_default_blocks": "topk_small",
        "topk_bits": "topk_bits", "topk_bits_fallback": "topk_small", "topk_grid": "grid_q",
        "topk_sparse": "topk_sparse", "topk_sparse_bits": "topk_sparse"}


# cases whose result names the mesh's geometry (the stripe walk rounds its
# superblock to R·8 rows): held to the JAX package on the same R
SAME_R = {"hist_stripes", "hist_stripes_dense"}


@functools.lru_cache(maxsize=None)
def jax_result(case: str, shape: str):
    return JAX[case](_jax_mesh(shape if shape.startswith("g") or case in SAME_R else "r8"))


@functools.lru_cache(maxsize=None)
def _counts(name):
    return oracle_count_matrix(_data()[name][0]).astype(np.int64)


def _equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what} [{k}]")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _equal(g, w, what)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _valid_indices(c: np.ndarray, vals: np.ndarray, idx: np.ndarray, what: str):
    """Each row's indices are distinct, never the row, and each realizes
    its count."""
    n, k = vals.shape
    assert np.array_equal(c[np.arange(n)[:, None], idx], vals), what
    for r in range(n):
        assert len(set(idx[r].tolist())) == k and r not in idx[r], f"{what}: row {r}"


PAIRS = [(case, shape) for case, (_, shapes) in cases.QUERY.items() for shape in shapes]


@pytest.mark.parametrize("case,shape", PAIRS, ids=[f"{c}-{s}" for c, s in PAIRS])
def test_case_equals_jax(ranks, case, shape):
    got = ranks[0][(case, shape)]
    want = jax_result(case, shape)
    what = f"{case} on {shape}"
    if case in TIES:
        _equal(got[0], want[0], what)
        _valid_indices(_counts(TIES[case]), got[0], got[1], what)
        assert got[1].dtype == want[1].dtype
    elif case == "cross_topk":
        _equal(got[0], want[0], what)
        c = oracle_count_block(_data()["cross_a"][0], _data()["cross_b"][0]).astype(np.int64)
        rows = np.repeat(np.arange(got[0].shape[0]), got[0].shape[1])
        assert np.array_equal(c[rows, got[1].ravel()], got[0].ravel()), what
    else:
        _equal(got, want, what)
    if case.startswith("screen") and case != "screen_empty":
        assert got[0].size > 0, f"{what}: a degenerate screen"


def test_every_rank_of_a_mesh_returns_the_same(ranks):
    for case, shape in PAIRS:
        have = [rk for rk in range(cases.WORLD) if (case, shape) in ranks[rk]]
        assert have[0] == 0, (case, shape)
        for rk in have[1:]:
            _equal(ranks[rk][(case, shape)], ranks[0][(case, shape)], f"{case} {shape} rank {rk}")


def test_queries_refuse_as_jax(ranks):
    errs = ranks[0][("errors", "world")]
    mesh = jp.make_row_mesh(8)
    bm = _jbm("topk_small")
    for key, call in (
        ("topk_axis", lambda: jp.distributed_topk_neighbors(bm, 3, mesh=mesh, shard_axis="cols")),
        ("topk_k", lambda: jp.distributed_topk_neighbors(bm, bm.n, mesh=mesh)),
        ("screen_axis", lambda: jp.distributed_pairs_above(bm, 50, mesh=mesh, shard_axis="cols")),
        ("hist_small_n", lambda: jp.distributed_count_histogram(
            JaxBitMatrix.from_packed(np.ones((1, 4), np.uint32), 128), mesh=mesh)),
        ("hist_method", lambda: jp.distributed_count_histogram(bm, method="bogus", mesh=mesh)),
    ):
        with pytest.raises(ValueError) as e:
            call()
        assert errs[key] == str(e.value), key
    # the JAX package bins with a zero width unchecked (a known reference
    # defect, ROADMAP §3); the port refuses it on every route
    assert errs["hist_width"] == "bin_width must be >= 1"


# ------------------------------------------------------------ sharded form
SHARDED_PAIRS = [(case, shape) for case, (_, shapes) in cases.SHARDED.items()
                 for shape in shapes]
SHARDED_ARGS = {"sharded_topk": ("topk", 5, 8), "sharded_k_past_shard": ("topk_small", 7, 4),
                "sharded_k_max": ("topk_small", 20, 4), "sharded_default_blocks": ("topk_sparse", 8,
                                                                                   None)}


@functools.lru_cache(maxsize=None)
def _plain_counts(name):
    """Exact counts as a float32 product of the unpacked bits (TF32 off),
    plain torch: every sum is a whole number below 2**24."""
    packed = _data()[name][0]
    bits = torch.from_numpy(np.unpackbits(packed.view(np.uint8), axis=1,
                                          bitorder="little").astype(np.float32))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (bits @ bits.T).round().to(torch.int64).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("case,shape", SHARDED_PAIRS, ids=[f"{c}-{s}" for c, s in SHARDED_PAIRS])
def test_sharded_form_equals_host_form_jax_and_plain(ranks, case, shape):
    got = ranks[0][(case, shape)]
    name, k, block_rows = SHARDED_ARGS[case]
    what = f"{case} on {shape}"
    for form in ("padded", "ones"):
        _equal(got[form], got["host"], f"{what} ({form} shard)")
    vals, idx = got["padded"]
    kw = {} if block_rows is None else {"block_rows": block_rows}
    want = jp.distributed_topk_neighbors(_jbm(name), k, mesh=jp.make_row_mesh(8), **kw)
    _equal(vals, want[0], what)
    c = _plain_counts(name)
    np.testing.assert_array_equal(c, _counts(name))
    c_off = c.copy()
    np.fill_diagonal(c_off, -1)
    np.testing.assert_array_equal(vals, -np.sort(-c_off, axis=1)[:, :k], err_msg=what)
    _valid_indices(c, vals, idx, what)
    assert vals.dtype == np.int32 and idx.dtype == np.int32


def test_sharded_form_is_the_same_on_every_rank(ranks):
    for case, shape in SHARDED_PAIRS:
        have = [rk for rk in range(cases.WORLD) if (case, shape) in ranks[rk]]
        assert len(have) == int(shape[1:])
        for rk in have[1:]:
            _equal(ranks[rk][(case, shape)]["padded"], ranks[0][(case, shape)]["padded"],
                   f"{case} {shape} rank {rk}")


@pytest.mark.parametrize("shape", cases.SHAPES)
def test_ring_shift_in_place_equals_ppermute(ranks, shape):
    """Staging buffers of 7 and 4 elements (neither divides the 15 of the
    buffer), of the whole buffer and as ``shift_stage`` sizes it; shifts
    −1 and 2; on every rank of the mesh."""
    for rk in range(cases.WORLD):
        got = ranks[rk].get(("shifts", shape))
        if got is None:
            continue
        r = int(shape[1:]) if shape.startswith("r") else int(shape[1:].split("x")[0])
        line = rk if shape.startswith("r") else rk // int(shape.split("x")[1])
        assert len(got) == 8
        for (shift, c), (same, equal, arr) in got.items():
            assert same and equal, (shape, rk, shift, c)
            # the rank ``shift`` places back along the rows axis sent it
            src = (line - shift) % r
            src_rank = src if shape.startswith("r") else src * int(shape.split("x")[1]) + (
                rk % int(shape.split("x")[1]))
            assert np.array_equal(arr, np.arange(15).reshape(5, 3) + 100 * src_rank)


def test_sharded_form_refuses_a_wrong_shard(ranks):
    errs = ranks[0][("sharded_errors", "world")]
    assert errs["row0"] == "this rank holds rows [0, 4) of the ring (shard_rows), got 4 rows from 1"
    assert errs["rows"] == "this rank holds rows [0, 4) of the ring (shard_rows), got 5 rows from 0"
    assert errs["words"] == "a RowShard's words are int32 [rows, 16], got torch.int32 (4, 15)"
    assert errs["measure"].startswith("a RowShard runs the count top-k on the rows ring")
    assert errs["k"] == "k must be in [1, N-1], got k=21, N=21"
    assert errs["strided"] == "ring_shift_ rotates a contiguous buffer in place"
    assert errs["stage"] == ("the stage must be torch.int32 where the send leaves from "
                             "(shift_stage), got torch.float32 on cpu")
