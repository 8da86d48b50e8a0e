"""The port's aggregate statistics (``stormtpu_torch.stats``) and histogram
walks (``stormtpu_torch.stream_hist``) against the JAX package's on the
CPU, on shared seeded numpy inputs: row sums by both routes, column
counts on the host, ``count_histogram`` by each of its five methods, and
the three ``stream_hist`` walks (streamed, sparse, clustered) with their
skips, operand streaming and refusals. The JAX side runs its Pallas
kernels in interpret mode, at 32-row tiles. Counts and histograms are
integers: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest

import stormtpu
import stormtpu.stats as jstats
import stormtpu.stream_hist as jsh
import stormtpu_torch as st
import stormtpu_torch.stats as tstats
import stormtpu_torch.stream_hist as tsh
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch import tuning as ttuning

DENSE = dict(k2_tile_rows=32, k2_tile_words=8)
CLUSTERED = dict(k2_tile_rows=32, k2_tile_words=128)
# cost constants under which K4 takes the sparse stripes and the K2 walk
# the stripes of the dense first superblock (as in test_torch_stream_sparse)
MIXED = dict(c_sort_s_per_nnz=0.0, c_n2_s_per_elem=0.0, c_emit_s_per_emission=1e-6,
             k2_int8_ops_per_s=1e12, dispatch_floor_s=1e-4, h2d_bytes_per_s=4e9)


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


def _block_diagonal(n, m, n_blocks, density, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, m), np.uint8)
    rows = np.linspace(0, n, n_blocks + 1).astype(int)
    cols = np.linspace(0, m, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        r0, r1, c0, c1 = rows[b], rows[b + 1], cols[b], cols[b + 1]
        dense[r0:r1, c0:c1] = rng.random((r1 - r0, c1 - c0)) < density
    return dense


def _hist_of(dense, n_bins, bin_width):
    c = dense.astype(np.int64) @ dense.T.astype(np.int64)
    tri = c[np.triu_indices(dense.shape[0], 1)]
    return np.bincount(np.minimum(tri // bin_width, n_bins - 1), minlength=n_bins)


def _same_manifest(got, want, ignore=()):
    assert np.array_equal(got["hist"], want["hist"])
    assert np.array_equal(got["bin_edges"], want["bin_edges"])
    strip = ("hist", "bin_edges", *ignore)
    assert {k: v for k, v in got.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}


# ------------------------------------------------------------ row sums
@pytest.mark.parametrize("route", ["positions", "bitplanes"])
@pytest.mark.parametrize("include_self", [True, False])
def test_count_row_sums_equal_jax(route, include_self):
    dense = _uniform(90, 1000, 0.2, seed=1)
    budget = 1 << 30 if route == "positions" else 0
    kw = dict(include_self=include_self, positions_budget_bytes=budget, chunk_bytes=1000)
    got = st.count_row_sums(dense, device="cpu", **kw)
    assert got.dtype == np.int64
    assert np.array_equal(got, stormtpu.count_row_sums(dense, **kw))
    c = dense.astype(np.int64) @ dense.T.astype(np.int64)
    assert np.array_equal(got, c.sum(axis=1) - (0 if include_self else np.diag(c)))


def test_column_counts_host_and_route_equal_jax():
    dense = _uniform(70, 999, 0.3, seed=2)
    bt, bj = st.BitMatrix.from_dense(dense), stormtpu.BitMatrix.from_dense(dense)
    want = jstats._column_counts_host(bj, chunk_rows=16)
    assert np.array_equal(tstats._column_counts_host(bt, chunk_rows=16), want)
    assert np.array_equal(tstats._column_counts_route(bt, "cpu"), want)
    assert np.array_equal(jstats._column_counts_route(bj), want)


def test_count_row_sums_of_empty_rows():
    dense = np.zeros((5, 100), np.uint8)
    assert st.count_row_sums(dense, positions_budget_bytes=0, device="cpu").tolist() == [0] * 5


# ------------------------------------------------------------ count_histogram
@pytest.mark.parametrize("method", ["auto", "dense", "streamed"])
def test_count_histogram_dense_routes_equal_jax(method):
    dense = _uniform(130, 700, 0.3, seed=3)
    kw = dict(n_bins=12, bin_width=9, superblock_rows=64, method=method)
    got = st.count_histogram(dense, config=st.EngineConfig(**DENSE), device="cpu", **kw)
    want = stormtpu.count_histogram(dense, config=JaxConfig(**DENSE), interpret=True, **kw)
    _same_manifest(got, want)
    assert np.array_equal(got["hist"], _hist_of(dense, 12, 9))


def test_count_histogram_auto_streams_above_the_operand_budget(monkeypatch):
    dense = _uniform(100, 500, 0.3, seed=4)
    monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
    kw = dict(n_bins=8, superblock_rows=32)
    got = st.count_histogram(dense, config=st.EngineConfig(**DENSE), device="cpu", **kw)
    assert got["operand_streaming"] is True
    _same_manifest(got, stormtpu.count_histogram(dense, config=JaxConfig(**DENSE), **kw))


@pytest.mark.parametrize("method", ["auto", "clustered"])
def test_count_histogram_clustered_equals_jax(method):
    dense = _block_diagonal(128, 16384, 3, 0.3, seed=5)
    kw = dict(n_bins=10, superblock_rows=64, method=method)
    got = st.count_histogram(dense, config=st.EngineConfig(**CLUSTERED), device="cpu", **kw)
    want = stormtpu.count_histogram(dense, config=JaxConfig(**CLUSTERED), interpret=True, **kw)
    assert got["kernel"] == "clustered"
    _same_manifest(got, want)


def test_count_histogram_clustered_single_group_takes_the_dense_route():
    dense = _uniform(40, 300, 0.3, seed=6)
    got = st.count_histogram(dense, n_bins=5, method="clustered",
                             config=st.EngineConfig(**CLUSTERED), device="cpu")
    assert got["kernel"] == "mxu" and np.array_equal(got["hist"], _hist_of(dense, 5, 61))


@pytest.mark.parametrize("method", ["auto", "sparse"])
def test_count_histogram_sparse_splits_stripes_and_equals_the_dense_one(monkeypatch, method):
    """The sparse walk against the JAX package's dense histogram (the
    histogram does not depend on the route): the first superblock is
    dense, so K2 takes its stripes and K4 the rest."""
    for k, v in MIXED.items():
        monkeypatch.setitem(ttuning.K4_DEFAULTS, k, v)
    rng = np.random.default_rng(7)
    dense = (rng.random((150, 4096)) < 0.0002).astype(np.uint8)
    dense[:64] = rng.random((64, 4096)) < 0.0015  # density 7.6e-4 in all
    kw = dict(n_bins=6, bin_width=2, superblock_rows=64)
    cfg = dict(k2_tile_rows=32, k2_tile_words=8)
    got = st.count_histogram(dense, config=st.EngineConfig(**cfg), method=method,
                             device="cpu", **kw)
    assert got["kernel"] == "sparse_outer"
    assert got["stripe_kernels"]["k4"] > 0 and got["stripe_kernels"]["dense"] > 0
    want = stormtpu.count_histogram(dense, config=JaxConfig(**cfg), method="dense", **kw)
    assert np.array_equal(got["hist"], want["hist"])
    assert np.array_equal(got["hist"], _hist_of(dense, 6, 2))


@pytest.mark.parametrize("method", ["auto", "dense", "streamed", "sparse", "clustered"])
def test_count_histogram_refusals_on_every_route(method):
    dense = _uniform(10, 64, 0.5, seed=8)
    for fn, kw in ((st.count_histogram, {"device": "cpu"}), (stormtpu.count_histogram, {})):
        with pytest.raises(ValueError, match="bin_width must be >= 1"):
            fn(dense, bin_width=0, method=method, **kw)
        with pytest.raises(ValueError, match="n_bins must be >= 1"):
            fn(dense, n_bins=0, method=method, **kw)
        with pytest.raises(ValueError, match="N >= 2"):
            fn(dense[:1], method=method, **kw)
    with pytest.raises(ValueError, match="method must be"):
        st.count_histogram(dense, method="magic", device="cpu")


def test_count_histogram_of_two_rows_equals_jax():
    dense = _uniform(2, 300, 0.5, seed=9)
    got = st.count_histogram(dense, n_bins=4, config=st.EngineConfig(**DENSE), device="cpu")
    _same_manifest(got, stormtpu.count_histogram(dense, n_bins=4, config=JaxConfig(**DENSE)))


# ------------------------------------------------------------ the walks
def test_stream_hist_streamed_skips_co_empty_stripes_as_jax():
    dense = _uniform(160, 700, 0.3, seed=10)
    dense[64:128] = 0  # an empty superblock: its stripes with others bin to 0
    kw = dict(n_bins=9, superblock_rows=32)
    bt, bj = st.BitMatrix.from_dense(dense), stormtpu.BitMatrix.from_dense(dense)
    got = tsh.stream_hist_streamed(bt, config=st.EngineConfig(**DENSE), device="cpu", **kw)
    want = jsh.stream_hist_streamed(bj, config=JaxConfig(**DENSE), interpret=True, **kw)
    assert got["stripes_skipped"] > 0
    _same_manifest(got, want)
    with pytest.raises(ValueError, match="occupancy has"):
        tsh.stream_hist_streamed(bt, occupancy=np.ones((2, 1), bool),
                                 config=st.EngineConfig(**DENSE), device="cpu", **kw)


@pytest.mark.parametrize("operand_streaming", [False, True])
def test_stream_hist_clustered_equals_jax(operand_streaming):
    # four blocks of one K-group each: superblock 0 holds blocks 0-1 and
    # superblock 1 blocks 2-3, so stripe (0, 1) is skipped
    dense = _block_diagonal(128, 16384, 4, 0.3, seed=11)
    bt, bj = st.BitMatrix.from_dense(dense), stormtpu.BitMatrix.from_dense(dense)
    kw = dict(n_bins=7, superblock_rows=64, operand_streaming=operand_streaming)
    got = tsh.stream_hist_clustered(bt, config=st.EngineConfig(**CLUSTERED), device="cpu", **kw)
    want = jsh.stream_hist_clustered(bj, config=JaxConfig(**CLUSTERED), interpret=True, **kw)
    assert got["stripes_skipped"] > 0 and got["work_items"] > 0
    _same_manifest(got, want)
    assert tsh.stream_hist_clustered(st.BitMatrix.from_dense(dense[:, :4096]),
                                     config=st.EngineConfig(**CLUSTERED), device="cpu") is None


def test_stream_hist_sparse_all_k4_equals_the_numpy_histogram():
    rng = np.random.default_rng(12)
    dense = (rng.random((90, 2048)) < 0.001).astype(np.uint8)
    got = tsh.stream_hist_sparse(st.BitMatrix.from_dense(dense), n_bins=3, bin_width=1,
                                 superblock_rows=32, device="cpu",
                                 config=st.EngineConfig(k2_tile_rows=32, k2_tile_words=8))
    assert got["stripe_kernels"] == {"k4": 6, "dense": 0}
    assert np.array_equal(got["hist"], _hist_of(dense, 3, 1))


def test_bin_values_and_stripe_mass_equal_jax():
    vals = np.array([0, 3, 9, 10, 400], dtype=np.int32)
    h_t, h_j = np.zeros(5, np.int64), np.zeros(5, np.int64)
    tsh._bin_values(h_t, vals, 4, 5)
    jsh._bin_values(h_j, vals, 4, 5)
    assert np.array_equal(h_t, h_j)
    for n, sb, i, j in ((100, 32, 0, 0), (100, 32, 3, 3), (100, 32, 1, 3), (100, 32, 4, 4)):
        assert tsh._stripe_pair_mass(n, sb, i, j) == jsh._stripe_pair_mass(n, sb, i, j)
