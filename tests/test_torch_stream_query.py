"""The port's streamed queries (``stormtpu_torch.stream_query``) against the
JAX package's (``stormtpu.stream_query``) on the CPU, on shared seeded
inputs: the top-k by count and by every measure, the screens by count and
by every measure, on each stripe kernel (``mxu``, ``dense``, ``xla_int8``,
``xla_popcount``) with the operand resident and streamed; the co-empty
skip; resume after an interrupted walk; the manifest and checkpoint checks
that raise; the pairwise-complete screen; and directories started by one
package and finished by the other, in both directions.

The JAX side runs its Pallas kernels in interpret mode. Counts and float64
values are compared exactly (tolerance 0). Top-k values are compared
exactly; indices are validated (each realizes its value, never the row
itself, distinct), never compared: the order among equal values depends on
the route, in the reference too."""

import json
import os

import numpy as np
import pytest

import stormtpu.cross as jcross
import stormtpu.stream as js
import stormtpu.stream_query as jsq
import stormtpu_torch as st
import stormtpu_torch.cross as tcross
import stormtpu_torch.stream as ts
import stormtpu_torch.stream_query as tsq
from conftest import random_bitmatrix
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu.oracle import oracle_count_matrix
from stormtpu.setops import derive_similarity
from test_clustered import block_diagonal_bitmatrix

# K1 tiles of 8 rows; K2 tiles of 32 rows (the port's K2 takes multiples
# of 32): superblocks of 32-64 rows cross tile and superblock edges cheaply
FIELDS = dict(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)
KERNELS = ("mxu", "dense", "xla_int8", "xla_popcount")
SIM_OPS = ("jaccard", "dice", "cosine", "overlap", "phi", "r2")


def _configs(**over):
    fields = {**FIELDS, **over}
    return JaxConfig(**fields), st.EngineConfig(**fields)


def _pair(bj):
    return bj, st.BitMatrix.from_packed(bj.packed, bj.m_bits)


def _jax(fn, bm, *args, **kw):
    return getattr(jsq, fn)(bm, *args, config=_configs()[0], interpret=True, **kw)


def _port(fn, bm, *args, **kw):
    return getattr(tsq, fn)(bm, *args, config=_configs()[1], device="cpu", **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape and np.array_equal(g, w)


def _scores(bm, measure):
    c = oracle_count_matrix(bm.packed).astype(np.int64)
    if measure == "count":
        np.fill_diagonal(c, -1)
        return c
    s = derive_similarity(c, bm.row_nnz[:, None], bm.row_nnz[None, :], bm.m_bits, measure)
    np.fill_diagonal(s, -np.inf)
    return s


def _check_topk(bm, got, want, k, measure="count"):
    """Values equal the JAX package's and the oracle's; each real entry's
    index realizes its value, is not the row, and no partner repeats."""
    vals, idx = got
    assert vals.dtype == want[0].dtype and idx.dtype == np.int32
    assert np.array_equal(vals, want[0])
    s = _scores(bm, measure)
    top = -np.sort(-s, axis=1)[:, :k]
    top = np.maximum(top, 0) if measure == "count" else np.where(np.isfinite(top), top, 0.0)
    assert np.array_equal(vals, top)
    for r in range(bm.n):
        # (0, 0) is the no-partner convention
        real = vals[r] > 0 if measure == "count" else (vals[r] != 0) | (idx[r] != 0)
        assert np.array_equal(s[r, idx[r][real]], vals[r][real])
        assert r not in set(idx[r][real].tolist())
        assert len(set(idx[r][real].tolist())) == int(real.sum())


def _spy(monkeypatch, name, record=None, fail_at=None):
    """Wrap the port's ``stream_query.<name>``: count its calls, record
    ``record(args, kwargs)``, raise at call ``fail_at``."""
    real = getattr(tsq, name)
    calls = {"n": 0, "fail_at": fail_at, "seen": []}

    def wrapper(*a, **kw):
        calls["n"] += 1
        if calls["fail_at"] is not None and calls["n"] == calls["fail_at"]:
            raise RuntimeError("simulated crash")
        if record is not None:
            calls["seen"].append(record(a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(tsq, name, wrapper)
    return calls


# ---------------------------------------------------------------- resolution
@pytest.mark.parametrize("n,m", [(20, 256), (52, 600), (64, 16384), (300, 16384),
                                 (60, 2048), (130, 1024), (10, 1 << 18)])
def test_auto_stream_kernel_resolves_as_jax(n, m):
    """On the CPU the port's ``_auto_stream_kernel`` and the reference's
    name the same kernel on every shape these tests use (the name is part
    of every manifest)."""
    assert ts._auto_stream_kernel(m, n, "cpu") == js._auto_stream_kernel(m, n)
    bj, bt = _pair(random_bitmatrix(n, m, 0.01, seed=n))
    jcfg, cfg = _configs()
    for kernel in ("auto", *KERNELS):
        for bitmap in (False, True):
            got, _, name = tsq._walk_resolution(bt, 48, kernel, cfg, bitmap=bitmap,
                                                device="cpu")
            want, _, want_name = jsq._walk_resolution(bj, 48, kernel, jcfg, True, bitmap=bitmap)
            assert name == want_name
            assert (got.kernel, got.ti, got.wk, got.sb, got.w_pad, got.n_pad, got.n_super) == (
                want[1], want[3], want[4], want[5], want[7], want[8], want[9])


@pytest.mark.parametrize("measure", SIM_OPS)
def test_derive_similarity_torch_equals_numpy_bit_for_bit(measure):
    """The top-k walk's float64 rescore gives the host formulas' values
    bit for bit, zero denominators included, with a scalar universe and a
    per-pair one (on the CPU through NumPy; the card's form is held in
    ``tests/test_torch_cuda.py``)."""
    import torch

    from stormtpu_torch.setops import derive_similarity as host
    from stormtpu_torch.setops import derive_similarity_torch

    rng = np.random.default_rng(31)
    m = 1 << 20
    ca = rng.integers(0, m + 1, (64, 1))
    cb = rng.integers(0, m + 1, (1, 80))
    ca[:3], cb[:, :3] = 0, m
    inter = np.minimum(rng.integers(0, m, (64, 80)), np.minimum(ca, cb))
    per_pair = np.maximum(rng.integers(m // 2, m + 1, (64, 80)), np.maximum(ca, cb))
    for universe in (m, per_pair):
        want = host(inter, ca, cb, universe, measure)
        got = derive_similarity_torch(
            torch.from_numpy(inter), torch.from_numpy(ca), torch.from_numpy(cb),
            torch.from_numpy(universe) if isinstance(universe, np.ndarray) else universe,
            measure).numpy()
        assert got.dtype == np.float64 and np.array_equal(got.view(np.int64),
                                                          want.view(np.int64))


# ---------------------------------------------------------------- top-k
@pytest.mark.parametrize("kernel", KERNELS)
def test_stream_topk_equals_jax(kernel):
    bj, bt = _pair(random_bitmatrix(52, 600, 0.3, seed=71))
    got = _port("stream_topk_neighbors", bt, 5, superblock_rows=16, kernel=kernel)
    want = _jax("stream_topk_neighbors", bj, 5, superblock_rows=16, kernel=kernel)
    _check_topk(bj, got, want, 5)


@pytest.mark.parametrize("kernel", ("mxu", "xla_popcount"))
def test_stream_topk_operand_streaming_equals_resident(kernel, monkeypatch):
    bj, bt = _pair(random_bitmatrix(100, 600, 0.3, seed=72))
    resident = _port("stream_topk_neighbors", bt, 4, superblock_rows=32, kernel=kernel)
    monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
    # K2 stripes of a count top-k take K2-topk (no dense stripe): its sets
    # come from the same two slices
    stripe_fn = "_stripe_topk_sets" if kernel == "mxu" else "_stripe_counts"
    seen = _spy(monkeypatch, stripe_fn, record=lambda a, kw: a[0].streaming)
    streamed = _port("stream_topk_neighbors", bt, 4, superblock_rows=32, kernel=kernel)
    assert seen["seen"] and all(seen["seen"])
    assert np.array_equal(streamed[0], resident[0])
    _check_topk(bj, streamed, _jax("stream_topk_neighbors", bj, 4, superblock_rows=32,
                                   kernel=kernel), 4)


def test_stream_topk_matches_single_chip_values():
    bj, bt = _pair(random_bitmatrix(40, 512, 0.4, seed=72))
    v_s, _ = _port("stream_topk_neighbors", bt, 3, superblock_rows=16)
    v_1, _ = st.topk_neighbors(bt, 3, device="cpu")
    assert np.array_equal(v_s, v_1)
    assert np.array_equal(v_s, _jax("stream_topk_neighbors", bj, 3, superblock_rows=16)[0])


def test_stream_topk_k_bounds():
    bj, bt = _pair(random_bitmatrix(20, 256, 0.5, seed=73))
    for k, sb in ((0, 4096), (20, 4096), (40, 8)):
        with pytest.raises(ValueError) as got:
            _port("stream_topk_neighbors", bt, k, superblock_rows=sb)
        with pytest.raises(ValueError) as want:
            _jax("stream_topk_neighbors", bj, k, superblock_rows=sb)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("measure", SIM_OPS)
def test_stream_topk_measure_equals_jax(measure):
    bj, bt = _pair(random_bitmatrix(70, 1024, 0.3, seed=95))
    got = _port("stream_topk_neighbors", bt, 6, superblock_rows=32, measure=measure)
    want = _jax("stream_topk_neighbors", bj, 6, superblock_rows=32, measure=measure)
    _check_topk(bj, got, want, 6, measure)


@pytest.mark.parametrize("measure", ("jaccard", "r2"))
def test_stream_topk_measure_dense_walk_default_config(measure):
    """The default configuration (256-row tiles: one stripe), as the
    reference's test runs it."""
    bj, bt = _pair(random_bitmatrix(70, 1024, 0.3, seed=95))
    got = tsq.stream_topk_neighbors(bt, 6, superblock_rows=16, measure=measure, device="cpu")
    want = jsq.stream_topk_neighbors(bj, 6, superblock_rows=16, measure=measure)
    _check_topk(bj, got, want, 6, measure)


def test_stream_topk_measure_r2_zero_stripes_score():
    """A row pair with no co-occupied superblock still gets its
    anti-correlation score."""
    rng = np.random.default_rng(98)
    dense = np.zeros((64, 4096), dtype=np.uint8)
    dense[:32, :2000] = rng.random((32, 2000)) < 0.5
    dense[32:, 2100:] = rng.random((32, 1996)) < 0.5
    bj, bt = _pair(JaxBitMatrix.from_dense(dense))
    got = _port("stream_topk_neighbors", bt, 3, superblock_rows=32, measure="r2")
    want = _jax("stream_topk_neighbors", bj, 3, superblock_rows=32, measure="r2")
    _check_topk(bj, got, want, 3, "r2")


def test_stream_topk_measure_escalation(monkeypatch):
    """A huge certification slack forces kk to double up to the stripe's
    width; the values stay exact."""
    monkeypatch.setattr(tcross, "_MEASURE_TOPK_SLACK", 1.0)
    monkeypatch.setattr(jcross, "_MEASURE_TOPK_SLACK", 1.0)
    seen = _spy(monkeypatch, "_stripe_topk_measure", record=lambda a, kw: kw["kk"])
    bj, bt = _pair(random_bitmatrix(130, 1024, 0.3, seed=99))
    got = _port("stream_topk_neighbors", bt, 2, superblock_rows=64, measure="jaccard")
    assert min(seen["seen"]) < max(seen["seen"]) == 64, seen["seen"]
    want = _jax("stream_topk_neighbors", bj, 2, superblock_rows=64, measure="jaccard")
    _check_topk(bj, got, want, 2, "jaccard")


# ---------------------------------------------------------------- screens
SCREENS = [("count", 30), ("jaccard", 0.22), ("dice", 0.36), ("cosine", 0.36),
           ("overlap", 0.4), ("phi", 0.1), ("r2", 0.02)]


@pytest.mark.parametrize("measure,threshold", SCREENS)
def test_stream_pairs_above_equals_jax(measure, threshold):
    bj, bt = _pair(random_bitmatrix(52, 600, 0.3, seed=74))
    got = _port("stream_pairs_above", bt, threshold, measure=measure, superblock_rows=16)
    want = _jax("stream_pairs_above", bj, threshold, measure=measure, superblock_rows=16)
    _assert_same(got, want)
    assert got[0].size and np.all(got[0] < got[1])
    _assert_same(got, st.pairs_above(bt, threshold, measure=measure, device="cpu"))


@pytest.mark.parametrize("kernel", KERNELS)
def test_stream_pairs_above_kernels_equal_jax(kernel):
    bj, bt = _pair(random_bitmatrix(70, 500, 0.3, seed=41))
    for measure, thr in (("count", 40), ("jaccard", 0.2)):
        got = _port("stream_pairs_above", bt, thr, measure=measure, superblock_rows=32,
                    kernel=kernel)
        _assert_same(got, _jax("stream_pairs_above", bj, thr, measure=measure,
                               superblock_rows=32, kernel=kernel))
        assert got[0].size


def test_stream_pairs_above_operand_streaming(monkeypatch):
    bj, bt = _pair(random_bitmatrix(100, 600, 0.3, seed=42))
    want = _jax("stream_pairs_above", bj, 0.2, measure="jaccard", superblock_rows=32)
    monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
    seen = _spy(monkeypatch, "_stripe_counts", record=lambda a, kw: a[0].streaming)
    got = _port("stream_pairs_above", bt, 0.2, measure="jaccard", superblock_rows=32)
    assert len(seen["seen"]) == 10 and all(seen["seen"])
    _assert_same(got, want)


def test_stream_pairs_above_no_hits():
    bj, bt = _pair(random_bitmatrix(24, 300, 0.1, seed=75))
    got = _port("stream_pairs_above", bt, 299, superblock_rows=8)
    _assert_same(got, _jax("stream_pairs_above", bj, 299, superblock_rows=8))
    assert got[0].size == 0


def test_stream_pairs_above_oracle_cross_check():
    bj, bt = _pair(random_bitmatrix(44, 480, 0.45, seed=76))
    c = oracle_count_matrix(bj.packed)
    thr = int(np.percentile(c[np.triu_indices(bj.n, 1)], 90))
    ii, jj, v = _port("stream_pairs_above", bt, thr, superblock_rows=16)
    want_i, want_j = np.nonzero(np.triu(c, 1) >= thr)
    assert np.array_equal(ii, want_i) and np.array_equal(jj, want_j)
    assert np.array_equal(v, c[want_i, want_j])


def test_stream_pairs_above_odd_tile_rows():
    """The superblock rounds to a multiple of both the tile rows and 32."""
    bj, bt = _pair(random_bitmatrix(70, 500, 0.3, seed=41))
    want = st.pairs_above(bt, 12, device="cpu")
    for ti in (24, 48):
        jcfg, cfg = _configs(k1_tile_rows=ti)
        got = tsq.stream_pairs_above(bt, 12, superblock_rows=40, kernel="dense", config=cfg,
                                     device="cpu")
        _assert_same(got, want)
        _assert_same(got, jsq.stream_pairs_above(bj, 12, superblock_rows=40, kernel="dense",
                                                 config=jcfg, interpret=True))
        vals, idx = tsq.stream_topk_neighbors(bt, 4, superblock_rows=40, kernel="dense",
                                              config=cfg, device="cpu")
        _check_topk(bj, (vals, idx), jsq.stream_topk_neighbors(
            bj, 4, superblock_rows=40, kernel="dense", config=jcfg, interpret=True), 4)


def test_stream_queries_reject_unknown_kernel():
    _, bt = _pair(random_bitmatrix(20, 256, 0.3, seed=5))
    with pytest.raises(ValueError, match="unknown kernel"):
        tsq.stream_topk_neighbors(bt, 3, kernel="clustered", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        tsq.stream_pairs_above(bt, 5, kernel="mxU", device="cpu")


# ------------------------------------------------------------- the skip
def _co_occupied(bm, sb):
    """The stripes (i, j) whose superblocks share a set bit's 4096-bit
    group: the ones a walk must compute on the device."""
    dense = np.asarray(bm.to_dense(), dtype=bool)
    n_super = -(-bm.n // sb)
    groups = [dense[i * sb:(i + 1) * sb].reshape(-1, dense.shape[1]).any(axis=0)
              for i in range(n_super)]
    groups = [np.add.reduceat(g, np.arange(0, g.size, 4096)) > 0 for g in groups]
    return [(i, j) for i in range(n_super) for j in range(i, n_super)
            if (groups[i] & groups[j]).any()]


def test_stream_queries_clustered_summary_skip(monkeypatch):
    """Block-diagonal input: co-empty stripes take no device work, and no
    value changes (count, jaccard, r², whose skipped stripes come from the
    host staircase)."""
    bj, bt = _pair(block_diagonal_bitmatrix(64, 12800, 4, 0.35, seed=77))
    seen = _spy(monkeypatch, "_stripe_counts", record=lambda a, kw: (a[1], a[2]))
    kw = dict(superblock_rows=16, kernel="dense")
    got = _port("stream_topk_neighbors", bt, 4, **kw)
    walked = _co_occupied(bj, 16)
    assert seen["seen"] == walked and len(walked) < 10
    _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 4, **kw), 4)
    for measure, thr in (("count", 20), ("jaccard", 0.2), ("r2", 0.3)):
        got = _port("stream_pairs_above", bt, thr, measure=measure, **kw)
        _assert_same(got, _jax("stream_pairs_above", bj, thr, measure=measure, **kw))
        _assert_same(got, st.pairs_above(bt, thr, measure=measure, device="cpu"))


def test_stream_queries_phi_r2_summary_skip_staircase(monkeypatch):
    """Two dense blocks on disjoint bit halves: every cross pair is
    anti-correlated (r² about 0.67, above the threshold) and lies in the
    skipped stripe; the host staircase must recover it with no device
    stripe."""
    bj, bt = _pair(block_diagonal_bitmatrix(64, 16384, 2, 0.9, seed=179))
    seen = _spy(monkeypatch, "_stripe_counts", record=lambda a, kw: (a[1], a[2]))
    assert _co_occupied(bj, 32) == [(0, 0), (1, 1)]
    for measure in ("phi", "r2"):
        seen["seen"].clear()
        got = _port("stream_topk_neighbors", bt, 4, superblock_rows=32, measure=measure)
        assert seen["seen"] == [(0, 0), (1, 1)], measure
        _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 4, superblock_rows=32,
                                  measure=measure), 4, measure)
    for measure, thr in (("r2", 0.3), ("phi", 0.2)):
        seen["seen"].clear()
        got = _port("stream_pairs_above", bt, thr, measure=measure, superblock_rows=32)
        assert seen["seen"] == [(0, 0), (1, 1)], measure
        _assert_same(got, _jax("stream_pairs_above", bj, thr, measure=measure,
                               superblock_rows=32))
        _assert_same(got, st.pairs_above(bt, thr, measure=measure, device="cpu"))
        if measure == "r2":
            assert ((got[0] < 32) & (got[1] >= 32)).any()


# ------------------------------------------------------------- budgets
def test_over_budget_routes_to_streaming(monkeypatch):
    """Past the device budget the resident forms refuse and name the
    streamed ones, which keep working (on two slices)."""
    monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "1000")
    bj, bt = _pair(random_bitmatrix(40, 512, 0.4, seed=79))
    with pytest.raises(ValueError, match="stream_count_matrix"):
        st.intersect_count_matrix(bt, strategy="pallas_mxu", device="cpu")
    with pytest.raises(ValueError, match="stormtpu_torch.stream_query.stream_topk_neighbors"):
        st.topk_neighbors(bt, 3, device="cpu")
    with pytest.raises(ValueError, match="stormtpu_torch.stream_query.stream_pairs_above"):
        st.pairs_above(bt, 10, device="cpu")
    seen = _spy(monkeypatch, "_stripe_counts", record=lambda a, kw: a[0].streaming)
    got = _port("stream_topk_neighbors", bt, 3, superblock_rows=16)
    assert seen["seen"] and all(seen["seen"])
    _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 3, superblock_rows=16), 3)


def test_budget_guard_covers_clustered_and_spares_host_routes(monkeypatch):
    """The refusal guard fires on the clustered route and is sized by its
    plan; K4, on the host, allocates nothing on the device and is not
    refused, alone or as the streamed screen's sparse stripes. (The port's
    K3 runs on the device and is guarded: the reference's host sparse
    screen has no device route to spare there.)"""
    bj, bt = _pair(block_diagonal_bitmatrix(64, 12800, 4, 0.35, seed=13))
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "1000")
    with pytest.raises(ValueError, match="stream_count_matrix"):
        st.intersect_count_matrix(bt, strategy="clustered", device="cpu")
    ok = 4 * 128 * bt.n_words * 4 + 4 * 64 * 64 * 16
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(ok))
    out = st.intersect_count_matrix(bt, strategy="clustered", device="cpu")
    assert np.array_equal(out, oracle_count_matrix(bj.packed))
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "1000")
    sj, stt = _pair(random_bitmatrix(40, 65536, 0.0005, seed=29))
    c = oracle_count_matrix(sj.packed)
    assert np.array_equal(st.intersect_count_matrix(stt, strategy="sparse_outer",
                                                    device="cpu"), c)
    wi, wj = np.nonzero(np.triu(c, 1) >= 1)
    got = _port("stream_pairs_above", stt, 1, superblock_rows=16, kernel="sparse_outer")
    _assert_same(got, (wi.astype(np.int32), wj.astype(np.int32), c[wi, wj].astype(np.int32)))


# ------------------------------------------------------- resume and files
def test_stream_topk_checkpoint_resume(tmp_path, monkeypatch):
    """An interrupted walk resumes from its per-row checkpoint: finished
    rows are not computed again, the result equals the plain walk's, and a
    checkpoint of other parameters raises."""
    bj, bt = _pair(random_bitmatrix(52, 600, 0.3, seed=91))
    kw = dict(superblock_rows=16, kernel="dense")
    want = _port("stream_topk_neighbors", bt, 5, **kw)
    calls = _spy(monkeypatch, "_stripe_topk", fail_at=5)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _port("stream_topk_neighbors", bt, 5, out_dir=str(tmp_path), **kw)
    crashed = calls["n"]
    calls["fail_at"] = None
    got = _port("stream_topk_neighbors", bt, 5, out_dir=str(tmp_path), **kw)
    assert np.array_equal(got[0], want[0])
    _check_topk(bj, got, _jax("stream_topk_neighbors", bj, 5, **kw), 5)
    assert calls["n"] - crashed < 4 * 5 // 2  # fewer than a whole walk's 10 stripes
    with pytest.raises(ValueError, match="checkpoint"):
        _port("stream_topk_neighbors", bt, 4, out_dir=str(tmp_path), **kw)


def test_stream_pairs_stripe_files_resume(tmp_path, monkeypatch):
    """Stripe hit files are skipped on a re-run; a deleted one is computed
    again, alone; a manifest of other parameters raises."""
    bj, bt = _pair(random_bitmatrix(52, 600, 0.3, seed=92))
    kw = dict(superblock_rows=16, kernel="dense")
    want = _jax("stream_pairs_above", bj, 30, **kw)
    calls = _spy(monkeypatch, "_stripe_screen")
    _assert_same(_port("stream_pairs_above", bt, 30, out_dir=str(tmp_path), **kw), want)
    assert calls["n"] == 3  # 16 rows round to 32: two superblocks
    calls["n"] = 0
    _assert_same(_port("stream_pairs_above", bt, 30, out_dir=str(tmp_path), **kw), want)
    assert calls["n"] == 0
    os.remove(os.path.join(str(tmp_path), "hits_00000_00001.npz"))
    _assert_same(_port("stream_pairs_above", bt, 30, out_dir=str(tmp_path), **kw), want)
    assert calls["n"] == 1
    with pytest.raises(ValueError, match="manifest"):
        _port("stream_pairs_above", bt, 31, out_dir=str(tmp_path), **kw)


def test_resume_rejects_different_content_and_resume_false(tmp_path):
    b1j, b1 = _pair(random_bitmatrix(40, 512, 0.4, seed=95))
    b2j, b2 = _pair(random_bitmatrix(40, 512, 0.4, seed=96))
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "s")
    kw = dict(superblock_rows=16, kernel="dense")
    _port("stream_topk_neighbors", b1, 3, out_dir=d1, **kw)
    with pytest.raises(ValueError, match="checkpoint"):
        _port("stream_topk_neighbors", b2, 3, out_dir=d1, **kw)
    got = _port("stream_topk_neighbors", b2, 3, out_dir=d1, resume=False, **kw)
    _check_topk(b2j, got, _jax("stream_topk_neighbors", b2j, 3, **kw), 3)
    _port("stream_pairs_above", b1, 30, out_dir=d2, **kw)
    with pytest.raises(ValueError, match="manifest"):
        _port("stream_pairs_above", b2, 30, out_dir=d2, **kw)
    got = _port("stream_pairs_above", b2, 30, out_dir=d2, resume=False, **kw)
    _assert_same(got, _jax("stream_pairs_above", b2j, 30, **kw))


def _same_directory(got_dir, want_dir):
    """Same manifests (JSON), same files, same members (dtype, shape,
    values) in each."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".json"):
            with open(g) as fg, open(w) as fw:
                assert json.load(fg) == json.load(fw), name
            continue
        with np.load(g) as zg, np.load(w) as zw:
            assert sorted(zg.files) == sorted(zw.files), name
            for m in zw.files:
                assert zg[m].dtype == zw[m].dtype and zg[m].shape == zw[m].shape, (name, m)
                assert np.array_equal(zg[m], zw[m]), (name, m)


@pytest.mark.parametrize("measure,threshold", [("count", 30), ("r2", 0.02)])
def test_screen_directory_equals_jax(tmp_path, measure, threshold):
    bj, bt = _pair(random_bitmatrix(52, 600, 0.3, seed=93))
    kw = dict(measure=measure, superblock_rows=16, kernel="mxu")
    _port("stream_pairs_above", bt, threshold, out_dir=str(tmp_path / "t"), **kw)
    _jax("stream_pairs_above", bj, threshold, out_dir=str(tmp_path / "j"), **kw)
    _same_directory(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("first", ("jax", "port"))
def test_screen_directory_crosses_packages(tmp_path, first):
    """A hit directory written by one package, two stripe files deleted,
    is finished by the other with the same result."""
    bj, bt = _pair(random_bitmatrix(100, 600, 0.3, seed=94))
    kw = dict(measure="jaccard", superblock_rows=32, kernel="mxu", out_dir=str(tmp_path))
    want = _jax("stream_pairs_above", bj, 0.2, superblock_rows=32, measure="jaccard")
    start, finish = ((_jax, bj), (_port, bt)) if first == "jax" else ((_port, bt), (_jax, bj))
    _assert_same(start[0]("stream_pairs_above", start[1], 0.2, **kw), want)
    for name in ("hits_00000_00002.npz", "hits_00003_00003.npz"):
        os.remove(tmp_path / name)
    _assert_same(finish[0]("stream_pairs_above", finish[1], 0.2, **kw), want)


@pytest.mark.parametrize("first", ("jax", "port"))
def test_topk_checkpoint_crosses_packages(tmp_path, monkeypatch, first):
    """A top-k checkpoint interrupted in one package is finished by the
    other; the result equals a fresh walk's."""
    bj, bt = _pair(random_bitmatrix(100, 600, 0.3, seed=96))
    kw = dict(superblock_rows=32, kernel="mxu", out_dir=str(tmp_path))
    want = _jax("stream_topk_neighbors", bj, 5, superblock_rows=32, kernel="mxu")
    if first == "jax":
        real = jsq._stripe_topk
        n = {"calls": 0}

        def crash(*a, **k):
            n["calls"] += 1
            if n["calls"] == 6:
                raise RuntimeError("simulated crash")
            return real(*a, **k)

        monkeypatch.setattr(jsq, "_stripe_topk", crash)
        with pytest.raises(RuntimeError):
            _jax("stream_topk_neighbors", bj, 5, **kw)
        got = _port("stream_topk_neighbors", bt, 5, **kw)
    else:
        # kernel "mxu" at k ≤ TOPK_EPI_MAX: each stripe through K2-topk
        _spy(monkeypatch, "_stripe_topk_sets", fail_at=6)
        with pytest.raises(RuntimeError):
            _port("stream_topk_neighbors", bt, 5, **kw)
        got = _jax("stream_topk_neighbors", bj, 5, **kw)
    with np.load(tmp_path / "topk_ckpt.npz") as z:
        assert int(z["next_i"]) == 4
    _check_topk(bj, got, want, 5)


# ---------------------------------------------------- pairwise-complete
def _complete_panel(n, m, seed, missing=0.12, plant=True):
    rng = np.random.default_rng(seed)
    observed = rng.random((n, m)) > missing
    values = (rng.random((n, m)) < 0.4) & observed
    if plant:
        values[9] = values[2] & observed[9]
    bd = JaxBitMatrix.from_dense(values.astype(np.uint8))
    bmk = JaxBitMatrix.from_dense(observed.astype(np.uint8))
    return (bd, bmk), (_pair(bd)[1], _pair(bmk)[1])


@pytest.mark.parametrize("kernel", KERNELS)
def test_stream_pairs_above_complete_equals_jax(kernel):
    (jd, jm), (td, tm) = _complete_panel(70, 800, seed=97)
    for measure, thr in (("r2", 0.05), ("jaccard", 0.25)):
        got = _port("stream_pairs_above_complete", td, tm, thr, measure=measure,
                    superblock_rows=32, kernel=kernel)
        _assert_same(got, _jax("stream_pairs_above_complete", jd, jm, thr, measure=measure,
                               superblock_rows=32, kernel=kernel))
        _assert_same(got, st.pairs_above_complete(td, tm, thr, measure=measure, device="cpu"))
        assert got[0].size
    with pytest.raises(ValueError, match="use stream_pairs_above"):
        tsq.stream_pairs_above_complete(td, tm, 1, measure="count", device="cpu")


def test_stream_complete_summary_skip_on_clustered_data():
    bd = block_diagonal_bitmatrix(64, 12800, 4, 0.35, seed=98)
    rng = np.random.default_rng(99)
    observed = (rng.random((64, 12800)) > 0.1) | np.asarray(bd.to_dense(), dtype=bool)
    bmk = JaxBitMatrix.from_dense(observed.astype(np.uint8))
    td, tm = _pair(bd)[1], _pair(bmk)[1]
    for measure, thr in (("jaccard", 0.2), ("phi", 0.2), ("r2", 0.3)):
        got = _port("stream_pairs_above_complete", td, tm, thr, measure=measure,
                    superblock_rows=16, kernel="dense")
        _assert_same(got, _jax("stream_pairs_above_complete", bd, bmk, thr, measure=measure,
                               superblock_rows=16, kernel="dense"))


def test_stream_complete_r2_mask_summary_skip(monkeypatch):
    """A block-diagonal mask aligned to the 4096-bit groups: of the ten
    stripes only the four diagonal ones are computed, and the hits equal
    the JAX package's."""
    rng = np.random.default_rng(101)
    n, m = 128, 4 * 4096
    observed = np.zeros((n, m), dtype=bool)
    for b in range(4):
        observed[b * 32:(b + 1) * 32, b * 4096:(b + 1) * 4096] = rng.random((32, 4096)) > 0.1
    values = (rng.random((n, m)) < 0.5) & observed
    values[1] = values[0] & observed[1]
    bd = JaxBitMatrix.from_dense(values.astype(np.uint8))
    bmk = JaxBitMatrix.from_dense(observed.astype(np.uint8))
    calls = _spy(monkeypatch, "_stripe_screen_complete")
    got = _port("stream_pairs_above_complete", _pair(bd)[1], _pair(bmk)[1], 0.3,
                measure="r2", superblock_rows=16, kernel="dense")
    assert calls["n"] == 4
    _assert_same(got, _jax("stream_pairs_above_complete", bd, bmk, 0.3, measure="r2",
                           superblock_rows=16, kernel="dense"))
    assert got[0].size


def test_stream_complete_resume(tmp_path, monkeypatch):
    (jd, jm), (td, tm) = _complete_panel(52, 700, seed=103, plant=False)
    kw = dict(measure="r2", superblock_rows=16, kernel="dense")
    want = _jax("stream_pairs_above_complete", jd, jm, 0.05, **kw)
    calls = _spy(monkeypatch, "_stripe_screen_complete")
    _assert_same(_port("stream_pairs_above_complete", td, tm, 0.05, out_dir=str(tmp_path),
                       **kw), want)
    assert calls["n"] > 0
    calls["n"] = 0
    _assert_same(_port("stream_pairs_above_complete", td, tm, 0.05, out_dir=str(tmp_path),
                       **kw), want)
    assert calls["n"] == 0
    rng = np.random.default_rng(104)
    obs2 = (rng.random((52, 700)) > 0.12) | jd.to_dense().astype(bool)
    tm2 = st.BitMatrix.from_dense(obs2.astype(np.uint8))
    with pytest.raises(ValueError, match="manifest"):
        _port("stream_pairs_above_complete", td, tm2, 0.05, out_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("first", ("jax", "port"))
def test_complete_directory_crosses_packages(tmp_path, first):
    (jd, jm), (td, tm) = _complete_panel(100, 700, seed=105)
    kw = dict(measure="r2", superblock_rows=32, kernel="mxu", out_dir=str(tmp_path))
    want = _jax("stream_pairs_above_complete", jd, jm, 0.05, measure="r2",
                superblock_rows=32, kernel="mxu")
    start, finish = ((_jax, jd, jm), (_port, td, tm))
    if first == "port":
        start, finish = finish, start
    _assert_same(start[0]("stream_pairs_above_complete", start[1], start[2], 0.05, **kw), want)
    os.remove(tmp_path / "chits_00001_00002.npz")
    _assert_same(finish[0]("stream_pairs_above_complete", finish[1], finish[2], 0.05, **kw),
                 want)
