"""The port's streamed K4 walk (``stream_count_matrix(kernel="sparse_outer")``)
against the JAX package's on the CPU, on shared seeded inputs: the
per-superblock sub-COO, the stripe choice, the directory (manifest with its
``stripe_kernels`` split, stripe files and their members), resume, a
directory half written by one package and finished by the other,
``extend_streamed_matrix``, and ``auto`` resolving to the walk. Both
packages' cost constants are pinned to the same values, so that their
stripe choices compare; the JAX side runs its dense stripes as its own
tests run them (interpret mode). Counts are integers: every comparison is
exact (tolerance 0)."""

import json
import os

import jax
import numpy as np
import pytest

import stormtpu
import stormtpu.stream as js
import stormtpu_torch as st
import stormtpu_torch.kernels.mxu as tm
import stormtpu_torch.native as tn
import stormtpu_torch.stream as ts
from stormtpu import tuning as jtuning
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch import tuning as ttuning
from stormtpu_torch.oracle import oracle_count_matrix

# K2 tiles of 8 rows and 8 words: superblocks of 16 rows cross tile and
# superblock boundaries cheaply
FIELDS = dict(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=8, k2_tile_words=8)
SB = 16

# cost constants under which each stripe's choice is known
FORCE_K4 = dict(c_sort_s_per_nnz=0.0, c_n2_s_per_elem=0.0, c_emit_s_per_emission=0.0,
                k2_int8_ops_per_s=1.0, dispatch_floor_s=100.0, h2d_bytes_per_s=1e9)
FORCE_DENSE = dict(c_sort_s_per_nnz=1.0, c_n2_s_per_elem=1.0, c_emit_s_per_emission=1.0,
                   k2_int8_ops_per_s=1e30, dispatch_floor_s=0.0, h2d_bytes_per_s=1e30)
# the dense stripe costs 256·1024/1e12 + 1e-4 s (+ its j slice's upload off
# the diagonal): K4 wins a stripe of under about 360 emissions
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


def _configs():
    return JaxConfig(**FIELDS), st.EngineConfig(**FIELDS)


def _mixed_input(seed=73, n=48, m=1024):
    """An ultra-sparse panel whose first superblock is dense: its stripes
    take the dense walk, the rest K4."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m)) < 0.002).astype(np.uint8)
    dense[:SB] = rng.random((SB, m)) < 0.4
    return dense


def _positions_input(seed, n, m, density, dup=True):
    rng = np.random.default_rng(seed)
    k = max(1, int(n * m * density))
    rows, pos = rng.integers(0, n, k), rng.integers(0, m, k)
    if dup:
        rows, pos = np.r_[rows, rows[::5]], np.r_[pos, pos[::5]]
    return rows, pos


def _pair(kind, coo=True):
    """(JAX BitMatrix, port BitMatrix, constants) of a named walk."""
    if kind == "mixed":
        dense = _mixed_input()
        bj = stormtpu.BitMatrix.from_dense(dense)
        return bj, st.BitMatrix.from_packed(bj.packed, bj.m_bits), MIXED
    n, m, density, consts = {
        "all_k4": (60, 2048, 0.003, FORCE_K4),          # 60 → 64 rows: ragged
        "all_dense": (40, 1024, 0.005, FORCE_DENSE),
        "emission_path": (90, 8192, 0.0006, MIXED),     # tiny emissions: no sb² buffer
    }[kind]
    rows, pos = _positions_input(sum(map(ord, kind)), n, m, density)
    if kind == "all_k4":
        rows[rows >= 32] += 16 * (rows[rows >= 32] < 40)  # rows 32–47 stay empty
        rows = np.minimum(rows, n - 1)
    bj = stormtpu.BitMatrix.from_positions(rows, pos, n, m)
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    if not coo:
        bj = stormtpu.BitMatrix.from_packed(bj.packed, m)
        bt = st.BitMatrix.from_packed(bt.packed, m)
    return bj, bt, consts


def _walk(pkg, bm, out, **kw):
    jcfg, cfg = _configs()
    kw.setdefault("kernel", "sparse_outer")
    kw.setdefault("superblock_rows", SB)
    if pkg is js:
        return js.stream_count_matrix(bm, str(out), config=jcfg, interpret=True, **kw)
    return ts.stream_count_matrix(bm, str(out), config=cfg, device="cpu", **kw)


def _assert_same_directory(got_dir, want_dir):
    """Same manifest, same stripe files, same members (name, dtype, shape,
    values) in each."""
    with open(os.path.join(got_dir, "manifest.json")) as f:
        got_man = json.load(f)
    with open(os.path.join(want_dir, "manifest.json")) as f:
        want_man = json.load(f)
    assert got_man == want_man
    names = sorted(p for p in os.listdir(want_dir) if p.endswith(".npz"))
    assert sorted(p for p in os.listdir(got_dir) if p.endswith(".npz")) == names
    for name in names:
        with np.load(os.path.join(got_dir, name)) as g, np.load(os.path.join(want_dir, name)) as w:
            assert sorted(g.files) == sorted(w.files), name
            for member in w.files:
                assert g[member].dtype == w[member].dtype, (name, member)
                assert np.array_equal(g[member], w[member]), (name, member)


# --------------------------------------------------------- the walk's parts
@pytest.mark.parametrize("coo", (True, False), ids=("coo", "csr"))
@pytest.mark.parametrize("kind", ("all_k4", "mixed", "emission_path"))
def test_superblock_coo_equals_jax(kind, coo):
    bj, bt, _ = _pair(kind, coo)
    n_super = -(-bt.n // SB)
    got = ts._superblock_coo(bt, SB, n_super)
    want = js._superblock_coo(bj, SB, n_super)
    assert len(got) == len(want) == n_super
    for (gc, gr), (wc, wr) in zip(got, want):
        assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
        assert gr.dtype == wr.dtype == np.int32 and np.array_equal(gr, wr)


@pytest.mark.parametrize("kind", ("all_k4", "mixed", "emission_path"))
def test_stripe_plan_equals_jax(pin, kind):
    bj, bt, consts = _pair(kind)
    pin(consts)
    n_super = -(-bt.n // SB)
    got = ts._SparseStripePlan(bt, SB, n_super, device="cpu")
    want = js._SparseStripePlan(bj, SB, n_super)
    for i in range(n_super):
        for j in range(i, n_super):
            assert got.emissions(i, j) == want.emissions(i, j)
            assert got.emissions_square(i, j) == want.emissions_square(i, j)
            assert got.emission_eligible(i, j) == want.emission_eligible(i, j)
            assert (got.use_k4(i, j, emission_path=True)
                    == want.use_k4(i, j, emission_path=True))
            for g, w in zip(got.stripe_coo(i, j), want.stripe_coo(i, j)):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            dense = got.stripe_counts(i, j).numpy()
            assert np.array_equal(dense, want.stripe_counts(i, j))
            # the buffer-free emission equals the C++ stripe's nonzeros
            ci, cj, cv = got.stripe_coo(i, j)
            wi, wj = np.nonzero(dense)
            assert np.array_equal(ci, wi) and np.array_equal(cj, wj)
            assert np.array_equal(cv, dense[wi, wj])


# ------------------------------------------------------------- the walk
@pytest.mark.parametrize("compress", (False, True))
@pytest.mark.parametrize("kind", ("all_k4", "all_dense", "mixed", "emission_path"))
def test_sparse_outer_directory_equals_jax(tmp_path, pin, kind, compress):
    bj, bt, consts = _pair(kind)
    pin(consts)
    want = _walk(js, bj, tmp_path / "jax", compress=compress)
    got = _walk(ts, bt, tmp_path / "port", compress=compress)
    assert got == want and got["kernel"] == "sparse_outer"
    split = got["stripe_kernels"]
    total = got["n_super"] * (got["n_super"] + 1) // 2
    assert split["k4"] + split["dense"] == total
    assert {"all_k4": split["dense"] == 0, "all_dense": split["k4"] == 0,
            "mixed": split["k4"] > 0 and split["dense"] > 0,
            "emission_path": split["dense"] == 0}[kind]
    _assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))
    matrix = ts.load_streamed_matrix(str(tmp_path / "port"))
    assert np.array_equal(matrix, oracle_count_matrix(bt.packed))


def test_sparse_outer_without_the_coo_cache_equals_jax(tmp_path, pin):
    bj, bt, consts = _pair("mixed", coo=False)
    pin(consts)
    assert bt.coo is None
    want = _walk(js, bj, tmp_path / "jax")
    assert _walk(ts, bt, tmp_path / "port") == want
    _assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_dense_stripes_run_on_the_k2_walk_with_two_slices(tmp_path, pin, monkeypatch):
    """Above 2¹⁷ bits a dense stripe is K2's tile walk on one superblock
    slice (its diagonal) or on the two-slice buffer, never the matrix."""
    pin(MIXED)
    rng = np.random.default_rng(77)
    n, m, sb = 96, 4097 * 32, 32
    dense = (rng.random((n, m)) < 0.0002).astype(np.uint8)
    dense[: 2 * sb, :1024] = rng.random((2 * sb, 1024)) < 0.4
    bt = st.BitMatrix.from_dense(dense)
    tiles, loads = [], []
    real_tiles, real_load = tm.count_tiles_pallas_mxu, ts._SliceBuffer.load
    monkeypatch.setattr(tm, "count_tiles_pallas_mxu",
                        lambda *a, **k: tiles.append(a[0].shape) or real_tiles(*a, **k))
    monkeypatch.setattr(ts._SliceBuffer, "load",
                        lambda self, half, i: loads.append((half, i)) or real_load(self, half, i))
    cfg = st.EngineConfig(k2_tile_rows=32, k2_tile_words=8)
    man = ts.stream_count_matrix(bt, str(tmp_path), superblock_rows=sb, kernel="sparse_outer",
                                 config=cfg, device="cpu")
    split = man["stripe_kernels"]
    assert split["k4"] > 0 and split["dense"] == len(tiles) > 1
    assert set(tiles) == {(sb, 4104), (2 * sb, 4104)}  # a diagonal stripe and a pair
    assert loads[0] == (0, 0) and all(half in (0, 1) for half, _ in loads)
    assert np.array_equal(ts.load_streamed_matrix(str(tmp_path)), oracle_count_matrix(bt.packed))


def test_resume_accounts_the_stripes_on_disk(tmp_path, pin, monkeypatch):
    bj, bt, consts = _pair("mixed")
    pin(consts)
    out = str(tmp_path / "port")
    first = _walk(ts, bt, out)
    kinds = {}
    for i, j in first["completed"]:
        with np.load(ts.stripe_path(out, i, j)) as z:
            kinds[(i, j)] = "k4" if "coo_i" in z.files else "dense"
    gone = [next(s for s, k in kinds.items() if k == "k4"),
            next(s for s, k in kinds.items() if k == "dense")]
    for i, j in gone:
        os.remove(ts.stripe_path(out, i, j))
    calls, progress = [], []
    real = tm.count_tiles_pallas_mxu
    monkeypatch.setattr(tm, "count_tiles_pallas_mxu",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tn.reset_launches()
    again = _walk(ts, bt, out, progress=lambda d, t: progress.append((d, t)))
    assert again == first  # the split counts resumed stripes by their files
    assert len(progress) == 2
    _walk(js, bj, tmp_path / "jax")
    _assert_same_directory(out, str(tmp_path / "jax"))
    # a fully resumed walk computes nothing
    tn.reset_launches()
    progress.clear()
    assert _walk(ts, bt, out, progress=lambda d, t: progress.append(d)) == first
    assert progress == [] and tn.LAUNCHES == {"k4": 0}


@pytest.mark.parametrize("first", ("jax", "port"))
def test_directory_half_written_by_one_package_is_finished_by_the_other(tmp_path, pin, first):
    bj, bt, consts = _pair("mixed")
    pin(consts)
    whole = tmp_path / "whole"
    want = _walk(js, bj, whole)
    mixed = str(tmp_path / "mixed")
    (starter, bs), (finisher, bf) = ((js, bj), (ts, bt)) if first == "jax" else ((ts, bt), (js, bj))
    _walk(starter, bs, mixed)
    os.remove(os.path.join(mixed, "manifest.json"))
    stripes = sorted(p for p in os.listdir(mixed) if p.endswith(".npz"))
    for name in stripes[::2]:
        os.remove(os.path.join(mixed, name))
    man = _walk(finisher, bf, mixed)
    assert man == want
    _assert_same_directory(mixed, str(whole))
    assert np.array_equal(ts.load_streamed_matrix(mixed), oracle_count_matrix(bt.packed))


@pytest.mark.parametrize("first", ("jax", "port"))
def test_extend_sparse_outer_directory_equals_jax(tmp_path, pin, first):
    dense = _mixed_input(seed=75, n=56)
    bj_new = stormtpu.BitMatrix.from_dense(dense)
    bj_old = stormtpu.BitMatrix.from_dense(dense[:40])  # 40 rows: a partial superblock
    bt_new = st.BitMatrix.from_packed(bj_new.packed, bj_new.m_bits)
    bt_old = st.BitMatrix.from_packed(bj_old.packed, bj_old.m_bits)
    pin(MIXED)
    jcfg, cfg = _configs()
    ref, out = str(tmp_path / "ref"), str(tmp_path / "out")
    _walk(js, bj_old, ref)
    js.extend_streamed_matrix(bj_new, ref, kernel="sparse_outer", config=jcfg, interpret=True)
    if first == "jax":
        _walk(js, bj_old, out)
    else:
        _walk(ts, bt_old, out)
    man = ts.extend_streamed_matrix(bt_new, out, kernel="sparse_outer", config=cfg,
                                    device="cpu")
    assert man["n"] == 56 and man["kernel"] == "sparse_outer"
    _assert_same_directory(out, ref)
    assert np.array_equal(ts.load_streamed_matrix(out), oracle_count_matrix(bt_new.packed))


def test_auto_resolves_to_sparse_outer_as_jax(tmp_path, pin):
    pin(FORCE_K4)
    rows, pos = _positions_input(74, 48, 4096, 0.0005)
    bj = stormtpu.BitMatrix.from_positions(rows, pos, 48, 4096)
    bt = st.BitMatrix.from_positions(rows, pos, 48, 4096)
    assert bt.density < st.default_config().sparse_density_threshold
    want = _walk(js, bj, tmp_path / "jax", kernel="auto")
    got = _walk(ts, bt, tmp_path / "port", kernel="auto")
    assert got == want and got["kernel"] == "sparse_outer"
    _assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))
    # extend predicts the same resolution
    man = ts.extend_streamed_matrix(bt, str(tmp_path / "port"), config=_configs()[1],
                                    device="cpu")
    assert man["kernel"] == "sparse_outer"


def test_without_the_tier_auto_walks_dense_and_sparse_outer_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(tn, "_load", lambda: None)
    monkeypatch.setattr(tn, "_error", "RuntimeError: g++ exited 1: no compiler here")
    rows, pos = _positions_input(76, 24, 512, 0.0005)
    bt = st.BitMatrix.from_positions(rows, pos, 24, 512)
    assert _walk(ts, bt, tmp_path / "auto", kernel="auto")["kernel"] == "xla_int8"
    with pytest.raises(RuntimeError, match="native C\\+\\+ tier.*no compiler here"):
        _walk(ts, bt, tmp_path / "forced")
    assert not os.path.exists(tmp_path / "forced")
