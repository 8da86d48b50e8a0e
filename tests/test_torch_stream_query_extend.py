"""Panel growth of the streamed queries' directories in the port
(``extend_stream_pairs_above``, ``extend_stream_topk_neighbors``,
``extend_stream_pairs_above_complete``) against the JAX package's and
against a fresh walk of the grown panel, on the CPU: which stripes are
reused and which computed, the refusals, an interrupted extend, chained
growth, directories started by one package and extended by the other, and
the port's order of the screen's preparation (the new manifest written
before any stale hit file is deleted, so an interrupted preparation is
finished by calling extend again; the JAX package deletes first, a known
defect no test here builds on).

Counts and float64 values are compared exactly; top-k indices are
validated, never compared."""

import json
import os

import numpy as np
import pytest
import torch

import stormtpu.stream_query as jsq
import stormtpu_torch as st
import stormtpu_torch.stream_query as tsq
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu.oracle import oracle_count_matrix

FIELDS = dict(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)


def _cfg():
    return st.EngineConfig(**FIELDS)


def _jcfg():
    return JaxConfig(**FIELDS)


def _grown(n_old, n_new, m, density, seed):
    """(old port panel, new port panel, new JAX panel, dense)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n_new, m)) < density).astype(np.uint8)
    return (st.BitMatrix.from_dense(dense[:n_old]), st.BitMatrix.from_dense(dense),
            JaxBitMatrix.from_dense(dense), dense)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def _screen(bm, thr, out=None, **kw):
    kw.setdefault("kernel", "dense")
    return tsq.stream_pairs_above(bm, thr, superblock_rows=32, config=_cfg(), device="cpu",
                                  out_dir=out, **kw)


def _extend_screen(bm, out, kernel="dense"):
    return tsq.extend_stream_pairs_above(bm, out, kernel=kernel, config=_cfg(), device="cpu")


def _topk(bm, k, out=None, **kw):
    kw.setdefault("kernel", "dense")
    return tsq.stream_topk_neighbors(bm, k, superblock_rows=16, config=_cfg(), device="cpu",
                                     out_dir=out, **kw)


def _extend_topk(bm, out, kernel="dense"):
    return tsq.extend_stream_topk_neighbors(bm, out, kernel=kernel, config=_cfg(),
                                            device="cpu")


def _count_calls(monkeypatch, name, fail_at=None):
    real = getattr(tsq, name)
    calls = {"n": 0, "fail_at": fail_at}

    def wrapper(*a, **kw):
        calls["n"] += 1
        if calls["fail_at"] is not None and calls["n"] == calls["fail_at"]:
            raise RuntimeError("simulated crash")
        return real(*a, **kw)

    monkeypatch.setattr(tsq, name, wrapper)
    return calls


def _check_topk(bm, vals, idx, k):
    c = oracle_count_matrix(bm.packed).astype(np.int64)
    np.fill_diagonal(c, -1)
    assert np.array_equal(vals, np.maximum(-np.sort(-c, axis=1)[:, :k], 0))
    for r in range(bm.n):
        real = idx[r][vals[r] > 0]
        assert np.array_equal(c[r, real], vals[r][vals[r] > 0]) and r not in set(real.tolist())
        assert len(set(real.tolist())) == real.size


# ----------------------------------------------------------------- screen
def test_extend_screen_partial_superblock(tmp_path):
    """Past a partial old superblock: files wholly inside the old complete
    range are kept untouched, those touching the partial one recomputed;
    equal to a fresh walk and to the JAX package's extend of a copy."""
    bm_old, bm_new, bj_new, dense = _grown(72, 120, 600, 0.3, seed=121)
    out = str(tmp_path / "scr")
    _screen(bm_old, 30, out)
    kept = {(i, j): os.path.getmtime(os.path.join(out, f"hits_{i:05d}_{j:05d}.npz"))
            for i in range(3) for j in range(i, 3)}
    want = _screen(bm_new, 30)
    jout = str(tmp_path / "jax")
    jsq.stream_pairs_above(JaxBitMatrix.from_dense(dense[:72]), 30, superblock_rows=32,
                           kernel="dense", config=_jcfg(), interpret=True, out_dir=jout)
    _assert_same(jsq.extend_stream_pairs_above(bj_new, jout, kernel="dense", config=_jcfg(),
                                               interpret=True), want)
    _assert_same(_extend_screen(bm_new, out), want)
    for (i, j), t in kept.items():
        now = os.path.getmtime(os.path.join(out, f"hits_{i:05d}_{j:05d}.npz"))
        assert (now != t) == (i == 2 or j == 2), (i, j)
    with open(os.path.join(out, "screen_manifest.json")) as f:
        assert json.load(f) == tsq._screen_store_params(bm_new, 32, "dense", "count", 30)


def test_extend_screen_aligned_reuses_everything(tmp_path, monkeypatch):
    bm_old, bm_new, _, _ = _grown(64, 128, 600, 0.3, seed=122)
    out = str(tmp_path / "scr")
    _screen(bm_old, 30, out)
    calls = _count_calls(monkeypatch, "_stripe_screen")
    got = _extend_screen(bm_new, out)
    assert calls["n"] == 7  # 4 superblocks: 10 stripes, 3 wholly old
    _assert_same(got, _screen(bm_new, 30))


def test_extend_screen_measure_threshold_from_manifest(tmp_path):
    bm_old, bm_new, _, _ = _grown(64, 100, 600, 0.3, seed=123)
    out = str(tmp_path / "scr")
    _screen(bm_old, 0.22, out, measure="jaccard")
    _assert_same(_extend_screen(bm_new, out), _screen(bm_new, 0.22, measure="jaccard"))


def test_extend_screen_refusals(tmp_path):
    bm_old, bm_new, _, dense = _grown(72, 120, 600, 0.3, seed=124)
    out = str(tmp_path / "scr")
    _screen(bm_old, 30, out)
    tampered = dense.copy()
    tampered[3, :9] ^= 1
    with pytest.raises(ValueError, match="fingerprint"):
        _extend_screen(st.BitMatrix.from_dense(tampered), out)
    with pytest.raises(ValueError, match="appended"):
        _extend_screen(st.BitMatrix.from_dense(dense[:40]), out)
    with pytest.raises(ValueError, match="rounds superblock_rows to 96"):
        tsq.extend_stream_pairs_above(bm_new, out, kernel="dense", device="cpu",
                                      config=st.EngineConfig(**{**FIELDS, "k1_tile_rows": 24}))
    os.remove(os.path.join(out, "hits_00000_00001.npz"))
    with pytest.raises(ValueError, match="INCOMPLETE"):
        _extend_screen(bm_new, out)


def test_extend_screen_writes_manifest_before_purge(tmp_path, monkeypatch):
    """The new manifest is on disk before the first stale hit file is
    deleted."""
    bm_old, bm_new, _, _ = _grown(72, 120, 600, 0.3, seed=125)
    out = str(tmp_path / "scr")
    _screen(bm_old, 30, out)
    man = os.path.join(out, "screen_manifest.json")
    seen = []
    real_remove = os.remove

    def remove(path):
        with open(man) as f:
            seen.append((os.path.basename(path), json.load(f)))
        real_remove(path)

    monkeypatch.setattr(tsq.os, "remove", remove)
    got = _extend_screen(bm_new, out)
    monkeypatch.setattr(tsq.os, "remove", real_remove)
    assert [name for name, _ in seen] == ["hits_00000_00002.npz", "hits_00001_00002.npz",
                                          "hits_00002_00002.npz"]
    for _, m in seen:
        assert m["n"] == 120 and m["extend_from"] == 72
    _assert_same(got, _screen(bm_new, 30))
    with open(man) as f:
        assert "extend_from" not in json.load(f)


@pytest.mark.parametrize("crash", ("purge", "walk"))
def test_extend_screen_interrupted_is_finished_by_extend(tmp_path, monkeypatch, crash):
    """An extend cut during its purge or its walk is finished by calling
    extend again; a plain resume of the half-extended directory is
    refused."""
    bm_old, bm_new, _, _ = _grown(72, 150, 600, 0.3, seed=126)
    out = str(tmp_path / "scr")
    _screen(bm_old, 30, out)
    if crash == "purge":
        real_remove = os.remove
        n = {"calls": 0}

        def remove(path):
            n["calls"] += 1
            if n["calls"] == 2:
                raise OSError("simulated crash")
            real_remove(path)

        monkeypatch.setattr(tsq.os, "remove", remove)
        with pytest.raises(OSError):
            _extend_screen(bm_new, out)
        monkeypatch.setattr(tsq.os, "remove", real_remove)
    else:
        calls = _count_calls(monkeypatch, "_stripe_screen", fail_at=5)
        with pytest.raises(RuntimeError):
            _extend_screen(bm_new, out)
        calls["fail_at"] = None
    with pytest.raises(ValueError, match="manifest"):
        _screen(bm_new, 30, out)
    _assert_same(_extend_screen(bm_new, out), _screen(bm_new, 30))


@pytest.mark.parametrize("first", ("jax", "port"))
def test_extend_screen_crosses_packages(tmp_path, first):
    """A directory of one package is extended by the other."""
    bm_old, bm_new, bj_new, dense = _grown(72, 120, 600, 0.3, seed=127)
    out = str(tmp_path / "scr")
    want = _screen(bm_new, 0.2, measure="jaccard")
    if first == "jax":
        jsq.stream_pairs_above(JaxBitMatrix.from_dense(dense[:72]), 0.2, measure="jaccard",
                               superblock_rows=32, kernel="mxu", config=_jcfg(),
                               interpret=True, out_dir=out)
        got = _extend_screen(bm_new, out, kernel="mxu")
    else:
        _screen(bm_old, 0.2, out, measure="jaccard", kernel="mxu")
        got = jsq.extend_stream_pairs_above(bj_new, out, kernel="mxu", config=_jcfg(),
                                            interpret=True)
    _assert_same(got, want)


# ------------------------------------------------------------------- top-k
def test_extend_topk_partial_superblock(tmp_path, monkeypatch):
    """Old rows meet only new partners; stale padded partners are reset;
    the partial re-merge seats no partner twice."""
    bm_old, bm_new, bj_new, _ = _grown(40, 100, 600, 0.3, seed=125)
    out = str(tmp_path / "tk")
    _topk(bm_old, 5, out)
    calls = _count_calls(monkeypatch, "_stripe_topk")
    vals, idx = _extend_topk(bm_new, out)
    assert calls["n"] == 7 * 8 // 2 - 3  # 7 superblocks; 3 stripes wholly old
    _check_topk(bm_new, vals, idx, 5)
    want = jsq.stream_topk_neighbors(bj_new, 5, superblock_rows=16, kernel="dense",
                                     config=_jcfg(), interpret=True)
    assert np.array_equal(vals, want[0])


def test_extend_topk_aligned(tmp_path):
    bm_old, bm_new, _, _ = _grown(48, 96, 600, 0.35, seed=126)
    out = str(tmp_path / "tk")
    _topk(bm_old, 4, out)
    _check_topk(bm_new, *_extend_topk(bm_new, out), 4)


def test_extend_topk_measure(tmp_path):
    bm_old, bm_new, _, _ = _grown(48, 80, 600, 0.35, seed=127)
    out = str(tmp_path / "tk")
    _topk(bm_old, 3, out, measure="jaccard")
    vals, _ = _extend_topk(bm_new, out)
    assert np.array_equal(vals, _topk(bm_new, 3, measure="jaccard")[0])


def test_extend_topk_interrupted_extend_resumes(tmp_path, monkeypatch):
    bm_old, bm_new, _, _ = _grown(48, 112, 600, 0.3, seed=128)
    out = str(tmp_path / "tk")
    _topk(bm_old, 5, out)
    calls = _count_calls(monkeypatch, "_stripe_topk", fail_at=6)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _extend_topk(bm_new, out)
    with pytest.raises(ValueError, match="checkpoint"):
        _topk(bm_new, 5, out)
    calls["fail_at"] = None
    _check_topk(bm_new, *_extend_topk(bm_new, out), 5)


def test_extend_topk_refusals(tmp_path, monkeypatch):
    bm_old, bm_new, _, dense = _grown(40, 80, 600, 0.3, seed=129)
    out = str(tmp_path / "tk")
    calls = _count_calls(monkeypatch, "_stripe_topk", fail_at=4)
    with pytest.raises(RuntimeError):
        _topk(bm_old, 5, out)
    calls["fail_at"] = None
    with pytest.raises(ValueError, match="INCOMPLETE"):
        _extend_topk(bm_new, out)
    _topk(bm_old, 5, out)
    tampered = dense.copy()
    tampered[1, :7] ^= 1
    with pytest.raises(ValueError, match="fingerprint"):
        _extend_topk(st.BitMatrix.from_dense(tampered), out)
    with pytest.raises(ValueError, match="m_bits"):
        _extend_topk(st.BitMatrix.from_dense(np.pad(dense, ((0, 0), (0, 40)))), out)


@pytest.mark.parametrize("first", ("jax", "port"))
def test_extend_topk_crosses_packages(tmp_path, first):
    bm_old, bm_new, bj_new, dense = _grown(40, 100, 600, 0.3, seed=130)
    out = str(tmp_path / "tk")
    if first == "jax":
        jsq.stream_topk_neighbors(JaxBitMatrix.from_dense(dense[:40]), 5, superblock_rows=32,
                                  kernel="mxu", config=_jcfg(), interpret=True, out_dir=out)
        vals, idx = _extend_topk(bm_new, out, kernel="mxu")
    else:
        tsq.stream_topk_neighbors(bm_old, 5, superblock_rows=32, kernel="mxu",
                                  config=_cfg(), device="cpu", out_dir=out)
        vals, idx = jsq.extend_stream_topk_neighbors(bj_new, out, kernel="mxu",
                                                     config=_jcfg(), interpret=True)
    _check_topk(bm_new, vals, idx, 5)


# -------------------------------------------------------- complete screen
def _complete(n, m, seed):
    rng = np.random.default_rng(seed)
    observed = rng.random((n, m)) > 0.12
    values = (rng.random((n, m)) < 0.4) & observed
    return values, observed


def test_extend_complete_screen(tmp_path, monkeypatch):
    values, observed = _complete(112, 800, seed=131)
    n_old = 64
    out = str(tmp_path / "cs")
    kw = dict(kernel="dense", config=_cfg(), device="cpu")
    tsq.stream_pairs_above_complete(
        st.BitMatrix.from_dense(values[:n_old].astype(np.uint8)),
        st.BitMatrix.from_dense(observed[:n_old].astype(np.uint8)), 0.05, measure="r2",
        superblock_rows=32, out_dir=out, **kw)
    bd, bmk = (st.BitMatrix.from_dense(x.astype(np.uint8)) for x in (values, observed))
    calls = _count_calls(monkeypatch, "_stripe_screen_complete")
    got = tsq.extend_stream_pairs_above_complete(bd, bmk, out, **kw)
    assert calls["n"] == 7  # 4 superblocks of 32: 10 stripes, 3 wholly old
    want = tsq.stream_pairs_above_complete(bd, bmk, 0.05, measure="r2", superblock_rows=32,
                                           **kw)
    _assert_same(got, want)
    _assert_same(want, jsq.stream_pairs_above_complete(
        JaxBitMatrix.from_dense(values.astype(np.uint8)),
        JaxBitMatrix.from_dense(observed.astype(np.uint8)), 0.05, measure="r2",
        superblock_rows=32, kernel="dense", config=_jcfg(), interpret=True))
    tampered = observed.copy()
    tampered[2, :5] = ~tampered[2, :5]
    with pytest.raises(ValueError, match="fingerprint"):
        tsq.extend_stream_pairs_above_complete(
            st.BitMatrix.from_dense((values & tampered).astype(np.uint8)),
            st.BitMatrix.from_dense(tampered.astype(np.uint8)), out, **kw)


def test_extend_complete_partial_from_jax(tmp_path):
    """A JAX package directory over a partial superblock, extended by the
    port, with the manifest-first purge."""
    values, observed = _complete(120, 700, seed=132)
    out = str(tmp_path / "cs")
    jsq.stream_pairs_above_complete(
        JaxBitMatrix.from_dense(values[:72].astype(np.uint8)),
        JaxBitMatrix.from_dense(observed[:72].astype(np.uint8)), 0.1, measure="jaccard",
        superblock_rows=32, kernel="mxu", config=_jcfg(), interpret=True, out_dir=out)
    bd, bmk = (st.BitMatrix.from_dense(x.astype(np.uint8)) for x in (values, observed))
    got = tsq.extend_stream_pairs_above_complete(bd, bmk, out, kernel="mxu", config=_cfg(),
                                                 device="cpu")
    _assert_same(got, st.pairs_above_complete(bd, bmk, 0.1, measure="jaccard", device="cpu"))


# ----------------------------------------------------------- the merge
def _merge_oracle_vals(bv, bi, k, fill):
    """Per-partner maximum over real entries, ranked, fill-padded."""
    out = np.full((bv.shape[0], k), fill, dtype=bv.dtype)
    for r in range(bv.shape[0]):
        best = {}
        for v, i in zip(bv[r], bi[r]):
            real = (v >= 0) if bv.dtype.kind == "i" else np.isfinite(v)
            if real and (i not in best or v > best[i]):
                best[i] = v
        vals = sorted(best.values(), reverse=True)[:k]
        out[r, : len(vals)] = vals
    return out


def test_merge_topk_dedup_semantics_randomized():
    """The port's ``_merge_topk`` is the per-partner-maximum top-k, is
    idempotent, never seats a partner twice, and leaves the same state as
    the JAX package's under the same merges; so does the torch merge of
    the streamed top-k (``_merge_topk_torch``)."""
    rng = np.random.default_rng(314)
    for it in range(40):
        rows, k, npart = int(rng.integers(1, 9)), int(rng.integers(1, 6)), int(rng.integers(1, 8))
        intmode = bool(rng.integers(0, 2))
        fill = -1 if intmode else -np.inf
        dt = np.int64 if intmode else np.float64
        bv = np.full((rows, k), fill, dtype=dt)
        bi = np.zeros((rows, k), dtype=np.int32)
        jv, ji = bv.copy(), bi.copy()
        tv, ti = torch.from_numpy(bv.copy()), torch.from_numpy(bi.copy())
        seen_v, seen_i = [bv.copy()], [bi.copy()]
        for _ in range(int(rng.integers(1, 4))):
            width = int(rng.integers(1, 2 * k + 2))
            cv = rng.integers(0, 5, (rows, width)).astype(dt)
            ci = rng.integers(0, npart, (rows, width)).astype(np.int32)
            holes = rng.random((rows, width)) < 0.3
            cv, ci = np.where(holes, fill, cv), np.where(holes, 0, ci)
            for _ in range(2 if rng.random() < 0.5 else 1):
                tsq._merge_topk(bv, bi, slice(0, rows), cv, ci, k)
                jsq._merge_topk(jv, ji, slice(0, rows), cv, ci, k)
                tsq._merge_topk_torch(tv, ti, 0, torch.from_numpy(cv), torch.from_numpy(ci))
            seen_v.append(cv)
            seen_i.append(ci)
        want = _merge_oracle_vals(np.concatenate(seen_v, axis=1),
                                  np.concatenate(seen_i, axis=1), k, fill)
        assert np.array_equal(-np.sort(-bv, axis=1), want), it
        assert np.array_equal(bv, jv) and np.array_equal(bi, ji), it
        # the device merge keeps the same entries in the same order
        assert np.array_equal(tv.numpy(), bv) and np.array_equal(ti.numpy(), bi), it
        for r in range(rows):
            real = (bv[r] >= 0) if intmode else np.isfinite(bv[r])
            assert len(set(bi[r][real].tolist())) == int(real.sum()), (it, r)


def test_merge_topk_torch_without_the_partner_pass():
    """Where no candidate repeats a partner already kept (a walk that is
    not an extend; fill entries may repeat), the merge without the partner
    pass keeps the NumPy merge's entries in its order."""
    rng = np.random.default_rng(315)
    for it in range(30):
        rows, k = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        intmode = bool(rng.integers(0, 2))
        fill = -1 if intmode else -np.inf
        dt = np.int64 if intmode else np.float64
        bv = np.full((rows, k), fill, dtype=dt)
        bi = np.zeros((rows, k), dtype=np.int32)
        tv, ti = torch.from_numpy(bv.copy()), torch.from_numpy(bi.copy())
        first = 0
        for _ in range(int(rng.integers(1, 5))):
            width = int(rng.integers(1, 2 * k + 2))
            cv = rng.integers(0, 5, (rows, width)).astype(dt)
            ci = np.broadcast_to(np.arange(first, first + width, dtype=np.int32),
                                 (rows, width)).copy()
            first += width
            holes = rng.random((rows, width)) < 0.3
            cv, ci = np.where(holes, fill, cv), np.where(holes, 0, ci)
            tsq._merge_topk(bv, bi, slice(0, rows), cv, ci, k)
            tsq._merge_topk_torch(tv, ti, 0, torch.from_numpy(cv), torch.from_numpy(ci),
                                  dedup=False)
            assert np.array_equal(tv.numpy(), bv) and np.array_equal(ti.numpy(), bi), it


# ------------------------------------------------------- chained growth
def test_extend_chained_growth(tmp_path):
    rng = np.random.default_rng(151)
    dense = (rng.random((150, 600)) < 0.3).astype(np.uint8)
    bms = [st.BitMatrix.from_dense(dense[:n]) for n in (50, 100, 150)]
    sd, td = str(tmp_path / "scr"), str(tmp_path / "tk")
    _screen(bms[0], 30, sd)
    _topk(bms[0], 4, td)
    for bm in bms[1:]:
        got = _extend_screen(bm, sd)
        vals, idx = _extend_topk(bm, td)
    _assert_same(got, _screen(bms[-1], 30))
    _check_topk(bms[-1], vals, idx, 4)


@pytest.mark.heavy
def test_extend_randomized_sweep(tmp_path):
    """Random (n_old, n_new, measure, threshold): every extend equals a
    fresh walk."""
    rng = np.random.default_rng(161)
    for it in range(6):
        m = int(rng.integers(200, 900))
        n_old = int(rng.integers(20, 90))
        n_new = n_old + int(rng.integers(1, 80))
        density = float(10 ** rng.uniform(-1.5, -0.3))
        dense = (rng.random((n_new, m)) < density).astype(np.uint8)
        bm_old, bm_new = st.BitMatrix.from_dense(dense[:n_old]), st.BitMatrix.from_dense(dense)
        c = dense.astype(np.int64) @ dense.T
        measure = ["count", "jaccard", "r2"][it % 3]
        thr = (max(1, int(np.percentile(c[np.triu_indices(n_new, 1)], 85)))
               if measure == "count" else 0.15)
        sd = str(tmp_path / f"s{it}")
        _screen(bm_old, thr, sd, measure=measure)
        _assert_same(_extend_screen(bm_new, sd), _screen(bm_new, thr, measure=measure))
        k = int(rng.integers(1, 6))
        td = str(tmp_path / f"t{it}")
        _topk(bm_old, k, td)
        _check_topk(bm_new, *_extend_topk(bm_new, td), k)
