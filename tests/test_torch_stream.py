"""The port's streaming walks (``stormtpu_torch.stream``) against the JAX
package's on the CPU: the stripe work list, the stripe assembly, every
stripe kernel with and without operand streaming (same manifest, same
members in every stripe file), resume, directories crossing between the two
packages in both directions, both checksum sinks, the histogram sink and
``extend_streamed_matrix``. The JAX side runs its Pallas kernels in
interpret mode; inputs are shared numpy arrays made from a seed; counts
are integers and every comparison is exact (tolerance 0)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.kernels.clustered as jc
import stormtpu.stream as js
import stormtpu_torch as st
import stormtpu_torch.kernels.clustered as tc
import stormtpu_torch.kernels.dense as td
import stormtpu_torch.kernels.mxu as tm
import stormtpu_torch.stream as ts
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu.native import HAVE_NATIVE
from stormtpu_torch.layout import from_reference, to_device_words
from stormtpu_torch.oracle import oracle_count_matrix
from stormtpu_torch.utils import assemble_stripe, assemble_stripe_torch, profiling, round_up

# small tiles, two a superblock side, so that the CPU shapes cross tile,
# superblock and K-step boundaries cheaply
DENSE = dict(k1_tile_rows=32, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)
CLUSTERED = dict(k2_tile_rows=32, k2_tile_words=128)
KERNELS = ("mxu", "dense", "xla_int8", "xla_popcount", "clustered")


def _configs(fields):
    return JaxConfig(**fields), from_reference(np.zeros((0, 1), np.uint32), 1,
                                               dataclasses.asdict(JaxConfig(**fields)))[1]


def _pair(dense):
    bj = stormtpu.BitMatrix.from_dense(dense)
    return bj, from_reference(bj.packed, dense.shape[1])[0]


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


def _block_diagonal(n, m, n_blocks, density, seed):
    """Row block b occupies only bit stripe b (the LD-panel shape)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, m), np.uint8)
    rows = np.linspace(0, n, n_blocks + 1).astype(int)
    cols = np.linspace(0, m, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        r0, r1, c0, c1 = rows[b], rows[b + 1], cols[b], cols[b + 1]
        dense[r0:r1, c0:c1] = rng.random((r1 - r0, c1 - c0)) < density
    return dense


def _case(kernel, seed=1):
    """(dense input, config fields, superblock rows) for a stripe kernel."""
    if kernel == "clustered":
        # three blocks over four tiles and four K-groups: the off-diagonal
        # stripes but (0, 3) have co-occupied cells
        return _block_diagonal(128, 16384, 3, 0.3, seed), CLUSTERED, 32
    return _uniform(130, 600, 0.3, seed), DENSE, 64


def _walk(pkg, bm, out, cfg, **kw):
    """One ``stream_count_matrix`` of either package on the CPU."""
    if pkg is js:
        return js.stream_count_matrix(bm, str(out), config=cfg, interpret=True, **kw)
    return ts.stream_count_matrix(bm, str(out), config=cfg, device="cpu", **kw)


def _assert_same_directory(got_dir, want_dir, ignore=()):
    """Same manifest (but for the keys in ``ignore``), same stripe files,
    same members (name, dtype, shape, values) in each."""
    with open(os.path.join(got_dir, "manifest.json")) as f:
        got_man = json.load(f)
    with open(os.path.join(want_dir, "manifest.json")) as f:
        want_man = json.load(f)
    for key in ignore:
        got_man.pop(key), want_man.pop(key)
    assert got_man == want_man
    names = sorted(p for p in os.listdir(want_dir) if p.endswith(".npz"))
    assert sorted(p for p in os.listdir(got_dir) if p.endswith(".npz")) == names
    assert len(names) == want_man["n_super"] * (want_man["n_super"] + 1) // 2
    for name in names:
        with np.load(os.path.join(got_dir, name)) as g, np.load(os.path.join(want_dir, name)) as w:
            assert sorted(g.files) == sorted(w.files), name
            for member in w.files:
                assert g[member].dtype == w[member].dtype, (name, member)
                assert g[member].shape == w[member].shape, (name, member)
                assert np.array_equal(g[member], w[member]), (name, member)


# ------------------------------------------------------------ the work list
WORKLIST_CASES = {
    "diagonal": (0, 0, True),
    "off_diagonal": (0, 2, False),
    "off_diagonal_sparse": (2, 4, False),
    "last_diagonal": (6, 6, True),
    "empty": (0, 6, False),
}


@pytest.mark.parametrize("name", sorted(WORKLIST_CASES))
def test_build_stripe_worklist_equals_jax(name):
    bj, bt = _pair(_block_diagonal(250, 16384, 4, 0.3, seed=2))
    jcfg, cfg = _configs(CLUSTERED)
    occ_j = jc._block_occupancy(bj, jcfg)[0]
    occ_t = tc._block_occupancy(bt, cfg)[0]
    assert np.array_equal(occ_t, occ_j)
    base_i, base_j, triangular = WORKLIST_CASES[name]
    want = jc.build_stripe_worklist(occ_j, base_i, base_j, 2, triangular)
    got = tc.build_stripe_worklist(occ_t, base_i, base_j, 2, triangular)
    if name == "empty":
        assert want is None and got is None
        return
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), field.name
        else:
            assert g == w, field.name
    assert got.ibs.size > got.n_work  # the bucket padding is part of the copy


def test_device_worklist_of_a_stripe_hands_over_real_items_in_the_local_frame():
    _, bt = _pair(_block_diagonal(250, 16384, 4, 0.3, seed=2))
    _, cfg = _configs(CLUSTERED)
    occ, ti, wk, _, nb, ng = tc._block_occupancy(bt, cfg)
    wl = tc.build_stripe_worklist(occ, 2, 4, 2, False)
    before = wl.ibs.copy(), wl.jbs.copy()
    with pytest.raises(ValueError, match="needs nb"):
        tc.device_worklist(wl, "cpu")
    work = tc.device_worklist(wl, "cpu", nb=4, ng=ng + 1, tile_rows=ti,
                              ibs_shift=2, jbs_shift=2)
    assert work.n_slots == wl.n_vis and work.nb == 4 and work.ng == ng + 1
    assert all(t.numel() == wl.n_work for t in work)
    assert np.array_equal(work.tensors[0].numpy(), wl.ibs[: wl.n_work] - 2)
    assert np.array_equal(work.tensors[1].numpy(), wl.jbs[: wl.n_work] - 2)
    # the stripe's own arrays are untouched
    assert np.array_equal(wl.ibs, before[0]) and np.array_equal(wl.jbs, before[1])
    # the check is made against the operand the list will run on: the global
    # ids do not fit a two-slice buffer of 4 row blocks
    with pytest.raises(ValueError, match="jbs"):
        tc.device_worklist(wl, "cpu", nb=4, ng=ng + 1, tile_rows=ti)


# -------------------------------------------------------------- the assembly
@pytest.mark.parametrize("case", ("diagonal", "off_diagonal", "visited_only", "empty"))
def test_assemble_stripe_torch_equals_jax(case):
    rng = np.random.default_rng(3)
    tps, ti = 3, 32
    if case == "diagonal":
        loc_i, loc_j = np.triu_indices(tps)
    else:
        loc_i, loc_j = (x.ravel() for x in np.meshgrid(np.arange(tps), np.arange(tps),
                                                       indexing="ij"))
    if case == "visited_only":
        keep = np.array([0, 4, 5, 7])
        loc_i, loc_j = loc_i[keep], loc_j[keep]
    if case == "empty":
        loc_i = loc_j = np.zeros(0, np.int64)
    loc_i, loc_j = loc_i.astype(np.int32), loc_j.astype(np.int32)
    tiles = rng.integers(0, 1 << 30, size=(loc_i.size, ti, ti)).astype(np.int32)
    diagonal = case == "diagonal"
    want = js._assemble_stripe(tiles, loc_i, loc_j, tps, ti, diagonal)
    got = assemble_stripe_torch(torch.from_numpy(tiles), loc_i, loc_j, tps, ti, diagonal)
    assert got.dtype == torch.int32 and got.shape == (tps * ti, tps * ti)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(assemble_stripe(tiles, loc_i, loc_j, tps, ti, diagonal), want)


def test_assemble_stripe_torch_mirrors_in_chunks(monkeypatch):
    from stormtpu_torch.utils import tiling

    monkeypatch.setattr(tiling, "MIRROR_CHUNK_TILES", 4)
    rng = np.random.default_rng(4)
    tps, ti = 5, 8
    loc_i, loc_j = (x.astype(np.int32) for x in np.triu_indices(tps))
    tiles = rng.integers(0, 1 << 30, size=(loc_i.size, ti, ti)).astype(np.int32)
    got = assemble_stripe_torch(torch.from_numpy(tiles), loc_i, loc_j, tps, ti, True)
    assert np.array_equal(got.numpy(), js._assemble_stripe(tiles, loc_i, loc_j, tps, ti, True))
    with pytest.raises(ValueError):
        assemble_stripe_torch(torch.from_numpy(tiles), loc_i[:-1], loc_j, tps, ti, True)


# ---------------------------------------------------------- the stripe walk
@pytest.mark.parametrize("operand_streaming", (False, True), ids=("resident", "streaming"))
@pytest.mark.parametrize("kernel", KERNELS)
def test_stream_directory_equals_jax(tmp_path, kernel, operand_streaming):
    dense, fields, sb = _case(kernel)
    bj, bt = _pair(dense)
    jcfg, cfg = _configs(fields)
    kw = dict(superblock_rows=sb, kernel=kernel, operand_streaming=operand_streaming)
    want_man = _walk(js, bj, tmp_path / "jax", jcfg, **kw)
    got_man = _walk(ts, bt, tmp_path / "port", cfg, **kw)
    assert got_man == want_man
    assert got_man["operand_streaming"] is operand_streaming and got_man["kernel"] == kernel
    _assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))
    got = ts.load_streamed_matrix(str(tmp_path / "port"))
    assert got.dtype == np.int32
    assert np.array_equal(got, js.load_streamed_matrix(str(tmp_path / "jax")))
    assert np.array_equal(got, oracle_count_matrix(bj.packed))
    if kernel == "clustered":
        assert got_man["work_items"] > 0
        with np.load(ts.stripe_path(str(tmp_path / "port"), 0, 3)) as z:
            assert z["tiles"].shape == (0, 32, 32)  # a summary-zero stripe


@pytest.mark.parametrize("compress", (False, True))
def test_stream_auto_resolves_as_jax_and_compress_changes_no_value(tmp_path, compress):
    for name, dense, fields, sb, expect in (
            ("small_m", _uniform(70, 600, 0.3, 5), DENSE, 64, "xla_int8"),
            ("clustered", _block_diagonal(128, 16384, 4, 0.3, 6), CLUSTERED, 64, "clustered")):
        bj, bt = _pair(dense)
        jcfg, cfg = _configs(fields)
        kw = dict(superblock_rows=sb, kernel="auto", compress=compress)
        want = _walk(js, bj, tmp_path / f"jax_{name}", jcfg, **kw)
        got = _walk(ts, bt, tmp_path / f"port_{name}", cfg, **kw)
        assert got == want and got["kernel"] == expect
        _assert_same_directory(str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}"))


def test_stream_clustered_single_k_group_falls_to_the_dense_walk(tmp_path):
    bj, bt = _pair(_uniform(70, 2048, 0.3, seed=7))
    jcfg, cfg = _configs(CLUSTERED)
    want = _walk(js, bj, tmp_path / "jax", jcfg, superblock_rows=32, kernel="clustered")
    got = _walk(ts, bt, tmp_path / "port", cfg, superblock_rows=32, kernel="clustered")
    assert got == want and got["kernel"] == "mxu" and "tile_rows" not in got
    _assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_stream_operand_streaming_follows_the_budget(tmp_path, monkeypatch):
    _, bt = _pair(_uniform(70, 600, 0.3, seed=8))
    _, cfg = _configs(DENSE)
    monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1024")
    man = _walk(ts, bt, tmp_path / "streamed", cfg, superblock_rows=32)
    assert man["operand_streaming"] is True
    assert np.array_equal(ts.load_streamed_matrix(str(tmp_path / "streamed")),
                          oracle_count_matrix(bt.packed))
    monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", str(1 << 40))
    assert _walk(ts, bt, tmp_path / "res", cfg, superblock_rows=32)["operand_streaming"] is False
    monkeypatch.delenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES")
    # without the override: the operand and a stripe's working set against
    # what the device reports
    operand, working = 4 * 96 * 24, 4 * (2 * 32 * 32 + 2 * 32 * 24)
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(operand + working))
    assert _walk(ts, bt, tmp_path / "fits", cfg, superblock_rows=32)["operand_streaming"] is False
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(operand + working - 1))
    assert _walk(ts, bt, tmp_path / "not", cfg, superblock_rows=32)["operand_streaming"] is True


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("operand_streaming", (False, True), ids=("resident", "streaming"))
@pytest.mark.parametrize("kernel", ("mxu", "dense", "clustered"))
def test_resume_runs_only_the_missing_stripes(tmp_path, monkeypatch, kernel, operand_streaming):
    dense, fields, sb = _case(kernel, seed=9)
    _, bt = _pair(dense)
    _, cfg = _configs(fields)
    out = str(tmp_path)
    kw = dict(superblock_rows=sb, kernel=kernel, operand_streaming=operand_streaming)
    first = _walk(ts, bt, out, cfg, **kw)
    module, name = {"mxu": (tm, "count_tiles_pallas_mxu"),
                    "dense": (td, "count_tiles_pallas_dense"),
                    "clustered": (tc, "count_tiles_worklist")}[kernel]
    calls = _count_calls(monkeypatch, module, name)
    uploads = _count_calls(monkeypatch, ts._SliceBuffer, "load")
    progress = []
    resumed = _walk(ts, bt, out, cfg, progress=lambda d, t: progress.append(d), **kw)
    # work_items counts the items this run computed, as in the JAX package
    assert resumed == (dict(first, work_items=0) if kernel == "clustered" else first)
    assert calls == [] and progress == [] and uploads == []  # fully resumed: nothing runs
    missing = [(0, 0), (0, 1)] if kernel == "clustered" else [(0, 1), (1, 2)]
    for i, j in missing:
        os.remove(ts.stripe_path(out, i, j))
    again = _walk(ts, bt, out, cfg, progress=lambda d, t: progress.append((d, t)), **kw)
    assert len(calls) == 2 and len(progress) == 2
    total = first["n_super"] * (first["n_super"] + 1) // 2
    assert all(t == total for _, t in progress)  # done counts the resumed stripes too
    assert sorted(map(tuple, again["completed"])) == sorted(map(tuple, first["completed"]))
    assert np.array_equal(ts.load_streamed_matrix(out), oracle_count_matrix(bt.packed))
    assert not [p for p in os.listdir(out) if p.endswith(".tmp.npz")]


def test_resume_false_recomputes_every_stripe(tmp_path, monkeypatch):
    dense, fields, sb = _case("mxu", seed=10)
    _, bt = _pair(dense)
    _, cfg = _configs(fields)
    _walk(ts, bt, tmp_path, cfg, superblock_rows=sb)
    calls = _count_calls(monkeypatch, tm, "count_tiles_pallas_mxu")
    _walk(ts, bt, tmp_path, cfg, superblock_rows=sb, resume=False)
    assert len(calls) == 6


# ------------------------------------------------------- crossing packages
@pytest.mark.parametrize("kernel", ("mxu", "dense", "clustered"))
@pytest.mark.parametrize("first", ("jax", "port"))
def test_directory_half_written_by_one_package_is_finished_by_the_other(tmp_path, first, kernel):
    dense, fields, sb = _case(kernel, seed=11)
    bj, bt = _pair(dense)
    jcfg, cfg = _configs(fields)
    kw = dict(superblock_rows=sb, kernel=kernel)
    whole = tmp_path / "whole"
    want_man = _walk(js, bj, whole, jcfg, **kw)
    mixed = str(tmp_path / "mixed")
    starter, finisher = ((js, bj, jcfg), (ts, bt, cfg)) if first == "jax" else (
        (ts, bt, cfg), (js, bj, jcfg))
    _walk(starter[0], starter[1], mixed, starter[2], **kw)
    # a run cut half way: the manifest not yet written, every other stripe missing
    os.remove(os.path.join(mixed, "manifest.json"))
    stripes = sorted(p for p in os.listdir(mixed) if p.endswith(".npz"))
    for name in stripes[::2]:
        os.remove(os.path.join(mixed, name))
    done = []
    man = _walk(finisher[0], finisher[1], mixed, finisher[2],
                progress=lambda d, t: done.append(d), **kw)
    assert len(done) == len(stripes[::2])
    assert sorted(map(tuple, man["completed"])) == sorted(map(tuple, want_man["completed"]))
    # work_items counts what the finishing run computed
    _assert_same_directory(mixed, str(whole), ignore=("work_items",) * (kernel == "clustered"))
    if kernel == "clustered":
        assert 0 < man["work_items"] < want_man["work_items"]
    want = oracle_count_matrix(bj.packed)
    assert np.array_equal(ts.load_streamed_matrix(mixed), want)
    assert np.array_equal(js.load_streamed_matrix(mixed), want)


@pytest.mark.parametrize("first", ("jax", "port"))
def test_directory_of_one_package_is_extended_by_the_other(tmp_path, first):
    dense = _uniform(130, 600, 0.3, seed=12)
    bj_old, bt_old = _pair(dense[:70])
    bj_new, bt_new = _pair(dense)
    jcfg, cfg = _configs(DENSE)
    out = str(tmp_path)
    if first == "jax":
        _walk(js, bj_old, out, jcfg, superblock_rows=32)
        man = ts.extend_streamed_matrix(bt_new, out, kernel="mxu", config=cfg, device="cpu")
    else:
        _walk(ts, bt_old, out, cfg, superblock_rows=32)
        man = js.extend_streamed_matrix(bj_new, out, kernel="mxu", config=jcfg, interpret=True)
    assert man["n"] == 130 and man["n_super"] == 5
    want = oracle_count_matrix(bj_new.packed)
    assert np.array_equal(ts.load_streamed_matrix(out), want)
    assert np.array_equal(js.load_streamed_matrix(out), want)


def test_coo_directory_of_the_jax_package_loads(tmp_path):
    """The ``sparse_outer`` walk is not ported, its stripe format is: a
    directory the JAX package wrote must load."""
    rng = np.random.default_rng(13)
    dense = np.zeros((90, 8192), np.uint8)
    dense[rng.integers(0, 90, 300), rng.integers(0, 8192, 300)] = 1
    bj, bt = _pair(dense)
    jcfg, _ = _configs(DENSE)
    out = str(tmp_path)
    want = oracle_count_matrix(bj.packed)
    if HAVE_NATIVE:
        man = js.stream_count_matrix(bj, out, superblock_rows=32, kernel="sparse_outer",
                                     config=jcfg, compress=False)
        assert man["kernel"] == "sparse_outer"
    else:  # the same files, written as that walk writes them
        pad = np.zeros((96, 96), np.int32)
        pad[:90, :90] = want
        for i in range(3):
            for j in range(i, 3):
                ci, cj = np.nonzero(pad[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32])
                np.savez(ts.stripe_path(out, i, j), coo_i=ci.astype(np.int32),
                         coo_j=cj.astype(np.int32),
                         coo_v=pad[i * 32 + ci, j * 32 + cj], i=i, j=j)
        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump({"n": 90, "m_bits": 8192, "superblock_rows": 32, "n_super": 3,
                       "kernel": "sparse_outer"}, f)
    with np.load(ts.stripe_path(out, 0, 0)) as z:
        assert "coo_v" in z.files
    assert np.array_equal(ts.load_streamed_matrix(out), want)
    assert np.array_equal(ts.load_streamed_matrix(out), js.load_streamed_matrix(out))


# ----------------------------------------------------------- checksum sinks
def _padded(bm, rows, word_mult):
    xp = np.zeros((rows, round_up(bm.n_words, word_mult)), np.uint32)
    xp[: bm.n, : bm.n_words] = bm.packed
    return xp


def _assert_same_checksum_manifest(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key
        else:
            assert got[key] == w, key


def _assert_samples_exact(man, packed):
    n_pad = man["n_super"] * man["superblock_rows"]
    pad = np.zeros((n_pad, n_pad), np.int64)
    pad[: packed.shape[0], : packed.shape[0]] = oracle_count_matrix(packed)
    assert np.array_equal(man["sample_vals"], pad[man["sample_ii"], man["sample_jj"]])


@pytest.mark.parametrize("n,sb,pad_to", [
    (130, 64, 192),     # two tiles a superblock side, three superblocks
    (100, 32, 128),     # one tile a superblock
    (20, 4096, 4096),   # n below the tile rows: the tile shrinks and xd is re-padded
])
def test_stream_count_checksums_equals_jax(n, sb, pad_to):
    bj, bt = _pair(_uniform(n, 600, 0.3, seed=n))
    jcfg, cfg = _configs(DENSE if n > 32 else dict(k2_tile_rows=64, k2_tile_words=8))
    xp = _padded(bt, pad_to, 8)
    kw = dict(superblock_rows=sb, samples_per_stripe=5, sample_seed=3)
    want = js.stream_count_checksums(jnp.asarray(xp), n, 600, config=jcfg, interpret=True, **kw)
    got = ts.stream_count_checksums(xp, n, 600, config=cfg, device="cpu", **kw)
    _assert_same_checksum_manifest(got, want)
    _assert_samples_exact(got, bt.packed)
    # a tensor on the device is taken as it is
    again = ts.stream_count_checksums(to_device_words(xp, "cpu"), n, 600, config=cfg,
                                      device="cpu", **kw)
    _assert_same_checksum_manifest(again, want)


@pytest.mark.parametrize("n,blocks,sb", [(128, 4, 32), (250, 4, 64), (100, 2, 128)])
def test_stream_count_checksums_clustered_equals_jax_and_the_dense_sink(n, blocks, sb):
    bj, bt = _pair(_block_diagonal(n, 16384, blocks, 0.3, seed=n))
    jcfg, cfg = _configs(CLUSTERED)
    kw = dict(superblock_rows=sb, samples_per_stripe=6, sample_seed=1)
    want = js.stream_count_checksums_clustered(bj, config=jcfg, interpret=True, **kw)
    got = ts.stream_count_checksums_clustered(bt, config=cfg, device="cpu", **kw)
    _assert_same_checksum_manifest(got, want)
    _assert_samples_exact(got, bt.packed)
    assert any(rec["skipped"] for rec in got["stripes"]) == (blocks == 4)
    assert all(rec["checksum"] == 0 for rec in got["stripes"] if rec["skipped"])
    xp = _padded(bt, got["n_super"] * got["superblock_rows"], 128)
    dense = ts.stream_count_checksums(xp, n, 16384, superblock_rows=sb, config=cfg, device="cpu")
    assert ({(r["i"], r["j"]): r["checksum"] for r in got["stripes"]}
            == {(r["i"], r["j"]): r["checksum"] for r in dense["stripes"]})


def test_checksum_sinks_agree_below_tile_rows():
    """n below ``k2_tile_rows`` shrinks the tile; both sinks must list the
    same tiles, or the diagonal stripes' checksums differ."""
    _, bt = _pair(_block_diagonal(60, 16384, 2, 0.3, seed=21))
    _, cfg = _configs(dict(k2_tile_rows=256, k2_tile_words=128))
    clustered = ts.stream_count_checksums_clustered(bt, superblock_rows=64, config=cfg,
                                                    device="cpu")
    assert clustered["superblock_rows"] == 64  # tile rows 64, not 256
    dense = ts.stream_count_checksums(_padded(bt, 64, 128), 60, 16384, superblock_rows=64,
                                      config=cfg, device="cpu")
    assert ([r["checksum"] for r in clustered["stripes"]]
            == [r["checksum"] for r in dense["stripes"]])
    _assert_samples_exact(dense, bt.packed)


def test_clustered_checksum_sink_needs_two_k_groups():
    bj, bt = _pair(_uniform(40, 2048, 0.3, seed=22))
    jcfg, cfg = _configs(CLUSTERED)
    with pytest.raises(ValueError, match="K-groups"):
        js.stream_count_checksums_clustered(bj, config=jcfg, interpret=True)
    with pytest.raises(ValueError, match="K-groups"):
        ts.stream_count_checksums_clustered(bt, config=cfg, device="cpu")


def test_checksum_wraps_as_int32_addition_does():
    """An off-diagonal stripe at superblock 4096 can sum past 2³¹; the JAX
    package sums in int32. A made-up tile stack shows the wrap."""
    tiles = np.full((133, 256, 256), 250 + 251 * 3, np.int32)  # every entry ≡ 250
    tiles[0, 0, :7] = 17
    want = int(np.sum(tiles % np.int32(251), dtype=np.int32))
    assert want < 0 < int(np.sum(tiles % 251, dtype=np.int64))  # it does wrap
    idx = np.zeros(3, np.int32)
    chk, vals = ts._checksum_and_samples(torch.from_numpy(tiles), idx, idx, idx + 2)
    assert chk == want
    assert vals.dtype == np.int32 and np.array_equal(vals, [17, 17, 17])
    assert ts._wrap_int32(2**31) == -(2**31) and ts._wrap_int32(2**31 - 1) == 2**31 - 1
    assert ts._wrap_int32(-(2**31) - 1) == 2**31 - 1 and ts._wrap_int32(5) == 5


def test_sinks_refuse_a_misshapen_operand():
    _, cfg = _configs(DENSE)
    with pytest.raises(ValueError, match="word-padded"):
        ts.stream_count_checksums(np.zeros((64, 7), np.uint32), 40, 200, superblock_rows=32,
                                  config=cfg, device="cpu")
    with pytest.raises(TypeError):
        ts.stream_count_checksums(torch.zeros((64, 8)), 40, 200, superblock_rows=32,
                                  config=cfg, device="cpu")
    with pytest.raises(ValueError, match="word-padded"):
        ts.stream_count_histogram(np.zeros((64, 7), np.uint32), 40, 200, superblock_rows=32,
                                  config=cfg, device="cpu")


# ------------------------------------------------------------ the histogram
@pytest.mark.parametrize("n_bins,bin_width", [(64, None), (16, 3), (1, None), (7, 1)])
@pytest.mark.parametrize("n,sb,pad_to", [(130, 64, 192), (20, 4096, 4096)])
def test_stream_count_histogram_equals_jax(n, sb, pad_to, n_bins, bin_width):
    bj, bt = _pair(_uniform(n, 600, 0.3, seed=n + 1))
    jcfg, cfg = _configs(DENSE if n > 32 else dict(k2_tile_rows=64, k2_tile_words=8))
    xp = _padded(bt, pad_to, 8)
    kw = dict(n_bins=n_bins, bin_width=bin_width, superblock_rows=sb)
    want = js.stream_count_histogram(jnp.asarray(xp), n, 600, config=jcfg, interpret=True, **kw)
    got = ts.stream_count_histogram(xp, n, 600, config=cfg, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert np.array_equal(got[key], w), key
    assert got["hist"].dtype == want["hist"].dtype == np.int64
    counts = oracle_count_matrix(bt.packed)[np.triu_indices(n, 1)]
    oracle = np.bincount(np.minimum(counts // got["bin_width"], n_bins - 1), minlength=n_bins)
    assert np.array_equal(got["hist"], oracle)


def test_stream_count_histogram_occupancy_skip_equals_jax():
    dense = _block_diagonal(128, 16384, 4, 0.3, seed=31)
    bj, bt = _pair(dense)
    jcfg, cfg = _configs(CLUSTERED)
    xp = _padded(bt, 128, 128)
    # per-superblock K-group summary at superblock 32: the tile blocks' own
    occupancy = tc._block_occupancy(bt, cfg)[0]
    assert occupancy.shape[0] == 4
    skipped = sum(not (occupancy[i] & occupancy[j]).any() for i in range(4) for j in range(i, 4))
    assert skipped > 0
    kw = dict(n_bins=32, superblock_rows=32, occupancy=occupancy)
    want = js.stream_count_histogram(jnp.asarray(xp), 128, 16384, config=jcfg, interpret=True, **kw)
    done = []
    got = ts.stream_count_histogram(xp, 128, 16384, config=cfg, device="cpu",
                                    progress=lambda d, t: done.append((d, t)), **kw)
    assert np.array_equal(got["hist"], want["hist"]) and got["pairs"] == 128 * 127 // 2
    assert done == [(k + 1, 10) for k in range(10)]
    plain = ts.stream_count_histogram(xp, 128, 16384, n_bins=32, superblock_rows=32,
                                      config=cfg, device="cpu")
    assert np.array_equal(got["hist"], plain["hist"])


def test_stream_count_histogram_refusals():
    _, cfg = _configs(DENSE)
    xp = np.zeros((64, 8), np.uint32)
    kw = dict(superblock_rows=32, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="n_bins"):
        ts.stream_count_histogram(xp, 40, 200, n_bins=0, **kw)
    with pytest.raises(ValueError, match="bin_width"):
        ts.stream_count_histogram(xp, 40, 200, bin_width=0, **kw)
    with pytest.raises(ValueError, match="occupancy"):
        ts.stream_count_histogram(xp, 40, 200, occupancy=np.ones((3, 1), bool), **kw)
    assert ts.default_hist_bin_width(600, 64) == js.default_hist_bin_width(600, 64)
    assert ts.cap_hist_superblock(1 << 20, 256) == js.cap_hist_superblock(1 << 20, 256)
    with pytest.raises(ValueError):
        ts.cap_hist_superblock(4096, 1 << 16)


# ------------------------------------------------------------------- extend
@pytest.mark.parametrize("old_n,partial", [(70, True), (64, False)])
def test_extend_streamed_matrix_equals_jax(tmp_path, monkeypatch, old_n, partial):
    dense = _uniform(130, 600, 0.3, seed=41)
    bj_old, bt_old = _pair(dense[:old_n])
    bj_new, bt_new = _pair(dense)
    jcfg, cfg = _configs(DENSE)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _walk(js, bj_old, jdir, jcfg, superblock_rows=32)
    _walk(ts, bt_old, pdir, cfg, superblock_rows=32)
    n_old = 3 if partial else 2
    kept = {(i, j): os.path.getmtime(ts.stripe_path(pdir, i, j))
            for i in range(n_old) for j in range(i, n_old)}
    want = js.extend_streamed_matrix(bj_new, jdir, kernel="mxu", config=jcfg, interpret=True)
    calls = _count_calls(monkeypatch, tm, "count_tiles_pallas_mxu")
    got = ts.extend_streamed_matrix(bt_new, pdir, kernel="mxu", config=cfg, device="cpu")
    assert got == want and got["n"] == 130 and got["superblock_rows"] == 32
    _assert_same_directory(pdir, jdir)
    assert np.array_equal(ts.load_streamed_matrix(pdir), oracle_count_matrix(bt_new.packed))
    stale = {(i, j) for (i, j) in kept if partial and 2 in (i, j)}
    assert len(calls) == 15 - len(kept) + len(stale)
    for (i, j), t in kept.items():
        same = os.path.getmtime(ts.stripe_path(pdir, i, j)) == t
        assert same == ((i, j) not in stale), (i, j)


def test_extend_with_auto_resolves_as_the_walk_does(tmp_path):
    dense = _uniform(100, 600, 0.3, seed=42)
    bj_old, bt_old = _pair(dense[:40])
    bj_new, bt_new = _pair(dense)
    jcfg, cfg = _configs(DENSE)
    _walk(js, bj_old, tmp_path / "jax", jcfg, superblock_rows=32)
    _walk(ts, bt_old, tmp_path / "port", cfg, superblock_rows=32)
    want = js.extend_streamed_matrix(bj_new, str(tmp_path / "jax"), config=jcfg, interpret=True)
    got = ts.extend_streamed_matrix(bt_new, str(tmp_path / "port"), config=cfg, device="cpu")
    assert got == want and got["kernel"] == "xla_int8"
    _assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))


REFUSALS = {
    "fingerprint": "fingerprint",
    "shrink": "appended",
    "m_bits": "m_bits",
    "modulus": "tile geometry",
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_extend_streamed_matrix_refusals(tmp_path, what):
    dense = _uniform(70, 600, 0.3, seed=43)
    _, bt_old = _pair(dense[:36])
    _, cfg = _configs(DENSE)
    out = str(tmp_path)
    _walk(ts, bt_old, out, cfg, superblock_rows=32)
    bm, kw = _pair(dense)[1], dict(kernel="mxu", config=cfg)
    if what == "fingerprint":
        tampered = dense.copy()
        tampered[3, :9] ^= 1
        bm = _pair(tampered)[1]
    elif what == "shrink":
        bm = _pair(dense[:20])[1]
    elif what == "m_bits":
        bm = _pair(np.zeros((70, 601), np.uint8))[1]
    else:
        kw["config"] = _configs(dict(DENSE, k2_tile_rows=64))[1]
    before = sorted(os.listdir(out))
    with pytest.raises(ValueError, match=REFUSALS[what]):
        ts.extend_streamed_matrix(bm, out, device="cpu", **kw)
    assert sorted(os.listdir(out)) == before  # a refusal deletes nothing


def test_extend_clustered_to_mxu_carries_tile_rows(tmp_path):
    dense = _block_diagonal(128, 16384, 4, 0.3, seed=44)
    bj_old, bt_old = _pair(dense[:96])
    bj_new, bt_new = _pair(dense)
    jcfg, cfg = _configs(CLUSTERED)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _walk(js, bj_old, jdir, jcfg, superblock_rows=32, kernel="clustered")
    man0 = _walk(ts, bt_old, pdir, cfg, superblock_rows=32, kernel="clustered")
    assert man0["kernel"] == "clustered" and man0["tile_rows"] == 32
    want = js.extend_streamed_matrix(bj_new, jdir, kernel="mxu", config=jcfg, interpret=True)
    got = ts.extend_streamed_matrix(bt_new, pdir, kernel="mxu", config=cfg, device="cpu")
    assert got == want and got["kernel"] == "mxu" and got["tile_rows"] == 32
    _assert_same_directory(pdir, jdir)
    assert np.array_equal(ts.load_streamed_matrix(pdir), oracle_count_matrix(bt_new.packed))


def test_extend_clustered_tile_rows_drift_refused(tmp_path):
    dense = _block_diagonal(128, 16384, 4, 0.3, seed=45)
    _, bt_old = _pair(dense[:96])
    _, bt_new = _pair(dense)
    _, cfg = _configs(CLUSTERED)
    _walk(ts, bt_old, tmp_path, cfg, superblock_rows=64, kernel="clustered")
    drifted = _configs(dict(k2_tile_rows=64, k2_tile_words=128))[1]
    with pytest.raises(ValueError, match="tile_rows"):
        ts.extend_streamed_matrix(bt_new, str(tmp_path), kernel="clustered", config=drifted,
                                  device="cpu")


# ---------------------------------------------------- what is not ported yet
def test_unported_routes_say_so_and_unknown_kernels_raise_as_jax(tmp_path):
    bj, bt = _pair(_uniform(40, 600, 0.3, seed=51))
    jcfg, cfg = _configs(DENSE)
    # sparse_outer is ported: the walk and its extension run
    man = ts.stream_count_matrix(bt, str(tmp_path / "a"), kernel="sparse_outer", config=cfg,
                                 device="cpu")
    assert man["kernel"] == "sparse_outer"
    _walk(ts, bt, tmp_path / "b", cfg, superblock_rows=32)
    man = ts.extend_streamed_matrix(bt, str(tmp_path / "b"), kernel="sparse_outer", config=cfg,
                                    device="cpu")
    assert man["kernel"] == "sparse_outer"
    for out in ("a", "b"):
        assert np.array_equal(ts.load_streamed_matrix(str(tmp_path / out)),
                              oracle_count_matrix(bj.packed))
    # through a mesh (a one-rank group here; tests/test_torch_multihost.py
    # runs eight): the JAX package's extend through a 4-device mesh, on a directory
    # of the first 24 rows each package wrote
    from stormtpu import parallel as jp
    from stormtpu_torch.parallel import make_row_mesh

    head_j, head_t = _pair(_uniform(24, 600, 0.3, seed=51))
    _walk(js, head_j, tmp_path / "mj", jcfg, superblock_rows=32)
    _walk(ts, head_t, tmp_path / "mt", cfg, superblock_rows=32)
    want_man = js.extend_streamed_matrix(bj, str(tmp_path / "mj"), config=jcfg,
                                         mesh=jp.make_row_mesh(4))
    man = ts.extend_streamed_matrix(bt, str(tmp_path / "mt"), config=cfg,
                                    mesh=make_row_mesh(1, device="cpu"))
    assert man == want_man and man["kernel"] == "distributed"
    for out in ("mj", "mt"):
        assert np.array_equal(ts.load_streamed_matrix(str(tmp_path / out)),
                              oracle_count_matrix(bj.packed))
    with pytest.raises(ValueError, match="unknown kernel") as port_err:
        ts.stream_count_matrix(bt, str(tmp_path / "c"), kernel="mxU", config=cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel") as ref_err:
        js.stream_count_matrix(bj, str(tmp_path / "c"), kernel="mxU", config=jcfg)
    assert str(port_err.value) == str(ref_err.value)
    assert not os.path.exists(tmp_path / "c")


def test_stream_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, bt = _pair(_block_diagonal(64, 16384, 2, 0.3, seed=52))
    xp = np.zeros((64, 512), np.uint32)
    for call in (
            lambda: ts.stream_count_matrix(bt, str(tmp_path / "x")),
            lambda: ts.stream_count_checksums(xp, 64, 16384),
            lambda: ts.stream_count_checksums_clustered(bt),
            lambda: ts.stream_count_histogram(xp, 64, 16384),
            lambda: ts.extend_streamed_matrix(bt, str(tmp_path / "x"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert set(ts.__all__) >= {
        "stream_count_matrix", "stream_count_checksums", "stream_count_checksums_clustered",
        "stream_count_histogram", "extend_streamed_matrix", "load_streamed_matrix",
        "stripe_path", "require_device_budget"}
    assert ts.stripe_path("d", 3, 12) == js.stripe_path("d", 3, 12)


def test_api_refusal_names_the_streaming_route(monkeypatch):
    _, bt = _pair(_uniform(40, 600, 0.3, seed=53))
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", "50")
    with pytest.raises(ValueError, match="stormtpu_torch.stream.stream_count_matrix"):
        st.intersect_count_matrix(bt, strategy="pallas_mxu", device="cpu")


# ------------------------------------------------- host-checked tile ids
@pytest.mark.parametrize("wrapper", ("k2", "k1"))
def test_tile_ids_checked_on_the_host_skip_the_wrappers_check(wrapper, monkeypatch):
    _, bt = _pair(_uniform(100, 600, 0.3, seed=61))
    xp = to_device_words(_padded(bt, 128, 8), "cpu")
    call = {"k2": lambda *a, **k: tm.count_tiles_pallas_mxu(*a, tile_words=8, **k),
            "k1": lambda *a, **k: td.count_tiles_pallas_dense(*a, tile_words=8, **k)}[wrapper]
    ibs, jbs = (x.astype(np.int32) for x in np.triu_indices(4))
    ids = tm.device_tile_ids(ibs, jbs, 4, "cpu")
    assert ids.ibs.dtype == torch.int32 and np.array_equal(ids.jbs.numpy(), jbs)
    bare = call(xp, torch.from_numpy(ibs), torch.from_numpy(jbs), tile_rows=32)

    def no_read_back(*a, **k):
        raise AssertionError("the checked route ran the wrapper's own check")

    monkeypatch.setattr(tm, "_check_tile_ids", no_read_back)
    got = call(xp, *ids, tile_rows=32, checked=ids)
    assert torch.equal(got, bare)
    # it vouches only for the very tensors, unchanged, and the geometry checked
    with pytest.raises(ValueError, match="other tile-id tensors"):
        call(xp, ids.ibs.clone(), ids.jbs, tile_rows=32, checked=ids)
    with pytest.raises(ValueError, match="row blocks"):
        call(xp[:96], *ids, tile_rows=32, checked=ids)
    ids.jbs.add_(0)
    with pytest.raises(ValueError, match="written to"):
        call(xp, *ids, tile_rows=32, checked=ids)


@pytest.mark.parametrize("wrapper", ("k2", "k1"))
def test_a_bad_tile_list_raises_on_both_routes(wrapper):
    xp = torch.zeros((128, 8), dtype=torch.int32)
    call = tm.count_tiles_pallas_mxu if wrapper == "k2" else td.count_tiles_pallas_dense
    good = np.zeros(3, np.int32)
    for bad in (np.array([0, 4, 1], np.int32), np.array([0, -1, 1], np.int32)):
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            tm.device_tile_ids(bad, good, 4, "cpu")
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            tm.device_tile_ids(good, bad, 4, "cpu")
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            call(xp, torch.from_numpy(bad), torch.from_numpy(good), tile_rows=32, tile_words=8)
    with pytest.raises(ValueError, match="equal length"):
        tm.device_tile_ids(good, good[:2], 4, "cpu")
    with pytest.raises(ValueError, match="equal length"):
        call(xp, torch.from_numpy(good), torch.from_numpy(good[:2]), tile_rows=32, tile_words=8)


def test_record_stages_counts_the_stripes_of_the_walks_inside_it(tmp_path):
    _, bt = _pair(_block_diagonal(128, 16384, 4, 0.3, seed=71))
    _, cfg = _configs(CLUSTERED)
    with ts.record_stages() as rec:
        _walk(ts, bt, tmp_path / "c", cfg, superblock_rows=32, kernel="clustered")
    assert rec.stripes == 10 and 0 < rec.launched < 10
    assert {"plan", "kernel", "download", "save"} <= set(rec.seconds)
    assert rec.device_ms == {}  # CUDA events: on the card only
    with ts.record_stages() as rec:
        _walk(ts, bt, tmp_path / "m", cfg, superblock_rows=32, kernel="mxu",
              operand_streaming=True)
    assert rec.stripes == rec.launched == 10
    assert {"upload", "plan", "kernel", "assembly", "download", "save"} <= set(rec.seconds)
    assert not profiling.synchronised()


# ------------------------------------------------------- the writer threads
@pytest.mark.parametrize("writers,ahead", [(1, 1 << 30), (4, 1 << 30), (4, 1)])
def test_stripe_files_written_beside_the_walk_keep_its_order(tmp_path, monkeypatch, writers,
                                                             ahead):
    import threading

    monkeypatch.setattr(ts, "_WRITERS", writers)
    monkeypatch.setattr(ts, "_WRITE_AHEAD_BYTES", ahead)
    dense, fields, sb = _case("mxu", seed=81)
    _, bt = _pair(dense)
    _, cfg = _configs(fields)
    out = str(tmp_path)
    first = _walk(ts, bt, out, cfg, superblock_rows=32)
    pairs = [[i, j] for i in range(5) for j in range(i, 5)]
    assert first["completed"] == pairs
    for i, j in ((0, 0), (0, 3), (2, 2), (4, 4)):
        os.remove(ts.stripe_path(out, i, j))
    seen = []

    def progress(done, total):
        # a stripe counts once its file is in place, in the walk's order
        i, j = pairs[done - 1]
        assert os.path.exists(ts.stripe_path(out, i, j))
        seen.append(done)

    again = _walk(ts, bt, out, cfg, superblock_rows=32, progress=progress)
    assert again["completed"] == pairs and seen == [1, 4, 10, 15]
    assert np.array_equal(ts.load_streamed_matrix(out), oracle_count_matrix(bt.packed))
    assert not [t for t in threading.enumerate() if t.name.startswith("stripe-save")]


def test_a_failed_write_fails_the_walk_and_leaves_no_thread(tmp_path, monkeypatch):
    import threading

    dense, fields, sb = _case("mxu", seed=82)
    _, bt = _pair(dense)
    _, cfg = _configs(fields)
    real = ts._save_stripe

    def failing(path, compress, members):
        if (members["i"], members["j"]) == (0, 1):
            raise OSError("disk full")
        real(path, compress, members)

    monkeypatch.setattr(ts, "_save_stripe", failing)
    with pytest.raises(OSError, match="disk full"):
        _walk(ts, bt, tmp_path, cfg, superblock_rows=sb)
    assert not os.path.exists(tmp_path / "manifest.json")
    assert not os.path.exists(ts.stripe_path(str(tmp_path), 0, 1))
    assert not [t for t in threading.enumerate() if t.name.startswith("stripe-save")]
    monkeypatch.setattr(ts, "_save_stripe", real)
    man = _walk(ts, bt, tmp_path, cfg, superblock_rows=sb)  # a re-run resumes and completes
    assert len(man["completed"]) == 6
    assert np.array_equal(ts.load_streamed_matrix(str(tmp_path)), oracle_count_matrix(bt.packed))
