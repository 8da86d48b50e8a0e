"""The port's C++ host tier (``stormtpu_torch.native``): every entry point
against its NumPy fallback and against the JAX package's tier
(``stormtpu.native``) on shared seeded inputs, duplicated positions
included; each popcount form of the library against NumPy, and the form
it picks against what the CPU reports; the build on first use, safe when
four processes start it at once into one empty directory; the build's
error text kept. Counts are integers: every comparison is exact."""

import os
import platform
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import stormtpu.native as jn
import stormtpu_torch.layout as tl
import stormtpu_torch.native as tn
from stormtpu_torch.kernels.sparse import count_matrix_sparse_outer
from stormtpu_torch.oracle import oracle_count_matrix, oracle_pair_count
from stormtpu_torch.utils import profiling

# (N, M bits); (9, 1051) has an odd W of 33 words, so every other row starts
# 4 bytes off 8-byte alignment
SHAPES = ((1, 31), (37, 1000), (64, 4097), (9, 1051))


@pytest.fixture
def native_tier():
    """The C++ tier, which must build wherever ``g++`` exists."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the C++ host tier cannot be built here")
    assert tn.have_native(), tn.native_build_error()
    assert tn.HAVE_NATIVE and tn.native_build_error() is None


@pytest.fixture
def no_native(monkeypatch):
    """The port as it runs where the C++ tier is unavailable."""
    monkeypatch.setattr(tn, "_load", lambda: None)
    assert not tn.have_native() and not tn.HAVE_NATIVE


def _positions(n, m, seed):
    """COO coordinates at about 5% density, every tenth one repeated."""
    rng = np.random.default_rng(seed)
    k = max(1, n * m // 20)
    rows, pos = rng.integers(0, n, k), rng.integers(0, m, k)
    return np.r_[rows, rows[::10]], np.r_[pos, pos[::10]]


def _packed(n, m, seed):
    rows, pos = _positions(n, m, seed)
    return tl.BitMatrix.from_positions(rows, pos, n, m)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _reference(name, *args, numpy_form):
    """The JAX package's native entry point where its tier is loaded in this
    process, else an independent NumPy form of the same function."""
    out = getattr(jn, name)(*args)
    return numpy_form(*args) if out is None else out


def _column_sorted(bm):
    """(columns int64, rows int32) of every set bit, sorted by (column, row)."""
    rows, cols = np.nonzero(bm.to_dense())
    order = np.lexsort((rows, cols))
    return cols[order].astype(np.int64), rows[order].astype(np.int32)


@pytest.mark.parametrize("n,m", SHAPES)
def test_pack_positions_native_equals_fallback_and_jax(native_tier, monkeypatch, n, m):
    rows, pos = _positions(n, m, seed=n + m)
    w = tl.words_for_bits(m)
    got = tn.pack_positions_native(rows, pos, n, m, w)
    want = _reference("pack_positions_native", rows, pos, n, m, w,
                      numpy_form=lambda r, p, n_, m_, w_: _fallback(
                          monkeypatch, tl.pack_positions, r, p, n_, m_))
    _same(got, want)
    monkeypatch.setattr(tn, "_load", lambda: None)
    _same(tl.pack_positions(rows, pos, n, m), got)


def _dense_of(rows, pos, n, m):
    dense = np.zeros((n, m), np.uint8)
    dense[rows, pos] = 1
    return dense


@pytest.mark.parametrize("n,m", SHAPES)
def test_pack_and_unpack_bits_native_equal_fallback_and_jax(native_tier, monkeypatch, n, m):
    dense = _dense_of(*_positions(n, m, seed=n * m + 1), n, m)
    dense[0, 0] = 7  # any nonzero byte is a set bit
    w = tl.words_for_bits(m)
    packed = tn.pack_bits_native(dense, w)
    _same(packed, _reference("pack_bits_native", dense, w,
                             numpy_form=lambda d, w_: _fallback(monkeypatch, tl.pack_bits, d)))
    unpacked = tn.unpack_bits_native(packed, m)
    _same(unpacked, _reference("unpack_bits_native", packed, m,
                               numpy_form=lambda p, m_: _fallback(monkeypatch, tl.unpack_bits,
                                                                  p, m_)))
    _same(unpacked, (dense != 0).astype(np.uint8))
    monkeypatch.setattr(tn, "_load", lambda: None)
    _same(tl.pack_bits(dense), packed)
    _same(tl.unpack_bits(packed, m), unpacked)


def _fallback(monkeypatch, fn, *args):
    with monkeypatch.context() as mp:
        mp.setattr(tn, "_load", lambda: None)
        return fn(*args)


@pytest.mark.parametrize("n,m", SHAPES)
def test_row_popcounts_and_positions_csr_native_equal_fallback_and_jax(
        native_tier, monkeypatch, n, m):
    bm = _packed(n, m, seed=n + 2 * m)
    nnz = tn.row_popcounts_native(bm.packed)
    _same(nnz, _reference("row_popcounts_native", bm.packed,
                          numpy_form=lambda p: np.bitwise_count(p).sum(axis=1, dtype=np.int64)))
    indptr, indices = tn.positions_csr_native(bm.packed, m)
    rows, cols = np.nonzero(bm.to_dense())
    want_ptr = np.r_[0, np.cumsum(np.bincount(rows, minlength=n))].astype(np.int64)
    ref = _reference("positions_csr_native", bm.packed, m,
                     numpy_form=lambda p, m_: (want_ptr, cols.astype(np.int32)))
    _same(indptr, ref[0])
    _same(indices, ref[1])
    monkeypatch.setattr(tn, "_load", lambda: None)
    _same(tl.BitMatrix.from_packed(bm.packed, m).row_nnz, nnz)
    got_ptr, got_idx = bm.positions_csr()
    _same(got_ptr, indptr)
    _same(got_idx, indices)


@pytest.mark.parametrize("n,m", SHAPES)
def test_pair_count_native_equals_fallback_and_jax(native_tier, n, m):
    bm = _packed(max(n, 2), m, seed=3 * n + m)
    a, b = bm.packed[0], bm.packed[-1]
    got = tn.pair_count_native(a, b)
    assert got == oracle_pair_count(a, b)
    assert got == _reference("pair_count_native", a, b, numpy_form=oracle_pair_count)
    with pytest.raises(ValueError, match="words"):
        tn.pair_count_native(a, b[:-1])


@pytest.mark.parametrize("n,m", SHAPES)
def test_k4_from_packed_and_mirror_equal_fallback_and_jax(native_tier, monkeypatch, n, m):
    bm = _packed(n, m, seed=5 * n + m)
    upper = tn.sparse_outer_from_packed_native(bm.packed, m)
    want = oracle_count_matrix(bm.packed).astype(np.int32)
    _same(upper, np.triu(want))
    _same(upper, _reference("sparse_outer_from_packed_native", bm.packed, m,
                            numpy_form=lambda p, m_: np.triu(want)))
    mirrored = upper.copy()
    assert tn.mirror_upper_native(mirrored)
    ref = np.triu(want).copy()
    if not jn.mirror_upper_native(ref):
        ref = np.triu(ref) + np.triu(ref, 1).T
    _same(mirrored, ref)
    _same(mirrored, want)
    # the NumPy fallback of the whole K4 route, from the packed words
    monkeypatch.setattr(tn, "_load", lambda: None)
    _same(count_matrix_sparse_outer(tl.BitMatrix.from_packed(bm.packed, m), device="cpu"),
          mirrored)


@pytest.mark.parametrize("n,m", SHAPES)
def test_k4_runs_equal_fallback_and_jax(native_tier, monkeypatch, n, m):
    bm = _packed(n, m, seed=7 * n + m)
    cols, rows = _column_sorted(bm)
    upper = tn.sparse_outer_runs_native(cols, rows, n)
    want = oracle_count_matrix(bm.packed).astype(np.int32)
    _same(upper, np.triu(want))
    _same(upper, _reference("sparse_outer_runs_native", cols, rows, n,
                            numpy_form=lambda c, r, n_: np.triu(want)))
    # the NumPy fallback of the whole K4 route, from the COO cache
    assert bm.coo is not None
    monkeypatch.setattr(tn, "_load", lambda: None)
    _same(np.triu(count_matrix_sparse_outer(bm, device="cpu")), upper)


@pytest.mark.parametrize("n,m", SHAPES)
def test_k4_runs_cross_equals_fallback_and_jax(native_tier, n, m):
    from stormtpu_torch.stream import _SparseStripePlan

    bm = _packed(2 * n, m, seed=11 * n + m)
    a = tl.BitMatrix.from_packed(bm.packed[:n], m)
    b = tl.BitMatrix.from_packed(bm.packed[n:], m)
    ca, ra = _column_sorted(a)
    cb, rb = _column_sorted(b)
    got = tn.sparse_outer_runs_cross_native(ca, ra, cb, rb, n, n)
    want = (a.to_dense().astype(np.int32) @ b.to_dense().astype(np.int32).T)
    _same(got, want)
    _same(got, _reference("sparse_outer_runs_cross_native", ca, ra, cb, rb, n, n,
                          numpy_form=lambda *args: want))
    # the NumPy form of a cross stripe: the walk's buffer-free emission
    ci, cj, cv = _SparseStripePlan(bm, n, 2, device="cpu").stripe_coo(0, 1)
    dense = np.zeros((n, n), np.int32)
    dense[ci, cj] = cv
    _same(dense, got)


# ------------------------------------------------------------ popcount forms
POPCOUNT_W = (1, 2, 7, 8, 15, 16, 17, 33, 32768 + 3)


def _popcount_rows(w, offset):
    """Seven rows of ``w`` words, ``offset`` words past an 8-byte-aligned
    start: random, all ones, zero, sparse, a single bit in the last word,
    random, all ones."""
    rng = np.random.default_rng(w + 100 * offset)
    n = 7
    buf = np.empty(n * w + 2, np.uint32)
    start = (-buf.ctypes.data // 4) % 2 + offset  # words to an 8-byte boundary, then offset
    rows = buf[start:start + n * w].reshape(n, w)
    assert rows.ctypes.data % 8 == 4 * offset
    rows[:] = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    rows[1] = rows[6] = 0xFFFFFFFF
    rows[2] = 0
    rows[3] &= rng.integers(0, 2**32, w, dtype=np.uint32) & rng.integers(0, 2**32, w, dtype=np.uint32)
    rows[4] = 0
    rows[4, -1] = 1 << 31
    return rows


def _popcounts(rows):
    return np.bitwise_count(rows).sum(axis=1, dtype=np.int64)


@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w", POPCOUNT_W)
@pytest.mark.parametrize("path", range(len(tn.POPCOUNT_PATHS)))
def test_each_popcount_form_counts_exactly(native_tier, path, w, offset):
    """Row popcounts, the CSR's first pass and one pair's count with each
    form of the library, exact against NumPy; a form this CPU cannot run
    is refused and writes nothing."""
    lib = tn._load()
    rows = _popcount_rows(w, offset)
    n = rows.shape[0]
    out = np.full(n, -1, np.int64)
    indptr = np.full(n + 1, -1, np.int64)
    if not lib.stpu_popcount_path_supported(path):
        assert lib.stpu_row_popcounts_on(path, rows, n, w, out) == 1
        assert lib.stpu_positions_csr_on(path, rows, n, w, 32 * w, indptr, None) == 1
        assert lib.stpu_pair_count_on(path, rows[0], rows[1], w) == -1
        assert (out == -1).all() and (indptr == -1).all()
        return
    want = _popcounts(rows)
    assert lib.stpu_row_popcounts_on(path, rows, n, w, out) == 0
    _same(out, want)
    assert lib.stpu_positions_csr_on(path, rows, n, w, 32 * w, indptr, None) == 0
    _same(indptr, np.r_[0, np.cumsum(want)].astype(np.int64))
    for i, j in ((0, 5), (1, 0), (1, 6), (2, 0), (3, 1), (4, 6), (5, 5), (0, 6)):
        got = lib.stpu_pair_count_on(path, rows[i], rows[j], w)
        assert got == int(np.bitwise_count(rows[i] & rows[j]).sum()), (i, j)
    # no rows
    none = rows[:0]
    assert lib.stpu_row_popcounts_on(path, none, 0, w, out) == 0
    indptr[:] = -1
    assert lib.stpu_positions_csr_on(path, none, 0, w, 32 * w, indptr, None) == 0
    assert indptr[0] == 0 and (indptr[1:] == -1).all()


def _cpu_flags():
    """The flags ``/proc/cpuinfo`` lists for the first CPU (empty where the
    file does not exist)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return set(line.split(":", 1)[1].split())
    except OSError:
        pass
    return set()


def test_the_library_runs_the_best_popcount_form_the_cpu_has(native_tier):
    lib = tn._load()
    path = tn.popcount_path()
    supported = [p for p in range(len(tn.POPCOUNT_PATHS))
                 if lib.stpu_popcount_path_supported(p)]
    assert supported[0] == 0
    assert path == tn.POPCOUNT_PATHS[supported[-1]]
    flags = _cpu_flags() if platform.machine() in ("x86_64", "AMD64") else set()
    if "popcnt" in flags:  # a silent fall back to the bit-trick loop fails here
        assert path != "portable"
    if {"avx512f", "avx512_vpopcntdq"} <= flags:
        assert path == "avx512_vpopcntdq"
    # the public entry points run that form
    rows = _popcount_rows(33, 1)
    _same(tn.row_popcounts_native(rows), _popcounts(rows))
    assert tn.pair_count_native(rows[0], rows[3]) == lib.stpu_pair_count_on(
        tn.POPCOUNT_PATHS.index(path), rows[0], rows[3], 33)


def test_from_packed_counts_the_popcount_form_it_ran(native_tier):
    bm = _packed(5, 1000, seed=3)
    with profiling.record() as rec:
        tl.BitMatrix.from_packed(bm.packed, 1000)
    counted = {k: v for k, v in rec.counters.items() if k.startswith("row_counts.")}
    assert counted == {f"row_counts.{tn.popcount_path()}": 1}


def test_from_packed_without_the_tier_counts_no_popcount_form(no_native):
    with profiling.record() as rec:
        bm = tl.BitMatrix.from_packed(np.full((3, 4), 0xF0F0F0F0, np.uint32), 128)
    _same(bm.row_nnz, np.full(3, 64, np.int64))
    assert not [k for k in rec.counters if k.startswith("row_counts.")]


def test_entry_points_refuse_out_of_range_input(native_tier):
    w = tl.words_for_bits(100)
    with pytest.raises(ValueError, match="out of range"):
        tn.pack_positions_native(np.array([0]), np.array([100]), 2, 100, w)
    with pytest.raises(ValueError, match="out of range"):
        tn.pack_positions_native(np.array([2]), np.array([5]), 2, 100, w)
    bad = np.zeros((2, w), np.uint32)
    bad[1, -1] = 1 << 31  # bit 127 of a 100-bit universe
    with pytest.raises(ValueError, match="beyond m_bits"):
        tn.sparse_outer_from_packed_native(bad, 100)
    with pytest.raises(ValueError, match="square"):
        tn.mirror_upper_native(np.zeros((2, 3), np.int32))


def test_k4_entry_points_count_their_launches(native_tier):
    bm = _packed(20, 500, seed=13)
    tn.reset_launches()
    cols, rows = _column_sorted(bm)
    tn.sparse_outer_from_packed_native(bm.packed, 500)
    tn.sparse_outer_runs_native(cols, rows, 20)
    tn.sparse_outer_runs_cross_native(cols, rows, cols, rows, 20, 20)
    tn.pair_count_native(bm.packed[0], bm.packed[1])
    assert tn.LAUNCHES == {"k4": 3}
    tn.reset_launches()
    assert tn.LAUNCHES == {"k4": 0}


def test_without_the_tier_every_entry_point_returns_none(no_native):
    p = np.zeros((2, 4), np.uint32)
    i64, i32 = np.zeros(1, np.int64), np.zeros(1, np.int32)
    for out in (tn.pack_positions_native(i64, i64, 2, 100, 4),
                tn.pack_bits_native(np.zeros((2, 100), np.uint8), 4),
                tn.unpack_bits_native(p, 100), tn.row_popcounts_native(p),
                tn.positions_csr_native(p, 100), tn.pair_count_native(p[0], p[1]),
                tn.sparse_outer_from_packed_native(p, 100),
                tn.sparse_outer_runs_native(i64, i32, 2),
                tn.sparse_outer_runs_cross_native(i64, i32, i64, i32, 2, 2)):
        assert out is None
    assert tn.popcount_path() is None
    assert tn.mirror_upper_native(np.zeros((2, 2), np.int32)) is False


# ------------------------------------------------------------------ the build
def _copy_tier(tmp_path, source=None):
    """The tier's binding and source, alone in ``tmp_path/tier`` (its build
    directory is then ``tmp_path/tier/build``, empty)."""
    tier = tmp_path / "tier"
    tier.mkdir()
    shutil.copy(tn.__file__, tier / "__init__.py")
    if source is None:
        shutil.copy(tn.SOURCE, tier / "packer.cpp")
    else:
        (tier / "packer.cpp").write_text(source)
    return tier


_LOAD_COPY = textwrap.dedent("""
    import importlib.util, os, sys, time
    tier, go = sys.argv[1], sys.argv[2]
    spec = importlib.util.spec_from_file_location("tier", os.path.join(tier, "__init__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    open(go + f".ready.{os.getpid()}", "w").close()  # imported; now wait for the others
    while not os.path.exists(go):
        time.sleep(0.005)
    print(mod.HAVE_NATIVE, int(mod.pair_count_native([7, 1], [5, 3]) or -1))
    print(mod.native_build_error())
""")


def _start(tier, go, env=None):
    return subprocess.Popen([sys.executable, "-c", _LOAD_COPY, str(tier), str(go)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _counting_compiler(tmp_path):
    """An environment whose ``CXX`` is g++ behind a script that logs each
    run to ``tmp_path/cxx.log``."""
    log, cxx = tmp_path / "cxx.log", tmp_path / "cxx"
    cxx.write_text(f'#!/bin/sh\necho run >> "{log}"\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    return dict(os.environ, CXX=str(cxx)), log


def _all_ready(go, count):
    """Wait until ``count`` processes have imported the module."""
    deadline = time.monotonic() + 120
    while len(list(go.parent.glob(go.name + ".ready.*"))) < count:
        assert time.monotonic() < deadline, "the processes did not start"
        time.sleep(0.01)


@pytest.mark.parametrize("n_procs", (4, 8))
def test_processes_build_into_one_empty_directory_and_all_load(tmp_path, n_procs):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the C++ host tier cannot be built here")
    tier = _copy_tier(tmp_path)
    go = tmp_path / "go"
    env, log = _counting_compiler(tmp_path)
    procs = [_start(tier, go, env) for _ in range(n_procs)]
    _all_ready(go, n_procs)
    assert not (tier / "build").exists()  # importing the module built nothing
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    for out, err in outs:
        assert out.splitlines()[0] == "True 3", (out, err)
    built = sorted(p.name for p in (tier / "build").iterdir())
    assert len([n for n in built if n.endswith(".so")]) == 1
    assert not [n for n in built if n.endswith(".tmp")]
    # one process compiled; the others waited for it and loaded its library
    assert log.read_text().split() == ["run"]
    again = _start(tier, go, env)
    assert again.communicate(timeout=60)[0].splitlines()[0] == "True 3"
    assert log.read_text().split() == ["run"]


def test_a_failed_build_keeps_its_error_text(tmp_path):
    broken = tn.SOURCE.read_text().replace("int64_t acc = 0;", "int64_t acc = ;", 1)
    tier = _copy_tier(tmp_path, broken)
    go = tmp_path / "go"
    go.touch()
    out, err = _start(tier, go).communicate(timeout=240)
    ok, error = out.splitlines()[0], "\n".join(out.splitlines()[1:])
    assert ok == "False -1", (out, err)
    assert "packer.cpp" in error and ("error" in error or "No such file" in error)
    assert not [p for p in (tier / "build").iterdir() if p.suffix in (".so", ".tmp")]
