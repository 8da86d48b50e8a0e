"""The port's file formats against the JAX package's, on the CPU: a matrix
saved by either package loads in the other (packed words, width, COO
cache), and ``load_plink_bed`` decodes the same ``.bed`` to the same
matrix in both, for every encoding, orientation and chunking. Exact
equality throughout."""

import numpy as np
import pytest

import stormtpu
import stormtpu.io as jio
import stormtpu_torch as st
import stormtpu_torch.io as tio


def _write_bed(path, codes):
    """Plain scalar PLINK1 encoder: codes uint8 [V, N] in {0,1,2,3}
    (00 hom-A1, 01 missing, 10 het, 11 hom-A2), SNP-major, LSB-first."""
    v, n = codes.shape
    bpv = (n + 3) // 4
    out = bytearray(b"\x6c\x1b\x01")
    for vi in range(v):
        row = bytearray(bpv)
        for si in range(n):
            row[si // 4] |= int(codes[vi, si]) << (2 * (si % 4))
        out += row
    with open(path, "wb") as f:
        f.write(bytes(out))


def _positions(n, m, density, seed):
    rng = np.random.default_rng(seed)
    k = int(n * m * density)
    return rng.integers(0, n, k), rng.integers(0, m, k)


PACKAGES = {"jax": (stormtpu.BitMatrix, jio), "torch": (st.BitMatrix, tio)}


@pytest.mark.parametrize("coo", (False, True))
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_save_bitmatrix_loads_in_the_other_package(tmp_path, writer, reader, coo):
    n, m = 37, 1001
    rows, cols = _positions(n, m, 0.05, seed=n + coo)
    w_bm, w_io = PACKAGES[writer]
    r_bm, r_io = PACKAGES[reader]
    bm = w_bm.from_positions(rows, cols, n, m)
    if not coo:
        bm = w_bm.from_packed(bm.packed, m)
    assert (bm.coo is not None) == coo
    path = str(tmp_path / "m.npz")
    w_io.save_bitmatrix(bm, path)
    got = r_io.load_bitmatrix(path)
    assert isinstance(got, r_bm)
    assert got.m_bits == m and got.n == n
    np.testing.assert_array_equal(got.packed, bm.packed)
    np.testing.assert_array_equal(got.row_nnz, bm.row_nnz)
    if coo:
        for a, b in zip(got.coo, bm.coo):
            np.testing.assert_array_equal(a, b)
    else:
        assert got.coo is None


@pytest.mark.parametrize("mmap", (True, False))
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_save_bitmatrix_mmap_loads_in_the_other_package(tmp_path, writer, reader, mmap):
    rng = np.random.default_rng(82)
    dense = (rng.random((52, 700)) < 0.25).astype(np.uint8)
    w_bm, w_io = PACKAGES[writer]
    r_bm, r_io = PACKAGES[reader]
    bm = w_bm.from_dense(dense)
    path = str(tmp_path / "panel.npy")
    w_io.save_bitmatrix_mmap(bm, path)
    got = r_io.load_bitmatrix_mmap(path, mmap=mmap)
    assert isinstance(got, r_bm) and got.m_bits == 700
    assert got.packed.flags.writeable != mmap
    np.testing.assert_array_equal(np.asarray(got.packed), bm.packed)
    np.testing.assert_array_equal(got.row_nnz, bm.row_nnz)


def test_mmap_panel_drives_the_ports_streaming_walk(tmp_path):
    from stormtpu_torch.stream import load_streamed_matrix, stream_count_matrix

    rng = np.random.default_rng(9)
    bm = st.BitMatrix.from_dense((rng.random((70, 500)) < 0.3).astype(np.uint8))
    path = str(tmp_path / "p")
    tio.save_bitmatrix_mmap(bm, path)
    got = tio.load_bitmatrix_mmap(path + ".npy")
    assert not got.packed.flags.owndata
    stream_count_matrix(got, str(tmp_path / "s"), superblock_rows=32, kernel="xla_popcount",
                        device="cpu")
    np.testing.assert_array_equal(load_streamed_matrix(str(tmp_path / "s")),
                                  st.oracle_count_matrix(bm.packed))


def test_newer_format_versions_are_refused(tmp_path):
    path = str(tmp_path / "new.npz")
    np.savez(path, format_version=2, packed=np.zeros((1, 1), np.uint32), m_bits=5)
    for io in (jio, tio):
        with pytest.raises(ValueError, match="newer"):
            io.load_bitmatrix(path)


@pytest.mark.parametrize("rows", ("variants", "samples"))
@pytest.mark.parametrize("encode", ("carrier", "hom_a2", "het", "hom_a1", "missing"))
def test_load_plink_bed_equals_jax(tmp_path, encode, rows):
    rng = np.random.default_rng(83)
    v, n = 100, 13  # n % 4 != 0: the last byte's pad bits are ignored
    codes = rng.integers(0, 4, size=(v, n)).astype(np.uint8)
    p = str(tmp_path / "g.bed")
    _write_bed(p, codes)
    pred = {"carrier": codes >= 2, "hom_a2": codes == 3, "het": codes == 2,
            "hom_a1": codes == 0, "missing": codes == 1}[encode].astype(np.uint8)
    for chunk in (None, 32):
        got = tio.load_plink_bed(p, n, encode=encode, rows=rows, chunk_variants=chunk)
        want = jio.load_plink_bed(p, n, encode=encode, rows=rows, chunk_variants=chunk)
        assert isinstance(got, st.BitMatrix)
        assert (got.n, got.m_bits) == (want.n, want.m_bits)
        np.testing.assert_array_equal(got.packed, want.packed)
        dense = pred if rows == "variants" else pred.T
        np.testing.assert_array_equal(st.unpack_bits(got.packed, got.m_bits), dense)


def test_plink_trio_sidecars(tmp_path):
    rng = np.random.default_rng(85)
    v, n = 7, 11
    codes = rng.integers(0, 4, size=(v, n)).astype(np.uint8)
    p = tmp_path / "panel.bed"
    _write_bed(str(p), codes)
    (tmp_path / "panel.fam").write_text("\n".join(f"F{i} I{i} 0 0 0 -9" for i in range(n)) + "\n")
    (tmp_path / "panel.bim").write_text("\n".join(f"1 rs{i} 0 {i} A C" for i in range(v)) + "\n")
    got, want = tio.load_plink_bed(str(p)), jio.load_plink_bed(str(p))
    assert (got.n, got.m_bits) == (want.n, want.m_bits) == (v, n)
    np.testing.assert_array_equal(got.packed, want.packed)
    for io in (jio, tio):
        with pytest.raises(ValueError, match="sidecar"):
            io.load_plink_bed(str(tmp_path / "panel3.bed"))


def test_plink_bed_errors_match_jax(tmp_path):
    p = str(tmp_path / "bad.bed")
    cases = []
    with open(p, "wb") as f:
        f.write(b"\x00\x01\x02")
    cases.append(("magic", (p, 4), {}))
    p2 = str(tmp_path / "mode0.bed")
    with open(p2, "wb") as f:
        f.write(b"\x6c\x1b\x00" + b"\x00")
    cases.append(("individual-major", (p2, 4), {}))
    p3 = str(tmp_path / "z.bed")
    _write_bed(p3, np.zeros((3, 5), dtype=np.uint8))
    cases += [("not a multiple", (p3, 13), {}), ("expected", (p3, 5), {"n_variants": 4}),
              ("encode", (p3, 5), {"encode": "bogus"}), ("rows", (p3, 5), {"rows": "bogus"}),
              ("multiple of 32", (p3, 5), {"chunk_variants": 17})]
    for match, args, kw in cases:
        for io in (jio, tio):
            with pytest.raises(ValueError, match=match):
                io.load_plink_bed(*args, **kw)
