"""Scale rehearsals of the port on the card, the counterpart of
``tests/test_scale.py``: N = 65,536 to 1,048,576 rows through the
distributed streaming walk, the streamed top-k, the per-superblock K4
walk, the sparse streamed queries and the aggregate sinks, each sampled
exact against NumPy, each resumed without recomputing.

Opt-in: they take minutes and, for the 65,536-row stripes, about 17 GB of
disk. Every case runs on the card; the distributed ones on a one-rank NCCL
mesh (``parallel.make_row_mesh``), where the reference runs its forced
8-device CPU mesh:

    STORMTPU_SLOW_TESTS=1 python -m pytest tests/test_torch_scale.py -m cuda --noconftest

All nine cases of the reference are here: their packed operands are 4 MB
(65,536 × 512 bits) to 64 MB (1,048,576 × 512 bits), far inside the card's
host.
"""

import os
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not os.environ.get("STORMTPU_SLOW_TESTS"),
                       reason="scale rehearsal takes minutes + ~20 GB disk; set "
                       "STORMTPU_SLOW_TESTS=1"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def mesh(cuda):
    from stormtpu_torch.parallel import make_row_mesh

    return make_row_mesh(device=cuda)


def _rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _count(packed, gi, gj) -> int:
    return int(np.bitwise_count(packed[gi] & packed[gj]).sum())


def _banded_packed(n: int, words: int, band: int, seed: int) -> np.ndarray:
    """Rows nonzero only in the FIRST and LAST ``band``-row superblocks:
    every stripe between all-zero superblocks is skipped on the host, so
    the case measures the metadata scale (checkpoint arrays, manifest
    length, thousands of stripe records)."""
    rng = np.random.default_rng(seed)

    def blk() -> np.ndarray:
        x = rng.integers(0, 2**32, (band, words), dtype=np.uint32)
        x &= rng.integers(0, 2**32, (band, words), dtype=np.uint32)
        x &= rng.integers(0, 2**32, (band, words), dtype=np.uint32)
        return x

    packed = np.zeros((n, words), dtype=np.uint32)
    packed[:band] = blk()
    packed[n - band :] = blk()
    return packed


def _sparse_panel(n: int, m: int, nnz: int, seed: int):
    """(BitMatrix, distinct (row, column) positions, rows, columns)."""
    from stormtpu_torch.layout import BitMatrix

    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
    return (BitMatrix.from_positions(rows, cols, n, m), set(zip(rows.tolist(), cols.tolist())),
            rng)


def _pair_counts(positions, diagonal: bool) -> dict:
    """Independent expectation: per-column row lists → pair co-occurrence
    counts (i ≤ j with ``diagonal``, else i < j)."""
    want: dict = defaultdict(int)
    by_col = defaultdict(list)
    for r, c in positions:
        by_col[c].append(r)
    for rs in by_col.values():
        rs.sort()
        for x in range(len(rs)):
            for y in range(x if diagonal else x + 1, len(rs)):
                want[(rs[x], rs[y])] += 1
    return want


def _sampled_stripes(out, packed, sb, stripes, samples, rng):
    from stormtpu_torch.stream import stripe_path

    for i, j in stripes:
        with np.load(stripe_path(out, i, j)) as z:
            stripe = z["counts"]
        assert stripe.shape == (sb, sb)
        for _ in range(samples):
            a, b = int(rng.integers(0, sb)), int(rng.integers(0, sb))
            assert stripe[a, b] == _count(packed, i * sb + a, j * sb + b), (i, j, a, b)


def test_scale_rehearsal_n65536(tmp_path, mesh):
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.parallel import distributed_stream_count_matrix

    n, m = 65_536, 512
    rng = np.random.default_rng(65536)
    packed = rng.integers(0, 2**32, (n, m // 32), dtype=np.uint32)
    packed &= rng.integers(0, 2**32, (n, m // 32), dtype=np.uint32)
    packed &= rng.integers(0, 2**32, (n, m // 32), dtype=np.uint32)
    bm = BitMatrix.from_packed(packed, m_bits=m)
    out = str(tmp_path / "stripes")
    man = distributed_stream_count_matrix(bm, out, superblock_rows=8192, mesh=mesh,
                                          compress=False)
    assert man["n_super"] == 8 and len(man["completed"]) == 36
    assert os.path.exists(os.path.join(out, "manifest.json"))
    _sampled_stripes(out, packed, man["superblock_rows"], ((0, 0), (0, 7), (7, 7)), 64, rng)
    t0 = time.time()
    man2 = distributed_stream_count_matrix(bm, out, superblock_rows=8192, mesh=mesh,
                                           compress=False)
    assert len(man2["completed"]) == 36
    assert time.time() - t0 < 30, "resume recomputed stripes"


def test_scale_rehearsal_stream_topk_n262144(tmp_path, cuda):
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.stream_query import stream_topk_neighbors

    n, m, k, sb = 262_144, 512, 4, 4096
    packed = _banded_packed(n, m // 32, sb, seed=262144)
    bm = BitMatrix.from_packed(packed, m_bits=m)
    out = str(tmp_path / "topk262k")
    vals, idx = stream_topk_neighbors(bm, k, superblock_rows=sb, out_dir=out, device=cuda)
    assert vals.shape == (n, k) and idx.shape == (n, k)
    band_rows = np.concatenate([np.arange(sb), np.arange(n - sb, n)])
    band = packed[band_rows]
    rng = np.random.default_rng(7)
    for r in map(int, rng.choice(band_rows, 48, replace=False)):
        c = np.bitwise_count(band & packed[r]).sum(axis=1, dtype=np.int64)
        c[band_rows == r] = -1  # self excluded
        np.testing.assert_array_equal(vals[r], np.maximum(-np.sort(-c)[:k], 0), err_msg=str(r))
        for t in range(k):
            if vals[r, t] > 0:
                assert _count(packed, r, idx[r, t]) == vals[r, t] and idx[r, t] != r
    # all-zero rows report no partners: the streamed walk's (0, 0) entries
    assert not vals[sb : n - sb].any() and not idx[sb : n - sb].any()
    t0 = time.time()
    vals2, idx2 = stream_topk_neighbors(bm, k, superblock_rows=sb, out_dir=out, device=cuda)
    assert time.time() - t0 < 60, "resume recomputed stripes"
    np.testing.assert_array_equal(vals, vals2)
    np.testing.assert_array_equal(idx, idx2)


def test_scale_rehearsal_distributed_stream_n262144(tmp_path, mesh):
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.parallel import distributed_stream_count_matrix
    from stormtpu_torch.stream import stripe_path

    n, m, sb = 262_144, 512, 8192
    packed = _banded_packed(n, m // 32, sb, seed=524288)
    bm = BitMatrix.from_packed(packed, m_bits=m)
    out = str(tmp_path / "stripes262k")
    man = distributed_stream_count_matrix(bm, out, superblock_rows=sb, mesh=mesh,
                                          compress=False)
    n_super = n // sb
    assert man["n_super"] == n_super
    assert len(man["completed"]) == n_super * (n_super + 1) // 2  # 528
    rng = np.random.default_rng(11)
    _sampled_stripes(out, packed, sb, ((0, 0), (0, n_super - 1), (n_super - 1, n_super - 1)),
                     48, rng)
    with np.load(stripe_path(out, 3, 17)) as z:  # a summary-skipped stripe
        assert z["tiles"].shape[0] == 0
    t0 = time.time()
    man2 = distributed_stream_count_matrix(bm, out, superblock_rows=sb, mesh=mesh,
                                           compress=False)
    assert len(man2["completed"]) == len(man["completed"])
    assert time.time() - t0 < 60, "resume recomputed stripes"


def test_scale_rehearsal_n1m_distributed_stream(tmp_path, mesh):
    import mmap

    from stormtpu_torch.io import load_bitmatrix_mmap, save_bitmatrix_mmap
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.parallel import distributed_stream_count_matrix
    from stormtpu_torch.stream import stripe_path

    n, m, sb = 1_048_576, 512, 8192
    packed = _banded_packed(n, m // 32, sb, seed=1048576)
    save_bitmatrix_mmap(BitMatrix.from_packed(packed, m_bits=m), str(tmp_path / "panel"))
    bm = load_bitmatrix_mmap(str(tmp_path / "panel"))  # the memmap tier
    assert isinstance(bm.packed.base, (np.memmap, mmap.mmap))
    out = str(tmp_path / "stripes1m")
    t0 = time.time()
    man = distributed_stream_count_matrix(bm, out, superblock_rows=sb, mesh=mesh,
                                          compress=False)
    wall = time.time() - t0
    n_super = n // sb
    assert man["n_super"] == n_super == 128
    assert len(man["completed"]) == n_super * (n_super + 1) // 2  # 8256
    rng = np.random.default_rng(13)
    _sampled_stripes(out, packed, sb, ((0, 0), (0, n_super - 1), (n_super - 1, n_super - 1)),
                     32, rng)
    with np.load(stripe_path(out, 5, 99)) as z:  # a summary-skipped stripe
        assert z["tiles"].shape[0] == 0
    t0 = time.time()
    man2 = distributed_stream_count_matrix(bm, out, superblock_rows=sb, mesh=mesh,
                                           compress=False)
    resume_s = time.time() - t0
    assert len(man2["completed"]) == len(man["completed"])
    assert resume_s < 120, f"resume recomputed stripes ({resume_s:.0f}s)"
    print(f"[scale1m] distributed stream: wall {wall:.1f}s, resume {resume_s:.1f}s, "
          f"peak RSS {_rss_mb():.0f} MB")


def test_scale_rehearsal_n1m_stream_topk_resume(tmp_path, cuda):
    from stormtpu_torch.io import load_bitmatrix_mmap, save_bitmatrix_mmap
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.stream_query import stream_topk_neighbors

    n, m, k, sb = 1_048_576, 512, 4, 8192
    packed = _banded_packed(n, m // 32, sb, seed=2097152)
    save_bitmatrix_mmap(BitMatrix.from_packed(packed, m_bits=m), str(tmp_path / "panel"))
    bm = load_bitmatrix_mmap(str(tmp_path / "panel"))
    out = str(tmp_path / "topk1m")
    t0 = time.time()
    vals, idx = stream_topk_neighbors(bm, k, superblock_rows=sb, out_dir=out, device=cuda)
    wall = time.time() - t0
    assert vals.shape == (n, k) and idx.shape == (n, k)
    band_rows = np.concatenate([np.arange(sb), np.arange(n - sb, n)])
    band = packed[band_rows]
    rng = np.random.default_rng(7)
    for r in map(int, rng.choice(band_rows, 32, replace=False)):
        c = np.bitwise_count(band & packed[r]).sum(axis=1, dtype=np.int64)
        c[band_rows == r] = -1
        np.testing.assert_array_equal(vals[r], np.maximum(-np.sort(-c)[:k], 0), err_msg=str(r))
    assert not vals[sb : n - sb].any() and not idx[sb : n - sb].any()
    t0 = time.time()
    vals2, idx2 = stream_topk_neighbors(bm, k, superblock_rows=sb, out_dir=out, device=cuda)
    resume_s = time.time() - t0
    assert resume_s < 120, f"resume recomputed stripes ({resume_s:.0f}s)"
    np.testing.assert_array_equal(vals, vals2)
    np.testing.assert_array_equal(idx, idx2)
    print(f"[scale1m] stream topk: wall {wall:.1f}s, resume {resume_s:.1f}s, "
          f"peak RSS {_rss_mb():.0f} MB")


def test_scale_rehearsal_n1m_sparse_k4_walk(tmp_path, cuda):
    from stormtpu_torch.native import have_native
    from stormtpu_torch.stream import stream_count_matrix, stripe_path

    assert have_native(), "the K4 walk needs the C++ host tier"
    n, m, sb = 1_048_576, 512, 8192
    bm, positions, _ = _sparse_panel(n, m, 52_000, seed=31415)
    out = str(tmp_path / "sparse1m")
    t0 = time.time()
    man = stream_count_matrix(bm, out, superblock_rows=sb, kernel="sparse_outer",
                              compress=False, device=cuda)
    wall = time.time() - t0
    n_super = n // sb
    assert man["n_super"] == n_super
    assert man["stripe_kernels"]["k4"] == n_super * (n_super + 1) // 2
    want = _pair_counts(positions, diagonal=True)
    got: dict = {}
    for i, j in man["completed"]:
        with np.load(stripe_path(out, i, j)) as z:
            for a, b, v in zip(z["coo_i"], z["coo_j"], z["coo_v"]):
                gi, gj = i * sb + int(a), j * sb + int(b)
                if gi <= gj:  # diagonal stripes carry the mirrored square
                    got[(gi, gj)] = int(v)
    assert got == dict(want), f"COO mismatch: {len(got)} got vs {len(want)} want"
    t0 = time.time()
    stream_count_matrix(bm, out, superblock_rows=sb, kernel="sparse_outer", compress=False,
                        device=cuda)
    resume_s = time.time() - t0
    assert resume_s < 120, f"resume recomputed stripes ({resume_s:.0f}s)"
    print(f"[scale1m] sparse K4 walk: wall {wall:.1f}s, resume {resume_s:.1f}s, "
          f"peak RSS {_rss_mb():.0f} MB, {len(got)} nonzero pairs")


def test_scale_rehearsal_n1m_sparse_queries(tmp_path, cuda):
    from stormtpu_torch.native import have_native
    from stormtpu_torch.stream_query import stream_pairs_above, stream_topk_neighbors

    assert have_native(), "the K4 walk needs the C++ host tier"
    n, m, sb, k = 1_048_576, 512, 8192, 4
    bm, positions, rng = _sparse_panel(n, m, 52_000, seed=27182)
    want = _pair_counts(positions, diagonal=False)
    t0 = time.time()
    vals, idx = stream_topk_neighbors(bm, k, superblock_rows=sb, kernel="auto", device=cuda)
    wall_topk = time.time() - t0
    assert vals.shape == (n, k)
    partners: dict = defaultdict(list)
    for (a, b), v in want.items():
        partners[a].append((v, b))
        partners[b].append((v, a))
    hot = sorted(partners, key=lambda r: -len(partners[r]))[:16]
    for r in hot + [int(x) for x in rng.choice(list(partners), 32)]:
        ps = sorted(partners[r], key=lambda t: -t[0])[:k]
        want_vals = np.zeros(k, dtype=np.int64)
        want_vals[: len(ps)] = [v for v, _ in ps]
        np.testing.assert_array_equal(vals[r], want_vals, err_msg=f"row {r}")
        for t in range(len(ps)):
            assert idx[r, t] != r and _count(bm.packed, r, idx[r, t]) == vals[r, t]
    for r in (r for r in range(0, n, 65537) if r not in partners):
        assert not vals[r].any() and not idx[r].any()  # the (0, 0) convention
    t0 = time.time()
    ii, jj, vv = stream_pairs_above(bm, 1, superblock_rows=sb, kernel="auto", device=cuda)
    wall_screen = time.time() - t0
    got = {(int(a), int(b)): int(v) for a, b, v in zip(ii, jj, vv)}
    assert got == dict(want), f"screen mismatch: {len(got)} got vs {len(want)} want"
    print(f"[scale1m] sparse queries: topk {wall_topk:.1f}s, screen {wall_screen:.1f}s, "
          f"peak RSS {_rss_mb():.0f} MB, {len(want)} true pairs")


def test_scale_rehearsal_n1m_sparse_aggregate_stats(tmp_path, cuda):
    from stormtpu_torch.native import have_native
    from stormtpu_torch.stats import count_histogram, count_row_sums

    assert have_native(), "the K4 walk needs the C++ host tier"
    n, m, sb = 1_048_576, 512, 8192
    bm, positions, rng = _sparse_panel(n, m, 52_000, seed=16180)
    want = _pair_counts(positions, diagonal=False)
    n_bins = 8
    t0 = time.time()
    man = count_histogram(bm, n_bins=n_bins, bin_width=1, superblock_rows=sb, method="auto",
                          device=cuda)
    wall_hist = time.time() - t0
    assert man["kernel"] == "sparse_outer", man["kernel"]
    assert man["stripe_kernels"]["dense"] == 0
    want_h = np.zeros(n_bins, dtype=np.int64)
    for v in want.values():
        want_h[min(v, n_bins - 1)] += 1
    want_h[0] = n * (n - 1) // 2 - sum(want_h[1:])
    np.testing.assert_array_equal(man["hist"], want_h)
    t0 = time.time()
    sums = count_row_sums(bm, device=cuda)
    wall_rs = time.time() - t0
    row_mass = defaultdict(int)
    for (a, b), v in want.items():
        row_mass[a] += v
        row_mass[b] += v
    row_nnz = defaultdict(int)
    for r, _ in positions:
        row_nnz[r] += 1
    hot = sorted(row_mass, key=lambda r: -row_mass[r])[:16]
    for r in hot + [int(x) for x in rng.choice(list(row_nnz), 32)]:
        assert sums[r] == row_mass[r] + row_nnz[r], r
    zero_rows = [r for r in range(0, n, 65537) if r not in row_nnz]
    assert not sums[zero_rows].any()
    print(f"[scale1m] sparse aggregates: hist {wall_hist:.1f}s (all K4, {len(want)} nonzero "
          f"pairs), row sums {wall_rs:.1f}s, peak RSS {_rss_mb():.0f} MB")


def test_scale_rehearsal_n1m_banded_aggregate_stats(tmp_path, mesh):
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.parallel import distributed_count_histogram, distributed_count_row_sums
    from stormtpu_torch.stats import count_row_sums

    n, m, sb = 1_048_576, 512, 8192
    packed = _banded_packed(n, m // 32, sb, seed=31337)
    bm = BitMatrix.from_packed(packed, m_bits=m)
    band_rows = np.concatenate([np.arange(sb), np.arange(n - sb, n)])
    band = packed[band_rows]
    n_bins = 16
    t0 = time.time()
    man = distributed_count_histogram(bm, n_bins=n_bins, mesh=mesh, superblock_rows=sb)
    wall_hist = time.time() - t0
    assert man["kernel"] == "stripes", man["kernel"]
    n_super = n // sb
    assert man["stripes_skipped"] == n_super * (n_super + 1) // 2 - 3
    # exact pair counts over the 16,384 band rows (float32 products of
    # counts ≤ 512 are exact), strict upper triangle in band order
    unpacked = np.unpackbits(band.view(np.uint8), axis=1, bitorder="little").astype(np.float32)
    bw = man["bin_width"]
    want_h = np.zeros(n_bins, dtype=np.int64)
    nb = band.shape[0]
    for r0 in range(0, nb, 2048):
        c = (unpacked[r0 : r0 + 2048] @ unpacked.T).astype(np.int64)
        li = np.arange(r0, min(r0 + 2048, nb))[:, None]
        vals = c[li < np.arange(nb)[None, :]]
        want_h += np.bincount(np.minimum(vals // bw, n_bins - 1), minlength=n_bins)
    want_h[0] += n * (n - 1) // 2 - nb * (nb - 1) // 2
    np.testing.assert_array_equal(man["hist"], want_h)
    t0 = time.time()
    sums = count_row_sums(bm, device=mesh.device)
    wall_rs = time.time() - t0
    rng = np.random.default_rng(9)
    for r in map(int, rng.choice(band_rows, 32, replace=False)):
        assert sums[r] == int(np.bitwise_count(band & packed[r]).sum()), r
    assert not sums[sb : n - sb].any()
    t0 = time.time()
    dsums = distributed_count_row_sums(bm, mesh=mesh)
    wall_drs = time.time() - t0
    np.testing.assert_array_equal(dsums, sums)
    print(f"[scale1m] banded aggregates: mesh hist {wall_hist:.1f}s (3 occupied stripes), "
          f"row sums {wall_rs:.1f}s / mesh {wall_drs:.1f}s, peak RSS {_rss_mb():.0f} MB")
