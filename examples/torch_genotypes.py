"""End-to-end genotype-panel workflow on the PyTorch/CUDA port: PLINK
ingest → LD screen → missing-data r² → query-panel lookup → aggregates →
clumping → panel growth (the counterpart of ``examples/genotypes.py``).

Run: python examples/torch_genotypes.py [--device cpu]

The script writes its own small PLINK1 ``.bed`` and holds every result to
NumPy: counts and screens exactly, the pairwise-complete r² (whose NumPy
form sums in another order) to within 1e-12. The last line says that all
checks passed.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def r2_of(inter, ca, cb, m):
    """r² from integer counts, in the order the engine's formulas take (0
    where the denominator is 0)."""
    inter, ca, cb, m = (np.asarray(x, dtype=np.float64) for x in (inter, ca, cb, m))
    num = m * inter - ca * cb
    den = np.sqrt(ca * cb * (m - ca) * (m - cb))
    num, den = num * num, den * den
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


def products(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact int64 a·bᵀ of 0/1 rows (float32 is exact below 2^24)."""
    return (a.astype(np.float32) @ b.astype(np.float32).T).astype(np.int64)


def write_bed(path: str, codes: np.ndarray) -> None:
    """A SNP-major PLINK1 .bed of 2-bit codes (variants × samples)."""
    n_variants, n_samples = codes.shape
    padded = np.zeros((n_variants, -(-n_samples // 4) * 4), dtype=np.uint8)
    padded[:, :n_samples] = codes
    quads = padded.reshape(n_variants, -1, 4)
    body = quads[..., 0] | quads[..., 1] << 2 | quads[..., 2] << 4 | quads[..., 3] << 6
    with open(path, "wb") as f:
        f.write(b"\x6c\x1b\x01" + body.astype(np.uint8).tobytes())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, default) or 'cpu'")
    dev = ap.parse_args(argv).device

    from stormtpu_torch import (
        BitMatrix,
        clump,
        count_histogram,
        count_row_sums,
        cross_topk_neighbors,
        pairs_above,
        pairs_above_complete,
        similarity_matrix_complete,
        unpack_bits,
    )
    from stormtpu_torch.io import load_plink_bed
    from stormtpu_torch.stream_query import extend_stream_pairs_above, stream_pairs_above

    # --- write a small synthetic PLINK1 .bed (SNP-major) ----------------
    rng = np.random.default_rng(1)
    n_variants, n_samples = 300, 257
    # 2-bit codes: 0 hom-A1, 1 missing, 2 het, 3 hom-A2 (~5% missing)
    codes = rng.choice([0, 2, 3], size=(n_variants, n_samples), p=[0.55, 0.3, 0.15])
    codes[rng.random(codes.shape) < 0.05] = 1
    for v in range(11, 15):  # an LD block: variants 10..14 copy variant 10
        codes[v] = codes[10]
    work = tempfile.mkdtemp()
    bed = os.path.join(work, "panel.bed")
    write_bed(bed, codes)

    # --- ingest: carrier bitmaps + observed-mask bitmaps ----------------
    carriers = load_plink_bed(bed, n_samples, n_variants)  # ≥1 A2 allele
    missing = load_plink_bed(bed, n_samples, n_variants, encode="missing")
    car = (codes >= 2).astype(np.uint8)
    obs = (codes != 1).astype(np.uint8)
    assert np.array_equal(unpack_bits(carriers.packed, n_samples), car)
    assert np.array_equal(unpack_bits(missing.packed, n_samples), 1 - obs)
    mask = BitMatrix.from_dense(obs)
    c = products(car, car)
    nnz = np.diag(c)

    # --- LD screen: r² over the fully-observed approximation ------------
    ii, jj, r2 = pairs_above(carriers, 0.8, measure="r2", device=dev)
    full = r2_of(c, nnz[:, None], nnz[None, :], n_samples)
    wi, wj = np.nonzero(np.triu(full, 1) >= 0.8)
    assert np.array_equal(ii, wi) and np.array_equal(jj, wj) and np.array_equal(r2, full[wi, wj])
    block = sorted((a, b) for a, b in zip(ii.tolist(), jj.tolist()) if 10 <= a <= 14 and b <= 14)
    assert block == [(a, b) for a in range(10, 15) for b in range(a + 1, 15)]
    print(f"LD screen (r² ≥ 0.8): {ii.size} pairs, the planted block's ten among them")

    # --- exact missing-data handling: pairwise-complete r² --------------
    r2c = similarity_matrix_complete(carriers, mask, "r2", device=dev)
    # per pair: co-observed samples m, carriers of each among them, both
    ca, cb, m = products(car, obs), products(obs, car), products(obs, obs)
    den = (ca * cb * (m - ca) * (m - cb)).astype(np.float64)
    want_c = np.where(den > 0, (m * c - ca * cb) ** 2 / np.where(den > 0, den, 1.0), 0.0)
    assert np.allclose(r2c, want_c, rtol=0, atol=1e-12)
    ci, cj, cr2 = pairs_above_complete(carriers, mask, 0.8, measure="r2", device=dev)
    ewi, ewj = np.nonzero(np.triu(want_c, 1) >= 0.8)
    assert np.array_equal(ci, ewi) and np.array_equal(cj, ewj)
    assert np.allclose(cr2, want_c[ewi, ewj], rtol=0, atol=1e-12)
    print(f"pairwise-complete r²(10, 11) = {r2c[10, 11]:.4f}; screen (r² ≥ 0.8): {ci.size} pairs")

    # --- query panel lookup: new variants against the reference panel ---
    q = (codes[rng.choice(n_variants, 8, replace=False)] >= 2).astype(np.uint8)
    vals, idx = cross_topk_neighbors(BitMatrix.from_dense(q), carriers, k=3, device=dev)
    cq = products(q, car)
    assert np.array_equal(vals, -np.sort(-cq, axis=1)[:, :3])
    assert np.array_equal(cq[np.arange(8)[:, None], idx], vals)
    assert all(len(set(r.tolist())) == 3 for r in idx)
    print("query-panel lookup (top-3 reference variants per query): exact")

    # --- aggregate statistics: marginals / distribution of C without C --
    rs = count_row_sums(carriers, include_self=False, device=dev)
    assert np.array_equal(rs, c.sum(axis=1) - nnz)
    hist = count_histogram(carriers, n_bins=12, device=dev)
    tri = c[np.triu_indices(n_variants, 1)]
    want_h = np.bincount(np.minimum(tri // hist["bin_width"], 11), minlength=12)
    assert np.array_equal(hist["hist"], want_h) and hist["pairs"] == tri.size
    print(f"aggregates: row sums exact, pair-count histogram of {hist['pairs']} pairs exact")

    # --- clumping: collapse the screen into leader-led LD clumps --------
    stat = rng.random(n_variants) * 8  # stand-in association -log10 p
    stat[12] = 9.0                     # a planted-block row leads
    res = clump(carriers, stat, 0.8, measure="r2", device=dev)
    lead = int(res.leaders[0])
    assert lead == 12 and set(range(10, 15)) <= set(res.members(lead).tolist())
    print(f"clumps: {res.n_clumps} over {n_variants} variants; top clump led by {lead} "
          f"with members {res.members(lead).tolist()}")

    # --- panel growth: new variants arrive; the screen extends ----------
    new = (rng.choice([0, 2, 3], size=(60, n_samples), p=[0.55, 0.3, 0.15]) >= 2)
    grown_dense = np.concatenate([car, new.astype(np.uint8)])
    grown = BitMatrix.from_dense(grown_dense)
    ckpt = os.path.join(work, "screen")
    stream_pairs_above(carriers, 0.8, measure="r2", superblock_rows=128, out_dir=ckpt,
                       device=dev)
    gi, gj, gr2 = extend_stream_pairs_above(grown, ckpt, device=dev)
    cg = products(grown_dense, grown_dense)
    fg = r2_of(cg, np.diag(cg)[:, None], np.diag(cg)[None, :], n_samples)
    wgi, wgj = np.nonzero(np.triu(fg, 1) >= 0.8)
    assert np.array_equal(gi, wgi) and np.array_equal(gj, wgj) and np.array_equal(gr2, fg[wgi, wgj])
    print(f"panel growth: {n_variants} -> {grown.n} variants; extended screen has {gi.size} "
          f"pairs, exact")
    print("torch_genotypes: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
