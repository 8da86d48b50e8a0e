"""A plain reference for r² screens of LD panels: the panel made from a
seed, exact pair counts, and each pair's r² ≥ t decided in integers.

- :func:`ld_panel`: N variant rows over M haplotype bits. Each row's
  carrier count a is drawn from the neutral site-frequency spectrum,
  P(a) ∝ 1/a for a = 1 … M−1; rows come in consecutive blocks of
  ``block_rows``, and the carriers of every row of a block are the
  haplotypes that rank below its count in one random order of the M
  haplotypes drawn for that block (carriers nest within a block).
- :func:`pair_counts`: the exact N×N counts as a float32 product of the
  unpacked bits (TF32 off); every partial sum is a whole number below
  2**24, so float32 holds it exactly in any order of summation.
- :func:`r2_decide`: r² = (M·c − a·b)² / (a(M−a)·b(M−b)) ≥ t_num/t_den
  decided exactly, as t_den·(M·c − a·b)² ≥ t_num·a(M−a)·b(M−b) in 128-bit
  integers (two uint64 halves: (M·c)² reaches 2**80 at M = 2**20), with
  the float64 r² beside it.

Plain NumPy and torch: it imports no JAX and nothing of ``stormtpu_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

_LO32 = np.uint64(0xFFFFFFFF)


def spectrum_counts(rng: np.random.Generator, n: int, m_bits: int) -> np.ndarray:
    """int64 [n] carrier counts from P(a) ∝ 1/a, a = 1 … m_bits − 1, by
    the inverse of its CDF."""
    cdf = np.cumsum(1.0 / np.arange(1, m_bits, dtype=np.float64))
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(n)), m_bits - 2) + 1


def ld_panel(seed: int, n: int, m_bits: int, block_rows: int = 32) -> np.ndarray:
    """uint32 [n, m_bits / 32] packed rows (bit p of a row at word p >> 5,
    bit p & 31) of a nested-block LD panel made from ``seed``."""
    if m_bits % 32:
        raise ValueError("m_bits must be a multiple of 32")
    rng = np.random.default_rng(seed)
    counts = spectrum_counts(rng, n, m_bits)
    packed = np.empty((n, m_bits // 32), dtype=np.uint32)
    for r0 in range(0, n, block_rows):
        rank = rng.permutation(m_bits)
        bits = rank[None, :] < counts[r0 : r0 + block_rows, None]
        packed[r0 : r0 + block_rows] = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    return packed


def unpack(packed: np.ndarray) -> torch.Tensor:
    """uint32 [r, W] → float32 [r, 32·W] of 0/1."""
    bits = np.unpackbits(np.ascontiguousarray(packed).view(np.uint8), axis=1,
                         bitorder="little")
    return torch.from_numpy(bits).to(torch.float32)


def pair_counts(packed: np.ndarray, block_rows: int = 512) -> np.ndarray:
    """int64 [n, n]: popcount(x_i AND x_j), a float32 product of the
    unpacked bits with TF32 off, a block of rows at a time."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        n = packed.shape[0]
        out = np.empty((n, n), dtype=np.int64)
        whole = unpack(packed)
        for r0 in range(0, n, block_rows):
            out[r0 : r0 + block_rows] = (whole[r0 : r0 + block_rows] @ whole.T).round().to(
                torch.int64).numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _mul128(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(high, low) uint64 halves of x·y for nonnegative int64 x, y < 2**63."""
    x, y = x.astype(np.uint64), y.astype(np.uint64)
    x0, x1, y0, y1 = x & _LO32, x >> np.uint64(32), y & _LO32, y >> np.uint64(32)
    lo = x0 * y0
    mid = x1 * y0 + x0 * y1  # < 2**64: each term < 2**63
    low = lo + (mid << np.uint64(32))
    high = x1 * y1 + (mid >> np.uint64(32)) + (low < lo).astype(np.uint64)
    return high, low


def r2_decide(c: np.ndarray, a: np.ndarray, b: np.ndarray, m_bits: int,
              t_num: int = 4, t_den: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """(hit bool, float64 r²) of pairs with count ``c`` and row counts
    ``a``, ``b`` over ``m_bits`` bits: hit where both rows vary (0 < a, b <
    M) and t_den·(M·c − a·b)² ≥ t_num·a(M−a)·b(M−b), exactly."""
    if m_bits > 1 << 30:
        raise ValueError("the 128-bit products hold M up to 2**30")
    c, a, b = (np.asarray(v, dtype=np.int64) for v in (c, a, b))
    m = np.int64(m_bits)
    x = np.abs(m * c - a * b)
    u, v = a * (m - a), b * (m - b)
    lh, ll = _mul128(t_den * x, x)
    rh, rl = _mul128(t_num * u, v)
    hit = (u > 0) & (v > 0) & ((lh > rh) | ((lh == rh) & (ll >= rl)))
    den = u.astype(np.float64) * v.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where(den > 0, x.astype(np.float64) ** 2 / np.where(den > 0, den, 1.0), 0.0)
    return hit, r2


def r2_hits(counts: np.ndarray, row_nnz: np.ndarray, m_bits: int, t_num: int = 4,
            t_den: int = 5) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ii, jj, r²) of every pair i < j with r² ≥ t_num/t_den, row-major,
    from the exact counts [n, n]."""
    ii, jj = np.triu_indices(counts.shape[0], 1)
    hit, r2 = r2_decide(counts[ii, jj], row_nnz[ii], row_nnz[jj], m_bits, t_num, t_den)
    return ii[hit], jj[hit], r2[hit]
