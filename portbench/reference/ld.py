"""The r² screen's reference: each pair's r² ≥ t decided exactly in
integers, with its float64 r² beside it, and the comparison that judges a
screen's answer.

r² = (M·c − a·b)² / (a(M−a)·b(M−b)) for a pair of count c whose rows hold
a and b of the M bits; r² ≥ t_num/t_den exactly when t_den·(M·c − a·b)² ≥
t_num·a(M−a)·b(M−b), compared in 128-bit integers (two uint64 halves:
(M·c)² reaches 2**80 at M = 2**20). A row with no or every bit set has no
r² and is in no hit.
"""

from __future__ import annotations

import numpy as np

_LO32 = np.uint64(0xFFFFFFFF)

#: the relative distance allowed between an answer's float64 r² and the
#: reference's: the two round differently (the program squares a square
#: root; here the squared difference is divided by the product), a few ulp
R2_RELATIVE = 1e-12


def _mul128(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(high, low) uint64 halves of x·y for nonnegative int64 x, y < 2**63."""
    x, y = x.astype(np.uint64), y.astype(np.uint64)
    x0, x1, y0, y1 = x & _LO32, x >> np.uint64(32), y & _LO32, y >> np.uint64(32)
    lo = x0 * y0
    mid = x1 * y0 + x0 * y1  # < 2**64: each term < 2**63
    low = lo + (mid << np.uint64(32))
    high = x1 * y1 + (mid >> np.uint64(32)) + (low < lo).astype(np.uint64)
    return high, low


def ratio(threshold: float) -> tuple[int, int]:
    """(t_num, t_den): the threshold as the fraction it was written as."""
    from fractions import Fraction

    f = Fraction(str(threshold))
    return f.numerator, f.denominator


def r2_decide(c, a, b, m_bits: int, threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """(hit bool, float64 r²) of pairs with count ``c`` and row counts
    ``a``, ``b``, elementwise."""
    if m_bits > 1 << 30:
        raise ValueError("the 128-bit products hold M up to 2**30")
    t_num, t_den = ratio(threshold)
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


def sampled_hits(rows: np.ndarray, ref_rows: np.ndarray, row_counts: np.ndarray, n: int,
                 m_bits: int, threshold: float, block: int = 32) -> set:
    """The pairs i < j (as i·n + j) with r² ≥ threshold that touch a
    sampled row, from ``ref_rows``: the sampled rows' exact counts against
    every row [S, N]; decided a block of sampled rows at a time."""
    want: set = set()
    for s0 in range(0, rows.size, block):
        got = ref_rows[s0 : s0 + block]
        s_idx, j_idx = np.nonzero(got >= 0)
        a_row = rows[s0 + s_idx]
        hit, _ = r2_decide(got[s_idx, j_idx], row_counts[a_row], row_counts[j_idx], m_bits,
                           threshold)
        a_row, j_idx = a_row[hit], j_idx[hit]
        keep = a_row != j_idx
        lo = np.minimum(a_row[keep], j_idx[keep])
        hi = np.maximum(a_row[keep], j_idx[keep])
        want.update((lo * n + hi).tolist())
    return want


def screen_wrong(hits: tuple, n: int, m_bits: int, threshold: float, row_counts: np.ndarray,
                 hit_counts: np.ndarray, rows: np.ndarray, want: set) -> tuple[int, int]:
    """(hits_wrong, pairs_missed_or_extra) of an r² screen's answer ``hits``
    = (ii, jj, r²), all unordered pairs i < j with r² ≥ threshold.

    ``row_counts``: every row's count; ``hit_counts``: the exact count of
    each listed hit (same order); ``rows``: the sampled rows, and ``want``
    the reference's pairs touching them (:func:`sampled_hits`). hits_wrong
    counts listed pairs out of range, out of order or repeated, whose exact
    r² is below the threshold, or whose r² differs from the reference's by
    more than ``R2_RELATIVE`` of it; pairs_missed_or_extra the pairs
    touching a sampled row that are in one of the answer and the reference
    only."""
    ii, jj = (np.asarray(x, dtype=np.int64) for x in hits[:2])
    vv = np.asarray(hits[2], dtype=np.float64)
    ok = (ii >= 0) & (jj < n) & (ii < jj)
    a = row_counts[np.clip(ii, 0, n - 1)]
    b = row_counts[np.clip(jj, 0, n - 1)]
    hit, r2 = r2_decide(hit_counts, a, b, m_bits, threshold)
    bad = ~ok | ~hit | ~(np.abs(vv - r2) <= R2_RELATIVE * r2)
    key = ii * n + jj
    order = np.argsort(key, kind="stable")
    dup = np.zeros(key.size, dtype=bool)
    dup[order[1:]] = key[order[1:]] == key[order[:-1]]
    hits_wrong = int((bad | dup).sum())

    sampled = np.zeros(n, dtype=bool)
    sampled[rows] = True
    touch = ok & (sampled[np.clip(ii, 0, n - 1)] | sampled[np.clip(jj, 0, n - 1)])
    return hits_wrong, len(set(key[touch].tolist()) ^ want)
