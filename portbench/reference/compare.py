"""The comparisons that decide ``correct``. Each returns a whole number of
wrong answers, held to the limit 0: the counts are exact, so one wrong
count is a wrong answer."""

from __future__ import annotations

import numpy as np


def topk_rows_wrong(ref: np.ndarray, rows: np.ndarray, vals: np.ndarray, idx: np.ndarray,
                    k: int, self_pairs: bool) -> int:
    """Rows whose top-k answer is wrong. ``ref``: int64 [S, N] exact counts
    of each checked row against every candidate partner; ``vals``/``idx``:
    the answer's [S, k] counts and partners, sorted descending.

    A row is right when its counts are the reference's k largest in
    descending order (the order of equal counts is the route's) and its
    partners are k distinct valid rows, not the row itself when
    ``self_pairs`` is False, each with the count given beside it."""
    s, n = ref.shape
    c = ref.copy()
    if not self_pairs:
        c[np.arange(s), rows] = -1
    want = -np.sort(-np.partition(c, n - k, axis=1)[:, n - k:], axis=1)
    vals = np.asarray(vals, dtype=np.int64)
    idx = np.asarray(idx, dtype=np.int64)
    bad = (vals.shape != (s, k)) or (idx.shape != (s, k))
    if bad:
        return s
    wrong = np.any(vals != want, axis=1)
    valid = (idx >= 0) & (idx < n)
    safe = np.where(valid, idx, 0)
    got = np.take_along_axis(c, safe, axis=1)
    wrong |= np.any(~valid | (got != vals), axis=1)
    srt = np.sort(idx, axis=1)
    wrong |= np.any(srt[:, 1:] == srt[:, :-1], axis=1)
    return int(wrong.sum())


def screen_wrong(hits: tuple, threshold: int, n: int, hit_counts_ref: np.ndarray,
                 rows: np.ndarray, ref_rows: np.ndarray) -> tuple[int, int]:
    """(hits_wrong, pairs_missed_or_extra) of a screen's answer ``hits`` =
    (ii, jj, counts), all unordered pairs i < j with count >= threshold.

    ``hit_counts_ref``: the exact count of each listed hit (int64, same
    order); ``rows``/``ref_rows``: sampled rows and their exact counts
    against every row [S, N]. hits_wrong counts listed pairs that are out
    of range, out of order, repeated, below the threshold, or whose count
    differs; pairs_missed_or_extra counts the pairs that touch a sampled
    row and are in one of the answer and the reference but not the other."""
    ii, jj, cc = (np.asarray(x, dtype=np.int64) for x in hits)
    bad = (ii < 0) | (jj >= n) | (ii >= jj) | (cc < threshold) | (cc != hit_counts_ref)
    key = ii * n + jj
    order = np.argsort(key, kind="stable")
    dup = np.zeros(key.size, dtype=bool)
    dup[order[1:]] = key[order[1:]] == key[order[:-1]]
    hits_wrong = int((bad | dup).sum())

    sampled = np.zeros(n, dtype=bool)
    sampled[rows] = True
    ok = (ii >= 0) & (jj < n) & (ii < jj)
    touch = ok & (sampled[np.clip(ii, 0, n - 1)] | sampled[np.clip(jj, 0, n - 1)])
    got = set(key[touch].tolist())
    s_idx, j_idx = np.nonzero(ref_rows >= threshold)
    a = rows[s_idx]
    keep = a != j_idx
    lo = np.minimum(a[keep], j_idx[keep])
    hi = np.maximum(a[keep], j_idx[keep])
    want = set((lo * n + hi).tolist())
    return hits_wrong, len(got ^ want)


def entries_wrong(got, want) -> int:
    """Entries of two equal-shaped count matrices that differ (torch or
    NumPy); a shape mismatch makes every entry wrong."""
    if tuple(got.shape) != tuple(want.shape):
        return int(np.prod(want.shape))
    return int((got != want).sum())
