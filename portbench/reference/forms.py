"""Plain forms of the answers, from exact (or control) counts: what the
reference puts in the program's place."""

from __future__ import annotations

import numpy as np


def topk_of(c: np.ndarray, rows: np.ndarray, k: int, self_pairs: bool):
    """(vals, idx) [S, k]: the k largest counts of each row of ``c``
    [S, N] and their columns, descending; row s's own column ``rows[s]``
    left out unless ``self_pairs``."""
    c = c.copy()
    if not self_pairs:
        c[np.arange(c.shape[0]), rows] = -1
    idx = np.argpartition(-c, k - 1, axis=1)[:, :k]
    v = np.take_along_axis(c, idx, axis=1)
    o = np.argsort(-v, axis=1, kind="stable")
    return np.take_along_axis(v, o, axis=1), np.take_along_axis(idx, o, axis=1)


def screen_hits(c: np.ndarray, rows: np.ndarray, n: int, threshold: int):
    """(ii, jj, counts) of the unordered pairs i < j with count >=
    ``threshold`` that touch the rows of ``c`` [S, N], row-major."""
    s_idx, j_idx = np.nonzero(c >= threshold)
    a = rows[s_idx]
    keep = a != j_idx
    lo, hi = np.minimum(a[keep], j_idx[keep]), np.maximum(a[keep], j_idx[keep])
    val = c[s_idx[keep], j_idx[keep]]
    key, first = np.unique(lo * n + hi, return_index=True)
    return key // n, key % n, val[first]
