"""Exact NumPy ground truth (a copy of the JAX package's oracle).

Counts are exact integers, so equality — not tolerance — is the test.
"""

from __future__ import annotations

import numpy as np

__all__ = ["oracle_pair_count", "oracle_count_matrix", "oracle_count_block"]


def oracle_pair_count(a_packed: np.ndarray, b_packed: np.ndarray) -> int:
    """popcount(a AND b) for two packed uint32 rows."""
    a = np.asarray(a_packed, dtype=np.uint32)
    b = np.asarray(b_packed, dtype=np.uint32)
    return int(np.bitwise_count(a & b).sum(dtype=np.int64))


def oracle_count_block(
    a_packed: np.ndarray, b_packed: np.ndarray
) -> np.ndarray:
    """Cross-block counts: int64 [Na, Nb] for packed [Na, W] × [Nb, W]."""
    a = np.asarray(a_packed, dtype=np.uint32)
    b = np.asarray(b_packed, dtype=np.uint32)
    na, w = a.shape
    nb, _ = b.shape
    out = np.empty((na, nb), dtype=np.int64)
    for i in range(na):
        out[i] = np.bitwise_count(a[i][None, :] & b).sum(axis=1, dtype=np.int64)
    return out


def oracle_count_matrix(packed: np.ndarray) -> np.ndarray:
    """Full N×N pairwise intersection-count matrix, int64."""
    return oracle_count_block(packed, packed)
