"""Triangular tile scheduling and result assembly.

Copies of the JAX package's host helpers (``stormtpu/utils/tiling.py``):
the (ib, jb ≥ ib) row-block pair walk that drives the K2 triangular
kernel, and the host-side mirror that turns its upper-triangular tiles
into the full symmetric N×N matrix.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "round_up",
    "next_pow2",
    "quantize_bucket",
    "triangular_tile_ids",
    "assemble_triangular",
]


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ max(x, 8) — the coarse shape quantizer
    (log₂ distinct shapes; up to 2× padding)."""
    return 1 << max(3, (max(x, 1) - 1).bit_length())


def quantize_bucket(x: int, min_val: int = 8) -> int:
    """Smallest value ≥ max(x, min_val) of the form m·2^e with m ∈ [8, 16)
    (1/8-octave buckets): a bounded shape count (~8 per octave) with at
    most 12.5% padding."""
    x = max(x, min_val, 1)
    e = max(0, x.bit_length() - 4)
    return (-(-x >> e)) << e


def triangular_tile_ids(nb: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-block pair ids (ibs, jbs) int32 [T] for the upper triangle
    including the diagonal, T = nb·(nb+1)/2, ordered i-major."""
    ib, jb = np.triu_indices(nb)
    return ib.astype(np.int32), jb.astype(np.int32)


def assemble_triangular(
    tiles: np.ndarray, ibs: np.ndarray, jbs: np.ndarray, nb: int, n: int
) -> np.ndarray:
    """Scatter T upper-triangular [TI, TJ] count tiles into the full
    symmetric N×N matrix (C[i,j] = C[j,i]; mirror instead of recompute)."""
    t, ti, tj = tiles.shape
    grid = np.zeros((nb, nb, ti, tj), dtype=tiles.dtype)
    grid[ibs, jbs] = tiles
    full = grid.transpose(0, 2, 1, 3).reshape(nb * ti, nb * tj)
    upper = np.triu(full)
    out = upper + np.triu(full, 1).T
    return out[:n, :n]
