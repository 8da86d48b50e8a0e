"""Helpers of the JAX package's ``stream_query.py`` that the one-matrix
queries and histograms share: the per-superblock occupancy summary that
lets a histogram walk skip co-empty stripes, and the host-side top-k
merge of the cross queries.

The streamed queries themselves (``stream_topk_neighbors``,
``stream_pairs_above``, ``stream_pairs_above_complete`` and their
``extend_*`` forms) are not ported yet; they come in a later slice of the
port (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stormtpu_torch.layout import BitMatrix

__all__: list[str] = []


def _superblock_occupancy(bm: BitMatrix, n_pad: int, sb: int) -> Optional[np.ndarray]:
    """Per-superblock K-group occupancy bool [n_super, G] (the block
    summary OR-reduced per superblock, 128-word groups), read-only. None for
    an empty shape. A single group still skips stripes between entirely
    empty superblocks. Cached on the matrix per (n_pad, sb), as the K5
    occupancy is: the summary is a pass over every packed word (13 GB at
    100,000 × 1,048,576 bits), and a BitMatrix does not change once
    built."""
    if not (bm.n and bm.n_words):
        return None
    cache = bm.__dict__.setdefault("_superblock_occ_cache", {})
    occ = cache.get((n_pad, sb))
    if occ is None:
        occ_rows = bm.block_summary(block_bits=128 * 32).astype(bool)
        full = np.zeros((n_pad, occ_rows.shape[1]), dtype=bool)
        full[: bm.n] = occ_rows
        occ = full.reshape(n_pad // sb, sb, -1).any(axis=1)
        occ.setflags(write=False)
        cache[(n_pad, sb)] = occ
    return occ


def _merge_topk(
    best_v: np.ndarray,
    best_i: np.ndarray,
    sl: slice,
    cand_v: np.ndarray,
    cand_i: np.ndarray,
    k: int,
) -> None:
    """Keep the k best of (current best ∪ candidates) per row, in place.

    Deduplicates by partner index (keeping the best-valued copy), so a
    re-merged candidate cannot seat the same partner twice in a row's
    top-k. Fill entries (−1 counts / −inf measures) never collapse: each
    gets a unique surrogate key."""
    cv = np.concatenate([best_v[sl], cand_v], axis=1)
    ci = np.concatenate([best_i[sl], cand_i], axis=1)
    # value-desc first (stable) so the best copy of each partner leads
    order = np.argsort(-cv, axis=1, kind="stable")
    cv = np.take_along_axis(cv, order, axis=1)
    ci = np.take_along_axis(ci, order, axis=1)
    fill = (cv < 0) if cv.dtype.kind == "i" else np.isneginf(cv)
    w = cv.shape[1]
    key = np.where(fill, -(np.arange(w, dtype=np.int64)[None, :] + 1),
                   ci.astype(np.int64))
    korder = np.argsort(key, axis=1, kind="stable")
    ks = np.take_along_axis(key, korder, axis=1)
    dup_sorted = np.zeros_like(fill)
    dup_sorted[:, 1:] = ks[:, 1:] == ks[:, :-1]
    dup = np.zeros_like(fill)
    np.put_along_axis(dup, korder, dup_sorted, axis=1)
    if dup.any():
        cv = np.where(dup, cv.dtype.type(-1) if cv.dtype.kind == "i"
                      else -np.inf, cv)
        ci = np.where(dup, 0, ci)
        order2 = np.argsort(-cv, axis=1, kind="stable")
        cv = np.take_along_axis(cv, order2, axis=1)
        ci = np.take_along_axis(ci, order2, axis=1)
    best_v[sl] = cv[:, :k]
    best_i[sl] = ci[:, :k]
