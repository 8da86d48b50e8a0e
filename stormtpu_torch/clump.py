"""Greedy leader clumping over a similarity screen, PLINK ``--clump``
shape (port of ``stormtpu/clump.py``).

The downstream step of an LD screen: partition rows (variants) into groups
led by the most significant row, absorbing every unassigned row whose
similarity with the leader clears a threshold.

- :func:`clump` — one call: :func:`stormtpu_torch.query.pairs_above`
  (device screen, float32 slack and exact float64 host refine) then the
  grouping.
- :func:`clump_from_pairs` — host-only grouping from any ``(ii, jj)``
  pair list (the pairwise-complete screen's, or user-filtered pairs).
  Deterministic, O(N + E).

Greedy semantics:

1. Rows are visited in order of ``stat`` descending, ties by row index
   ascending.
2. A visited row that is not yet assigned becomes a leader (its own
   clump, ``leader[i] = i``).
3. Every still-unassigned neighbour (a row that shares a screened pair
   with the leader) joins that clump at once; assigned rows are never
   revisited as leaders and never reassigned.

Every row ends up in exactly one clump; a row with no qualifying pair
leads a clump of itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["ClumpResult", "clump", "clump_from_pairs"]


@dataclass(frozen=True)
class ClumpResult:
    """Result of a greedy clumping pass.

    leader[i] is the row index of i's clump leader (``leader[i] == i``
    iff i leads its clump — including singletons). ``leaders`` lists the
    leaders in assignment order (stat-descending), so ``leaders[0]`` is
    the most significant row overall.
    """

    leader: np.ndarray    # int64 [N]
    leaders: np.ndarray   # int64 [num_clumps], assignment order

    @property
    def n_clumps(self) -> int:
        return int(self.leaders.size)

    def members(self, lead: int) -> np.ndarray:
        """All rows in the clump led by ``lead`` (including the leader),
        ascending row order."""
        return np.flatnonzero(self.leader == lead).astype(np.int64)

    def sizes(self) -> np.ndarray:
        """Clump sizes aligned with ``leaders``."""
        counts = np.bincount(self.leader, minlength=self.leader.size)
        return counts[self.leaders].astype(np.int64)


def clump_from_pairs(
    ii: Sequence[int],
    jj: Sequence[int],
    stat: Sequence[float],
    n: Optional[int] = None,
) -> ClumpResult:
    """Greedy leader clumping from an explicit pair list.

    ``(ii, jj)`` are the endpoints of every qualifying pair (unordered;
    duplicates and either orientation are fine — they are symmetrized).
    ``stat`` is the per-row significance (higher = visited first, e.g.
    -log10 p). ``n`` defaults to ``len(stat)``.
    """
    stat = np.asarray(stat, dtype=np.float64)
    if stat.ndim != 1:
        raise ValueError(f"stat must be 1-D, got shape {stat.shape}")
    if n is None:
        n = stat.size
    if stat.size != n:
        raise ValueError(f"stat has {stat.size} entries for n={n} rows")
    ii = np.asarray(ii, dtype=np.int64).ravel()
    jj = np.asarray(jj, dtype=np.int64).ravel()
    if ii.size != jj.size:
        raise ValueError("ii and jj must have equal length")
    if ii.size and (ii.min() < 0 or jj.min() < 0
                    or ii.max() >= n or jj.max() >= n):
        raise ValueError("pair endpoint out of range")
    keep = ii != jj  # self-pairs carry no grouping information
    ii, jj = ii[keep], jj[keep]

    # Symmetric CSR adjacency in O(E): degree count, prefix, fill.
    src = np.concatenate([ii, jj])
    dst = np.concatenate([jj, ii])
    deg = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    order_e = np.argsort(src, kind="stable")
    indices = dst[order_e]

    # Visit order: stat descending, index ascending on ties. np.argsort
    # of (-stat) is stable with kind="stable", so equal stats keep index
    # order.
    visit = np.argsort(-stat, kind="stable")

    leader = np.full(n, -1, dtype=np.int64)
    leaders: list[int] = []
    for r in visit:
        r = int(r)
        if leader[r] != -1:
            continue
        leader[r] = r
        leaders.append(r)
        nbrs = indices[indptr[r]:indptr[r + 1]]
        if nbrs.size:
            free = nbrs[leader[nbrs] == -1]
            leader[free] = r
    return ClumpResult(leader=leader,
                       leaders=np.asarray(leaders, dtype=np.int64))


def clump(
    x,
    stat: Sequence[float],
    threshold: float,
    *,
    measure: str = "r2",
    block_rows: Optional[int] = None,
    device=None,
) -> ClumpResult:
    """Screen and greedy leader clumping in one call.

    ``x`` is anything :func:`stormtpu_torch.query.pairs_above` accepts
    (BitMatrix or dense rows); ``measure``/``threshold`` define the
    qualifying pairs (default r² ≥ threshold, the LD-clumping form; the
    screen is exact). ``device``: ``None`` (the card) or ``"cpu"``.
    """
    from stormtpu_torch.api import _as_bitmatrix
    from stormtpu_torch.query import pairs_above

    stat = np.asarray(stat, dtype=np.float64)
    bm = _as_bitmatrix(x)
    if stat.ndim != 1 or stat.size != bm.n:
        raise ValueError(
            f"stat must be 1-D with one entry per row: got shape "
            f"{stat.shape} for {bm.n} rows"
        )
    ii, jj, _ = pairs_above(bm, threshold, measure=measure,
                            block_rows=block_rows, device=device)
    return clump_from_pairs(ii, jj, stat, n=bm.n)
