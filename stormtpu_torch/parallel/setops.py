"""Distributed set-operation cardinalities and similarity matrices (port of
``stormtpu/parallel/setops.py``).

Both derive EXACTLY from the intersection-count matrix and the row
cardinalities (the identities of ``setops.py``), so the mesh forms are the
ring count walk plus the same derivations: no new collective. They
materialize the N×N result on every rank; where it cannot be, the reduced
queries (``distributed_pairs_above`` / ``distributed_topk_neighbors``) scale.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stormtpu_torch.api import MatrixLike, _as_bitmatrix
from stormtpu_torch.parallel.allpairs import distributed_count_matrix
from stormtpu_torch.parallel.mesh import Mesh
from stormtpu_torch.setops import CARD_OPS, SIM_OPS, derive_cardinality, derive_similarity

__all__ = ["distributed_pairwise_cardinality", "distributed_similarity_matrix"]


def distributed_pairwise_cardinality(
    x: MatrixLike,
    op: str = "intersect",
    *,
    mesh: Optional[Mesh] = None,
    device=None,
) -> np.ndarray:
    """N×N exact pairwise set-op cardinality (int64), counts computed
    ring-distributed over ``mesh``. Same contract as
    ``stormtpu_torch.pairwise_cardinality``."""
    if op not in CARD_OPS:
        raise ValueError(f"unknown op {op!r}; want one of {CARD_OPS}")
    bm = _as_bitmatrix(x)
    inter = distributed_count_matrix(bm.packed, mesh=mesh, device=device).astype(np.int64)
    card = bm.row_nnz.astype(np.int64)
    return derive_cardinality(inter, card[:, None], card[None, :], bm.m_bits, op)


def distributed_similarity_matrix(
    x: MatrixLike,
    measure: str = "jaccard",
    *,
    mesh: Optional[Mesh] = None,
    device=None,
) -> np.ndarray:
    """N×N float64 similarity from exact counts, computed ring-distributed
    over ``mesh``. Same contract as ``stormtpu_torch.similarity_matrix``."""
    if measure not in SIM_OPS:
        raise ValueError(f"unknown measure {measure!r}; want one of {SIM_OPS}")
    bm = _as_bitmatrix(x)
    inter = distributed_count_matrix(bm.packed, mesh=mesh, device=device)
    card = bm.row_nnz
    return derive_similarity(inter, card[:, None], card[None, :], bm.m_bits, measure)
