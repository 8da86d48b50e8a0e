"""Distributed positional popcount (column marginals) over a row mesh
(port of ``stormtpu/parallel/columns.py``).

Each rank reduces its own rows of each word chunk on its device
(``setops._column_partial``) and :func:`psum` merges the exact int32
partials: counts ≤ N < 2³¹.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stormtpu_torch.api import MatrixLike, _as_bitmatrix
from stormtpu_torch.parallel.mesh import Mesh, make_row_mesh, psum
from stormtpu_torch.utils import download, round_up

__all__ = ["distributed_column_counts"]


def _row_shard(bm, mesh: Mesh, axis: str):
    """(first row, rows) of this rank's shard of ``bm`` along ``axis``:
    N rounded up to the ranks, cut into equal shards."""
    r = mesh.shape[axis]
    n_loc = round_up(max(bm.n, r), r) // r
    return mesh.axis_index(axis) * n_loc, n_loc


def distributed_column_counts(
    x: MatrixLike,
    *,
    mesh: Optional[Mesh] = None,
    chunk_words: int = 4096,
    device=None,
) -> np.ndarray:
    """Per-position set-bit counts across all rows, int32 [m_bits],
    computed row-sharded over ``mesh`` (default: :func:`make_row_mesh` on
    ``device``): the sum of each rank's partials."""
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.setops import _column_partial

    bm = _as_bitmatrix(x)
    if mesh is None:
        mesh = make_row_mesh(device=device)
    axis = mesh.axis_names[0]
    r0, n_loc = _row_shard(bm, mesh, axis)
    w = bm.n_words
    out = np.empty(w * 32, dtype=np.int32)
    for c0 in range(0, w, chunk_words):
        wc = min(chunk_words, w - c0)
        chunk = np.zeros((n_loc, wc), dtype=np.uint32)
        rows = bm.packed[r0 : r0 + n_loc, c0 : c0 + wc]
        chunk[: rows.shape[0]] = rows
        part = _column_partial(to_device_words(chunk, mesh.device))
        out[c0 * 32 : (c0 + wc) * 32] = download(psum(part, mesh, axis))
    return out[: bm.m_bits]
