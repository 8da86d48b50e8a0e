"""Distributed cross-set queries: a query panel against a ROW-SHARDED
reference panel (port of ``stormtpu/parallel/cross.py``).

The reference panel B is row-sharded over the mesh, the query set A (the
small side) is on every rank, and each rank scores A against its own B
shard:

- top-k: every rank takes the top k of its shard, the host merges the R
  candidate sets — exact, a global top-k being a merge of per-shard ones;
- screen: every rank packs its shard's hit bitmap; hit VALUES are
  recomputed exactly on the host from the packed rows (O(hits · W)), which
  also gives the exact float64 similarity refine.

On a 2-D [rows × bits] mesh both panels are also word-sharded, and the
count blocks are summed over the bits axis before the top-k or the screen.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stormtpu_torch.kernels import count_block_auto
from stormtpu_torch.parallel.mesh import (
    Mesh,
    bit_axis_of,
    fetch_global,
    local_shard,
    make_row_mesh,
    psum,
)
from stormtpu_torch.utils import round_up

__all__ = ["distributed_cross_topk_neighbors", "distributed_cross_pairs_above"]


def _cross_operands(a, b, mesh: Optional[Mesh], device):
    from stormtpu_torch.cross import _operands  # one validation home

    bm_a, bm_b = _operands(a, b)
    if mesh is None:
        mesh = make_row_mesh(device=device)
    axis = mesh.axis_names[0]
    return bm_a, bm_b, mesh, axis, mesh.shape[axis]


def _put_sharded(bm_a, bm_b, mesh: Mesh, axis: str, r: int):
    """(A's words [na, W_loc] on this rank, this rank's B shard [n_loc,
    W_loc], n_loc): B's rows padded to R·32, the words cut into the bits
    axis's slices on a 2-D mesh."""
    n_loc = round_up(max(bm_b.n, r), r * 32) // r
    bit_axis = bit_axis_of(mesh)
    w_loc, b = bm_b.n_words, 0
    if bit_axis is not None:
        rb = mesh.shape[bit_axis]
        w_loc = round_up(max(bm_b.n_words, rb), rb) // rb
        b = mesh.axis_index(bit_axis)
    i = mesh.axis_index(axis)
    words = (b * w_loc, (b + 1) * w_loc)
    b_local = local_shard(bm_b.packed, (i * n_loc, (i + 1) * n_loc), words, mesh.device)
    a_rep = local_shard(bm_a.packed, (0, bm_a.n), words, mesh.device)
    return a_rep, b_local, n_loc


def _block_counts(mesh: Mesh, a_rep, b_local) -> torch.Tensor:
    """Counts of A against this rank's B shard, completed over the bits
    axis on a 2-D mesh."""
    c = count_block_auto(a_rep, b_local).to(torch.int32)
    bit_axis = bit_axis_of(mesh)
    return psum(c, mesh, bit_axis) if bit_axis is not None else c


def distributed_cross_topk_neighbors(
    a,
    b,
    k: int,
    *,
    mesh: Optional[Mesh] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per row of A, the top-k rows of the row-sharded panel B by exact
    intersection count. Same values as ``cross.cross_topk_neighbors``; tie
    order among equal counts is the merge's."""
    bm_a, bm_b, mesh, axis, r = _cross_operands(a, b, mesh, device)
    if not 1 <= k <= bm_b.n:
        raise ValueError(f"k must be in [1, Nb], got k={k}, Nb={bm_b.n}")
    a_rep, b_local, n_loc = _put_sharded(bm_a, bm_b, mesh, axis, r)
    if k > n_loc:
        raise ValueError(
            f"k={k} exceeds the {n_loc}-row B shard: each device ranks "
            f"only its own shard; use fewer devices or the single-chip "
            f"cross_topk_neighbors"
        )
    c = _block_counts(mesh, a_rep, b_local)
    base = mesh.axis_index(axis) * n_loc
    gid = torch.arange(n_loc, device=c.device) + base
    vals, idx = torch.topk(torch.where(gid[None, :] < bm_b.n, c, -1), k, dim=1)
    vals_r = fetch_global(vals[None], mesh)                       # [R, na, k]
    idx_r = fetch_global((idx + base).to(torch.int32)[None], mesh)
    # host merge of the R per-shard candidate sets (exact)
    cv = np.concatenate(list(vals_r), axis=1).astype(np.int64)  # [na, R·k]
    ci = np.concatenate(list(idx_r), axis=1)
    sel = np.argpartition(-cv, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(cv, sel, axis=1)
    idx = np.take_along_axis(ci, sel, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    return (
        np.take_along_axis(vals, order, axis=1).astype(np.int32),
        np.take_along_axis(idx, order, axis=1).astype(np.int32),
    )


def distributed_cross_pairs_above(
    a,
    b,
    threshold: float,
    *,
    measure: str = "count",
    mesh: Optional[Mesh] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (i, j) with measure(A_i, B_j) ≥ threshold, B row-sharded. Same
    contract as ``cross.cross_pairs_above`` (full rectangle, row-major,
    exact float64 refine for similarities); what leaves a rank is its
    packed hit bitmap, the hits' values are recomputed exactly on the host
    from the packed rows."""
    from stormtpu_torch.query import _expand_words, _pack_bit_rows, _screen_vals, _validate_screen
    from stormtpu_torch.setops import derive_similarity

    bm_a, bm_b, mesh, axis, r = _cross_operands(a, b, mesh, device)
    dev_thresh = _validate_screen(measure, threshold)
    a_rep, b_local, n_loc = _put_sharded(bm_a, bm_b, mesh, axis, r)
    dev = mesh.device
    i = mesh.axis_index(axis)
    c = _block_counts(mesh, a_rep, b_local)
    nnz_b = bm_b.device_nnz(n_loc * r, device=dev)[i * n_loc : (i + 1) * n_loc]
    nnz_a = bm_a.device_nnz(bm_a.n, device=dev)
    vals = _screen_vals(c, nnz_a, nnz_b, float(np.float32(bm_a.m_bits)), measure)
    gid = torch.arange(n_loc, device=dev) + i * n_loc
    hit = (vals >= torch.tensor(dev_thresh, device=dev)) & (gid[None, :] < bm_b.n)
    # every rank's words [na, n_loc/32] side by side: gathered as rows of
    # the transpose
    hits = fetch_global(_pack_bit_rows(hit).T, mesh).T.view(np.uint32)
    ii, jj = _expand_words(np.ascontiguousarray(hits), bm_b.n)
    if not ii.size:
        empty_v = np.zeros(0, np.int32) if measure == "count" else np.zeros(0, np.float64)
        return np.zeros(0, np.int32), np.zeros(0, np.int32), empty_v
    # exact host recompute of the hits' values from the packed rows: the
    # hit set is the sparse output, so O(hits · W) beats shipping counts
    counts = np.zeros(ii.size, dtype=np.int64)
    pa, pb = bm_a.packed, bm_b.packed
    blk = max(1, (1 << 24) // max(bm_a.n_words, 1))
    for o in range(0, ii.size, blk):
        s = slice(o, o + blk)
        counts[s] = np.bitwise_count(pa[ii[s]] & pb[jj[s]]).sum(axis=1, dtype=np.int64)
    if measure == "count":
        return ii.astype(np.int32), jj.astype(np.int32), counts.astype(np.int32)
    vals = derive_similarity(counts, bm_a.row_nnz[ii], bm_b.row_nnz[jj], bm_a.m_bits, measure)
    keep = vals >= threshold
    return ii[keep].astype(np.int32), jj[keep].astype(np.int32), vals[keep]
