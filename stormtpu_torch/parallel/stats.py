"""Distributed aggregate statistics over C = XXᵀ (port of
``stormtpu/parallel/stats.py``).

- :func:`distributed_count_row_sums` — row marginals of C over a row mesh:
  the global column counts come from ``distributed_column_counts``, then
  each rank turns its OWN rows' weighted reduction into bit-plane AND +
  popcount passes (``Σ_k x·cc = min(cc)·|x| + Σ_t 2ᵗ·popcount(x ∧
  plane_t)``, the identity of ``stats.py``); per-plane counts are ≤ M <
  2³¹, and the host combines the planes in int64.
- :func:`distributed_count_histogram` — the distribution of the
  off-diagonal pair counts: the square ring (each rank bins the blocks of
  its rows under the global ``i < j < n`` mask, so each unordered pair is
  binned once), or the summary-skipping superblock stripes. Each rank
  keeps its bins in int64 on its device; the ranks' bins are summed once,
  at the end.

Both take the 2-D [rows × bits] mesh: word-slice partials are summed over
the bits axis before use.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from stormtpu_torch.api import MatrixLike, _as_bitmatrix
from stormtpu_torch.config import default_config
from stormtpu_torch.kernels import count_block_auto
from stormtpu_torch.layout import pack_bits
from stormtpu_torch.parallel.columns import distributed_column_counts
from stormtpu_torch.parallel.mesh import (
    Mesh,
    bit_axis_of,
    fetch_global,
    local_shard,
    make_row_mesh,
    ppermute,
    psum,
)
from stormtpu_torch.utils import download, round_up

__all__ = ["distributed_count_row_sums", "distributed_count_histogram"]


def _word_slice(mesh: Mesh, w: int) -> tuple:
    """(first word, words) of this rank's slice of ``w`` words: all of
    them on a 1-D mesh, the bits axis's share (rounded up) on a 2-D one."""
    bit_axis = bit_axis_of(mesh)
    if bit_axis is None:
        return 0, w
    rb = mesh.shape[bit_axis]
    w_loc = round_up(max(w, rb), rb) // rb
    return mesh.axis_index(bit_axis) * w_loc, w_loc


def distributed_count_row_sums(
    x: MatrixLike,
    *,
    include_self: bool = True,
    mesh: Optional[Mesh] = None,
    chunk_words: int = 4096,
    device=None,
) -> np.ndarray:
    """Exact row sums of the pair-count matrix, int64 [N], computed
    row-sharded over ``mesh`` — value-identical to
    ``stats.count_row_sums``. ``chunk_words`` bounds the words a rank
    holds on its device at a time."""
    from stormtpu_torch.kernels.xla import popcount32

    bm = _as_bitmatrix(x)
    if mesh is None:
        mesh = make_row_mesh(device=device)
    axis = mesh.axis_names[0]
    bit_axis = bit_axis_of(mesh)
    r = mesh.shape[axis]
    rb = mesh.shape[bit_axis] if bit_axis is not None else 1
    cc = distributed_column_counts(bm, mesh=mesh).astype(np.int64)
    sums = bm.row_nnz.astype(np.int64)
    if bm.n == 0 or cc.size == 0:
        return np.zeros(bm.n, dtype=np.int64)
    base = int(cc.min())
    delta = cc - base
    t_planes = int(delta.max()).bit_length()
    sums *= base
    if t_planes:
        shifts = np.arange(t_planes, dtype=np.int64)[:, None]
        planes = pack_bits(((delta[None, :] >> shifts) & 1).astype(np.uint8))
        n_loc = round_up(max(bm.n, r), r) // r
        i = mesh.axis_index(axis)
        b = mesh.axis_index(bit_axis) if bit_axis is not None else 0
        acc = np.zeros(n_loc * r, dtype=np.int64)
        for c0 in range(0, bm.n_words, chunk_words):
            wr = min(chunk_words, bm.n_words - c0)   # real words of this chunk
            wc = round_up(wr, rb) // rb                # this rank's share of them
            cols = (c0 + b * wc, min(c0 + (b + 1) * wc, c0 + wr))
            words = local_shard(bm.packed, (i * n_loc, (i + 1) * n_loc), cols, mesh.device,
                                width=wc)
            p_d = local_shard(planes, (0, t_planes), cols, mesh.device, width=wc)
            part = torch.stack([popcount32(words & p[None, :]).sum(dim=1, dtype=torch.int32)
                                for p in p_d])      # [T, n_loc]
            if bit_axis is not None:
                part = psum(part, mesh, bit_axis)
            part = fetch_global(part.T, mesh).T.astype(np.int64)   # [T, n_pad]
            acc += (part << shifts).sum(axis=0)
        sums += acc[: bm.n]
    if not include_self:
        sums = sums - bm.row_nnz.astype(np.int64)
    return sums


def _bin_block(hist: torch.Tensor, counts: torch.Tensor, row_g: torch.Tensor,
               col_g: torch.Tensor, n_real: int, bw: int, n_bins: int) -> None:
    """Add the pairs of a count block with global row < column < n into
    the int64 bins ``hist`` (bin ``min(count // bw, n_bins − 1)``)."""
    from stormtpu_torch.stream_hist import _bin_counts

    valid = (row_g[:, None] < col_g[None, :]) & (col_g[None, :] < n_real)
    bins = torch.clamp(counts // bw, max=n_bins - 1)
    hist += _bin_counts(torch.where(valid, bins, n_bins), n_bins + 1)[:n_bins]


def _ring_hist_local(mesh: Mesh, axis: str, r: int, n_loc: int, n_bins: int,
                     block_rows: int, psum_axis: Optional[str] = None):
    """This rank's square-ring loop binning the count blocks of its rows
    (strict global i < j < n: each unordered pair is binned once across
    the ring) into int64 bins on its device."""

    def local_fn(x_local: torch.Tensor, n_real: int, bw: int) -> torch.Tensor:
        dev = x_local.device
        my = mesh.axis_index(axis)
        buf = x_local
        hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
        lane = torch.arange(block_rows, device=dev)
        cols = torch.arange(n_loc, device=dev)
        for s in range(r):
            c0 = ((my + s) % r) * n_loc
            for b0 in range(0, n_loc, block_rows):
                counts = count_block_auto(x_local[b0 : b0 + block_rows], buf).to(torch.int32)
                if psum_axis is not None:
                    counts = psum(counts, mesh, psum_axis)
                _bin_block(hist, counts, lane + my * n_loc + b0, cols + c0, n_real, bw, n_bins)
            if s < r - 1:
                buf = ppermute(buf, mesh, axis, -1)
        return hist

    return local_fn


def _hist_stripe_walk(bm, occ, sb: int, n_super: int, n_bins: int, bin_width: int,
                      mesh: Mesh) -> np.ndarray:
    """Summary-skipping histogram over superblock stripes: a co-empty
    stripe bins its valid-pair mass to 0 by arithmetic and never touches
    the ranks' devices; an occupied one is counted with its i rows shared
    among the ranks and its j rows on every rank. The j superblocks are
    kept on the device as long as they fit the operand budget (at least
    the last two, as the JAX package does)."""
    from stormtpu_torch.stream import _device_operand_budget

    axis = mesh.axis_names[0]
    bit_axis = bit_axis_of(mesh)
    r = mesh.shape[axis]
    n_loc = sb // r
    my = mesh.axis_index(axis)
    w0, w_loc = _word_slice(mesh, bm.n_words)
    words = (w0, w0 + w_loc)
    dev = mesh.device
    hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    # j superblocks held: half the operand budget's worth, beside xi
    keep = max(2, _device_operand_budget(dev) // max(1, 8 * sb * w_loc))
    xj_cache: OrderedDict = OrderedDict()

    def get_xj(j: int) -> torch.Tensor:
        if j in xj_cache:
            xj_cache.move_to_end(j)
            return xj_cache[j]
        buf = local_shard(bm.packed, (j * sb, (j + 1) * sb), words, dev, width=w_loc)
        xj_cache[j] = buf
        if len(xj_cache) > keep:
            xj_cache.popitem(last=False)
        return buf

    lane = torch.arange(n_loc, device=dev)
    cols = torch.arange(sb, device=dev)
    hist0 = 0
    xi, xi_idx = None, -1
    for i in range(n_super):
        for j in range(i, n_super):
            vi = max(0, min(bm.n - i * sb, sb))
            vj = max(0, min(bm.n - j * sb, sb))
            if not (occ[i] & occ[j]).any():
                hist0 += vi * (vi - 1) // 2 if i == j else vi * vj
                continue
            if xi_idx != i:
                r0 = i * sb + my * n_loc
                xi = local_shard(bm.packed, (r0, r0 + n_loc), words, dev, width=w_loc)
                xi_idx = i
            counts = count_block_auto(xi, get_xj(j)).to(torch.int32)
            if bit_axis is not None:
                counts = psum(counts, mesh, bit_axis)
            _bin_block(hist, counts, lane + i * sb + my * n_loc, cols + j * sb, bm.n,
                       bin_width, n_bins)
    out = download(psum(hist, mesh, axis))
    out[0] += hist0
    return out


def distributed_count_histogram(
    x: MatrixLike,
    *,
    n_bins: int = 64,
    bin_width: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    block_rows: int = 512,
    method: str = "auto",
    superblock_rows: int = 8192,
    device=None,
) -> dict:
    """Exact histogram of the off-diagonal pair counts C[i<j] over the
    mesh — the manifest of ``stream.stream_count_histogram`` (uniform
    bins, the last absorbing the tail, mass conservation asserted), equal
    to the single-device sink.

    ``method="auto"`` first applies the density dispatch: an extreme-
    sparsity panel goes to the K4 host binning
    (``stream_hist.stream_hist_sparse``; ``kernel`` "sparse_outer",
    ``mesh_shape`` None). Otherwise the summary picks a mesh route:

    - ``"ring"`` — the square ring over every pair;
    - ``"stripes"`` — superblock stripes with the summary skip (co-empty
      stripes cost no device work); auto picks it when at least half the
      stripes skip."""
    bm = _as_bitmatrix(x)
    if bm.n < 2:
        raise ValueError("count_histogram needs N >= 2 rows")
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    if bin_width is not None and bin_width < 1:
        # a zero width would floor-divide every pair into bin 0, which
        # mass conservation cannot catch: refused on every route
        raise ValueError("bin_width must be >= 1")
    if method not in ("auto", "ring", "stripes"):
        raise ValueError(f"method must be 'auto', 'ring' or 'stripes', got {method!r}")
    if bin_width is None:
        from stormtpu_torch.stream import default_hist_bin_width

        bin_width = default_hist_bin_width(bm.m_bits, n_bins)
    if method == "auto":
        # at extreme sparsity the K4 host binning (work ∝ nnz²) beats any
        # walk of the dense stripes, and would leave the mesh idle anyway
        from stormtpu_torch import native

        cfg = default_config()
        if native.HAVE_NATIVE and bm.density < cfg.sparse_density_threshold:
            from stormtpu_torch.stream_hist import stream_hist_sparse

            man = stream_hist_sparse(bm, n_bins=n_bins, bin_width=bin_width,
                                     superblock_rows=superblock_rows, config=cfg,
                                     device=mesh.device if mesh is not None else device)
            man["mesh_shape"] = None  # host route: the mesh was not used
            return man
    if mesh is None:
        mesh = make_row_mesh(device=device)
    axis = mesh.axis_names[0]
    bit_axis = bit_axis_of(mesh)
    r = mesh.shape[axis]

    if method != "ring" and bm.n and bm.n_words:
        from stormtpu_torch.stream import cap_hist_superblock

        sb = cap_hist_superblock(round_up(max(superblock_rows, r * 8), r * 8), r * 8)
        n_pad_s = round_up(bm.n, sb)
        n_super_s = n_pad_s // sb
        occ_rows = bm.block_summary(block_bits=128 * 32).astype(bool)
        occ_pad = np.zeros((n_pad_s, occ_rows.shape[1]), dtype=bool)
        occ_pad[: bm.n] = occ_rows
        occ = occ_pad.reshape(n_super_s, sb, -1).any(axis=1)
        # [S, S]: stripe (i, j) has a co-occupied K-group
        co = (occ.astype(np.int32) @ occ.T.astype(np.int32)) > 0
        iu = np.triu_indices(n_super_s)
        skipped = int((~co[iu]).sum())
        if method == "stripes" or (n_super_s >= 2 and skipped * 2 >= iu[0].size):
            hist = _hist_stripe_walk(bm, occ, sb, n_super_s, n_bins, bin_width, mesh)
            return _hist_manifest(bm, mesh, n_bins, bin_width, hist, kernel="stripes",
                                  extra={"superblock_rows": sb, "n_super": n_super_s,
                                         "stripes_skipped": skipped})

    block_rows = max(32, min(block_rows, round_up(bm.n, 32)))
    n_pad = round_up(max(bm.n, 1), r * block_rows)
    # the JAX package's bound on its int32 partials (a block's pairs <
    # 2³¹), kept for the same block geometry; the bins here are int64
    while block_rows > 32 and block_rows * (n_pad // r) >= 2**31:
        block_rows //= 2
        n_pad = round_up(max(bm.n, 1), r * block_rows)
    n_loc = n_pad // r
    from stormtpu_torch.parallel.query import _sharded_operands

    x_local, _, _ = _sharded_operands(bm, mesh, n_pad)
    hist_d = _ring_hist_local(mesh, axis, r, n_loc, n_bins, block_rows,
                              psum_axis=bit_axis)(x_local, bm.n, int(bin_width))
    hist = download(psum(hist_d, mesh, axis))
    return _hist_manifest(bm, mesh, n_bins, bin_width, hist, kernel="ring",
                          extra={"block_rows": block_rows})


def _hist_manifest(bm, mesh: Mesh, n_bins: int, bin_width: int, hist: np.ndarray, *,
                   kernel: str, extra: dict) -> dict:
    expect = bm.n * (bm.n - 1) // 2
    got = int(hist.sum())
    if got != expect:
        raise AssertionError(
            f"histogram mass {got} != n*(n-1)/2 = {expect} — a pair was "
            "double-counted or dropped; this is a bug, not an input error"
        )
    edges = np.minimum(np.arange(n_bins + 1, dtype=np.int64) * bin_width, bm.m_bits + 1)
    man = {
        "n": bm.n,
        "m_bits": bm.m_bits,
        "mesh_shape": dict(mesh.shape),
        "kernel": kernel,
        "sink": "histogram",
        "n_bins": n_bins,
        "bin_width": int(bin_width),
        "bin_edges": edges,
        "hist": hist.astype(np.int64),
        "pairs": got,
    }
    man.update(extra)
    return man
