"""Streamed queries: top-k neighbours and threshold screens of matrices
whose N×N counts are never one array (port of ``stormtpu/stream_query.py``).

The walks go over the superblock stripes of ``stream.stream_count_matrix``,
and a stripe's counts never leave the device. They come from the ported
tile kernels (K2 for ``kernel="mxu"``, K1 for ``"dense"``, the plain
whole-stripe forms for ``"xla_*"``) through ``stream._compute_stripe`` on
the padded operand, resident on the device while it holds it, or through
``stream._compute_stripe_pair`` on two superblock slices
(``stream._SliceBuffer``) when it does not. Either way the values are the
same. On each stripe a PyTorch pass on the device reduces the counts:

- ``stream_topk_neighbors``: each side's per-row top-k candidates. By
  count on K2 stripes with k ≤ ``kernels.mxu.TOPK_EPI_MAX``, K2-topk ranks
  each tile inside the kernel and no dense stripe is assembled: a row's
  sets in the stripe are cut back to k (``_stripe_topk_sets``); otherwise
  the dense stripe is ranked (k passes of ``max``, ``query._top_rows``).
  The candidates are merged into a running best on the device
  (``_merge_topk_torch``, the host merge ``_merge_topk``'s sorts). A similarity
  ranks float32 candidates with their exact counts, rescored in float64 on
  the host and certified per stripe (``cross``'s contract).
- ``stream_pairs_above``: the screen of the strict upper triangle on the
  device, whose hits (row, column, count) one kernel compacts into a
  bounded buffer (``kernels.screen``); the buffer comes back in one copy,
  which the host reads while the next stripe runs. Similarity screens run
  in float32 with the reference's slack and the host re-filters in
  float64, so rounding can only add candidates.
- ``stream_pairs_above_complete``: the pairwise-complete screen, four count
  grids a stripe from four superblock slices (data and mask of both row
  blocks), re-derived exactly on the host (``setops._complete_refine``).

At extreme sparsity ``kernel="auto"`` (or ``"sparse_outer"``) takes K4 for
each stripe where the cost model of ``stream._SparseStripePlan`` says so
(K4's kernels on a card, whose stripe's nonzeros alone come back; the host
for a stripe of few emissions, and on the CPU); the staircase of
zero-intersection pairs keeps phi and r² exact there. Stripes between
co-empty superblocks (the block summary) are skipped for every measure.

Checkpoints (``out_dir``) have the JAX package's formats: ``topk_ckpt.npz``
(the running best after every stripe row), and one
``hits_{i:05d}_{j:05d}.npz`` (``chits_`` for the complete screen) a stripe
beside a parameter manifest; a directory started by one package is resumed
and extended by the other. Values equal ``stormtpu.stream_query``'s; the
order of top-k partners with equal values depends on the route.

Every entry point takes ``device=None`` (the card) or ``device="cpu"``.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from stormtpu_torch import native
from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels.mxu import ROUTE_TOPK, topk_route
from stormtpu_torch.layout import BitMatrix
from stormtpu_torch.stream import (
    _SliceBuffer,
    _auto_stream_kernel,
    _block_stripe,
    _compute_stripe,
    _compute_stripe_pair,
    _content_fingerprint,
    _count_stripe,
    _host_superblock,
    _route,
    _span,
    _stage,
    _stripe_nonzeros,
    _stripe_tile_ids,
    _tile_stripe,
    _wants_operand_streaming,
)
from stormtpu_torch.utils import download, next_pow2, profiling, resolve_device, round_up

__all__ = [
    "stream_topk_neighbors",
    "stream_pairs_above",
    "stream_pairs_above_complete",
    "extend_stream_topk_neighbors",
    "extend_stream_pairs_above",
    "extend_stream_pairs_above_complete",
]

# the route a density-ordered walk counts for a stripe K4 answers
# (``profiling.route``); its K2 stripes count their reduction's route, or
# their kernel where the reduction has none
ROUTE_K4 = "k4"

# stripe kernels the queries accept ("auto" resolves to one of them); an
# unknown string must be refused, not run as the K1 branch
_STRIPE_KERNELS = ("mxu", "dense", "xla_int8", "xla_popcount")


def _check_stripe_kernel(kernel: str) -> None:
    if kernel not in _STRIPE_KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}; want 'auto' or one of "
            f"{_STRIPE_KERNELS}"
        )


class _Walk(NamedTuple):
    """A stripe walk's resolved kernel and geometry."""

    cfg: EngineConfig
    kernel: str
    ti: int        # tile rows
    wk: int        # tile words
    sb: int        # superblock rows
    w_pad: int
    n_pad: int
    n_super: int


def _resolve_stripe_config(bm: BitMatrix, superblock_rows: int, kernel: str,
                           config: Optional[EngineConfig], *, bitmap: bool,
                           device=None) -> _Walk:
    """The walk's kernel, tiles and superblock geometry on ``device``.
    ``bitmap`` rounds the superblock to lcm(tile rows, 32): hit bitmaps
    pack 32 columns a word."""
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    if kernel == "auto":
        kernel = _auto_stream_kernel(bm.m_bits, bm.n, device)
    _check_stripe_kernel(kernel)
    k2 = kernel in ("mxu", "xla_int8")
    ti = cfg.k2_tile_rows if k2 else cfg.k1_tile_rows
    wk = cfg.k2_tile_words if k2 else cfg.k1_tile_words
    sb = round_up(superblock_rows, math.lcm(ti, 32) if bitmap else ti)
    n_pad = round_up(bm.n, sb)
    return _Walk(cfg, kernel, ti, wk, sb, round_up(bm.n_words, wk), n_pad, n_pad // sb)


def _sparse_mode_for(bm: BitMatrix, requested: str, cfg: EngineConfig) -> bool:
    """Whether the walk decides each stripe between K4 and the dense
    stripe: ``requested`` (the caller's kernel string, before
    resolution) ``"sparse_outer"`` forces it (``RuntimeError`` without the
    C++ tier); ``"auto"`` takes it below the density threshold, as
    ``stream._resolve_stream_kernel`` does."""
    if requested == "sparse_outer":
        if not native.have_native():
            raise RuntimeError(
                "kernel='sparse_outer' needs the native C++ tier "
                f"(stormtpu_torch/native did not build: {native.native_build_error()})"
            )
        return True
    return (requested == "auto" and bm.n >= 2
            and bm.density < cfg.sparse_density_threshold and native.have_native())


def _walk_resolution(bm: BitMatrix, superblock_rows: int, kernel: str,
                     config: Optional[EngineConfig], *, bitmap: bool, device=None):
    """(walk, sparse mode, the kernel name the manifests record), in one
    place, so that the extend wrappers predict the resumed walk exactly."""
    walk = _resolve_stripe_config(
        bm, superblock_rows, "auto" if kernel == "sparse_outer" else kernel, config,
        bitmap=bitmap, device=device)
    sparse = _sparse_mode_for(bm, kernel, walk.cfg)
    return walk, sparse, (f"sparse_outer+{walk.kernel}" if sparse else walk.kernel)


def _unorder_rows(perm: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Rows of a density-ordered walk (row p is the caller's ``perm[p]``)
    in the caller's order."""
    out = np.empty_like(rows)
    out[perm] = rows
    return out


def _walk_order(bm: BitMatrix, walk: _Walk, requested: str, sparse: bool,
                out_dir: Optional[str], dev: torch.device):
    """The walk's density order (``stream._RowOrder``), or None: ``"auto"``
    orders the rows of a panel that the mean density keeps off the sparse
    mode by their counts, where the cost model sends some stripe of that
    order to K4 (a panel of rare and common rows). Only a walk without a
    directory (its stripe files are keyed by superblocks of the caller's
    rows, to which an extend appends) on a resident operand is ordered."""
    if requested != "auto" or sparse or out_dir or bm.n < 2:
        return None
    from stormtpu_torch.stream import _order_rows

    def resident() -> bool:
        return not _wants_operand_streaming(walk.n_pad, walk.w_pad, walk.sb, dev)

    return _order_rows(bm, walk.sb, walk.n_pad, walk.w_pad, walk.sb // walk.ti, dev,
                       resident)


# ------------------------------------------------------------ checkpoints
def _save_atomic(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _write_manifest(path: str, params: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(params, f)
    os.replace(tmp, path)


class _StripeStore:
    """The screens' per-stripe store: a parameter manifest and one file a
    stripe. A fresh manifest (none on disk, or ``resume=False``) first
    deletes the store's stripe files, so that no file of other content is
    ever reloaded; a manifest of other parameters raises. Every write goes
    to a temporary name and is renamed into place."""

    def __init__(self, out_dir: Optional[str], manifest_name: str, prefix: str,
                 params: dict, resume: bool):
        self.out_dir, self.prefix, self.resume = out_dir, prefix, resume
        if not out_dir:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.manifest = os.path.join(out_dir, manifest_name)
        if resume and os.path.exists(self.manifest):
            with open(self.manifest) as f:
                got = json.load(f)
            if got != params:
                raise ValueError(
                    f"{self.manifest} was written for {got}, not {params} "
                    f"(pass resume=False to overwrite)"
                )
        else:
            for name in os.listdir(out_dir):
                if name.startswith(prefix) and name.endswith(".npz"):
                    os.remove(os.path.join(out_dir, name))
            _write_manifest(self.manifest, params)

    def _path(self, i: int, j: int) -> str:
        return os.path.join(self.out_dir, f"{self.prefix}{i:05d}_{j:05d}.npz")

    def load(self, i: int, j: int) -> Optional[dict]:
        """The stored stripe's arrays, or None if it must be computed."""
        if not (self.out_dir and self.resume and os.path.exists(self._path(i, j))):
            return None
        with np.load(self._path(i, j)) as z:
            return {k: z[k] for k in z.files}

    def save(self, i: int, j: int, **arrays) -> None:
        if self.out_dir:
            _save_atomic(self._path(i, j), **arrays)

    def finish(self, params: dict) -> None:
        """Write ``params`` as the manifest of the completed walk."""
        if self.out_dir:
            _write_manifest(self.manifest, params)


def _topk_ckpt_params(bm: BitMatrix, k: int, sb: int, kernel: str) -> dict:
    return {"n": bm.n, "m_bits": bm.m_bits, "k": k, "superblock_rows": sb,
            "kernel": kernel, "content": _content_fingerprint(bm)}


def _screen_store_params(bm: BitMatrix, sb: int, kernel_name: str, measure: str,
                         threshold: float) -> dict:
    return {"n": bm.n, "m_bits": bm.m_bits, "superblock_rows": sb,
            "kernel": kernel_name, "measure": measure, "threshold": float(threshold),
            "content": _content_fingerprint(bm)}


def _complete_store_params(bm_d: BitMatrix, bm_m: BitMatrix, sb: int, kernel: str,
                           measure: str, threshold: float) -> dict:
    return {"n": bm_d.n, "m_bits": bm_d.m_bits, "superblock_rows": sb, "kernel": kernel,
            "measure": measure, "threshold": float(threshold),
            "content_data": _content_fingerprint(bm_d),
            "content_mask": _content_fingerprint(bm_m)}


def _check_extend_head(bm: BitMatrix, old_n: int, old_fp: str, what: str) -> None:
    """The grown panel's first ``old_n`` rows must fingerprint-match the
    panel the directory was computed from, or its results would splice two
    matrices."""
    if bm.n < old_n:
        raise ValueError(
            f"{what}: N={bm.n} < directory's n={old_n} (rows can only be "
            f"appended; shrinking needs a fresh directory)"
        )
    if _content_fingerprint(bm, old_n) != old_fp:
        raise ValueError(
            f"{what}: the first rows differ from the panel this directory was "
            f"computed from (content fingerprint mismatch) — reusing its "
            f"results would splice two different matrices"
        )


# ------------------------------------------------------ occupancy and merge
def _superblock_occupancy(bm: BitMatrix, n_pad: int, sb: int,
                          order: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Per-superblock K-group occupancy bool [n_super, G] (the block
    summary OR-reduced per superblock, 128-word groups), read-only. None for
    an empty shape. A single group still skips stripes between entirely
    empty superblocks. ``order``: the superblocks are of the rows in that
    order (a density order's ``perm``). Cached on the matrix per (n_pad,
    sb) and order, as the K5 occupancy is, with the rows' summary beside
    it: the summary is a pass over every packed word (13 GB at 100,000 ×
    1,048,576 bits), and a BitMatrix does not change once built."""
    if not (bm.n and bm.n_words):
        return None
    cache = bm.__dict__.setdefault("_superblock_occ_cache", {})
    key = (n_pad, sb) if order is None else (n_pad, sb, zlib.crc32(order.tobytes()))
    occ = cache.get(key)
    if occ is None:
        occ_rows = cache.get("rows")
        if occ_rows is None:
            occ_rows = cache["rows"] = bm.block_summary(block_bits=128 * 32).astype(bool)
        full = np.zeros((n_pad, occ_rows.shape[1]), dtype=bool)
        full[: bm.n] = occ_rows if order is None else occ_rows[order]
        occ = full.reshape(n_pad // sb, sb, -1).any(axis=1)
        occ.setflags(write=False)
        cache[key] = occ
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
    top-k (an extended walk re-merges the stripes of the old partial
    superblock). Fill entries (−1 counts / −inf measures) never collapse:
    each gets a unique surrogate key."""
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


def _merge_topk_torch(best_v: torch.Tensor, best_i: torch.Tensor, r0: int,
                      cand_v: torch.Tensor, cand_i: torch.Tensor, dedup: bool = True) -> None:
    """:func:`_merge_topk` on the running best's device, in place, for rows
    [r0, r0 + len(cand_v)): the same stable sorts (value descending, then
    partner), so the kept entries and their order are the NumPy merge's.
    ``dedup=False`` leaves out the partner pass, for a caller whose
    candidates never repeat a partner of the best (a walk that is not an
    extend): the NumPy merge finds no duplicate then and keeps the first
    sort's order. Nothing is read back: the walk does not wait for the
    device."""
    k = best_v.shape[1]
    sl = slice(r0, r0 + cand_v.shape[0])
    cv = torch.cat([best_v[sl], cand_v.to(best_v.dtype)], dim=1)
    ci = torch.cat([best_i[sl], cand_i.to(best_i.dtype)], dim=1)
    order = torch.sort(-cv, dim=1, stable=True).indices
    if not dedup:
        order = order[:, :k]
        best_v[sl] = cv.gather(1, order)
        best_i[sl] = ci.gather(1, order)
        return
    cv, ci = cv.gather(1, order), ci.gather(1, order)
    floating = cv.dtype.is_floating_point
    fill = torch.isneginf(cv) if floating else cv < 0
    lane = torch.arange(cv.shape[1], device=cv.device)
    key = torch.where(fill, -(lane + 1), ci.to(torch.int64))
    ks, korder = torch.sort(key, dim=1, stable=True)
    dup_sorted = torch.zeros_like(fill)
    dup_sorted[:, 1:] = ks[:, 1:] == ks[:, :-1]
    dup = torch.zeros_like(fill).scatter(1, korder, dup_sorted)
    # a later copy of a partner gives way; without one the stable sort
    # below keeps the order as it is
    cv = torch.where(dup, -torch.inf if floating else -1, cv)
    ci = torch.where(dup, 0, ci)
    order = torch.sort(-cv, dim=1, stable=True).indices
    best_v[sl] = cv.gather(1, order)[:, :k]
    best_i[sl] = ci.gather(1, order)[:, :k]


# --------------------------------------------------------- dense stripes
class _StripeCounts:
    """Where a walk's dense stripes come from: the padded operand resident
    on the device (``stream._compute_stripe``), or, when the device cannot
    hold it (``stream._wants_operand_streaming``), two superblock slices
    (``stream._compute_stripe_pair``). Both give the same int32 [SB, SB]
    stripe, a diagonal one mirrored to the full square. Nothing is
    uploaded before the first stripe, so a resumed or skipped walk uploads
    nothing. A density-ordered walk (``order``) reads its order's resident
    operand, whose rows are in that order."""

    def __init__(self, bm: BitMatrix, walk: _Walk, dev: torch.device, order=None):
        self.bm, self.walk, self.dev = bm, walk, dev
        self.streaming = order is None and _wants_operand_streaming(walk.n_pad, walk.w_pad,
                                                                    walk.sb, dev)
        self._xp = None if order is None else order.xp
        self._slices = None

    def __call__(self, i: int, j: int) -> torch.Tensor:
        w = self.walk
        tps = w.sb // w.ti
        if self.streaming:
            if self._slices is None:
                self._slices = _SliceBuffer(self.bm, w.sb, w.w_pad, self.dev)
            return _compute_stripe_pair(self._slices.stripe_operand(i, j), tps, w.ti, w.wk,
                                        w.kernel)
        return _compute_stripe(self._operand(), i, j, tps, w.ti, w.wk, w.kernel)

    def _operand(self) -> torch.Tensor:
        if self._xp is None:
            from stormtpu_torch.kernels.clustered import padded_operand

            with _stage("upload", self.dev):
                self._xp = padded_operand(self.bm, self.walk.n_pad, self.walk.w_pad, self.dev)
        return self._xp

    def topk_sets(self, i: int, j: int, k: int):
        """K2-topk's candidate sets (``mxu.TileTopk``) of stripe (i, j)'s
        tile list (``stream._stripe_tile_ids``: the upper triangle of a
        diagonal stripe, the tps × tps grid otherwise), with global
        partner ids, on the same operand as :meth:`__call__`."""
        from stormtpu_torch.kernels.mxu import count_tiles_topk, device_tile_ids

        w = self.walk
        tps = w.sb // w.ti
        loc_i, loc_j = _stripe_tile_ids(tps, i == j)
        if self.streaming:
            if self._slices is None:
                self._slices = _SliceBuffer(self.bm, w.sb, w.w_pad, self.dev)
            x = self._slices.stripe_operand(i, j)
            # local ids; an off-diagonal stripe's j tiles sit at +tps
            jbs = loc_j if i == j else loc_j + tps
            ibs, row_off, col_off = loc_i, i * w.sb, j * w.sb - (0 if i == j else w.sb)
        else:
            x = self._operand()
            ibs, jbs, row_off, col_off = loc_i + i * tps, loc_j + j * tps, 0, 0
        with _stage("plan", self.dev):
            ids = device_tile_ids(ibs, jbs, x.shape[0] // w.ti, self.dev)
        with _stage("kernel", self.dev):
            return count_tiles_topk(x, *ids, tile_rows=w.ti, tile_words=w.wk, k=k,
                                    n_real=self.bm.n, row_off=row_off, col_off=col_off,
                                    checked=ids)


def _stripe_counts(source: _StripeCounts, i: int, j: int) -> torch.Tensor:
    """Counts int32 [SB, SB] of stripe (i, j) on the walk's device."""
    return source(i, j)


def _rows_of_sets(v: torch.Tensor, tps: int, by_column: bool) -> torch.Tensor:
    """A stripe's K2-topk sets [tps², s, ti, kk] (tile a·tps + b, set s of
    tile row or column lane l) laid out by the stripe row they belong to:
    [tps·ti, tps·s·kk], row (a, l) holding the sets of tiles (a, ·) for a
    row side, row (b, l) those of tiles (·, b) for a column side."""
    _, s, ti, kk = v.shape
    g = v.view(tps, tps, s, ti, kk)
    g = g.permute(1, 3, 0, 2, 4) if by_column else g.permute(0, 3, 1, 2, 4)
    return g.reshape(tps * ti, tps * s * kk)


def _stripe_topk_sets(source: _StripeCounts, i: int, j: int, k: int):
    """Per-row top-k candidates of stripe (i, j) from K2-topk (the route of
    a count top-k on K2 stripes, ``mxu.topk_route``): no dense stripe is
    assembled. A row's candidate sets in the stripe (one a tile and
    sub-tile it lies in, on the row side or, off a diagonal tile, the
    column side) are cut back to min(k, their number) with one
    ``torch.topk`` a side (a few hundred candidates a row: one call beats
    ``query._top_rows``' k passes there). Returns (vals_i, idx_i, vals_j,
    idx_j) on the device with global partner ids, the j side None on a
    diagonal stripe (its rows get both sides' sets)."""
    sets = source.topk_sets(i, j, k)
    tps = source.walk.sb // source.walk.ti
    dev = sets.row_v.device
    with _stage("reduce", dev):
        if i == j:
            # the upper triangle's sets into the tps × tps grid, the lower
            # tiles' slots (−1, −1)
            loc_i, loc_j = _stripe_tile_ids(tps, True)
            at = profiling.upload(torch.from_numpy(loc_i.astype(np.int64) * tps + loc_j), dev)
            full = []
            for x in sets:
                g = torch.full((tps * tps, *x.shape[1:]), -1, dtype=x.dtype, device=dev)
                g[at] = x
                full.append(g)
            sides = [(torch.cat([_rows_of_sets(full[0], tps, False),
                                 _rows_of_sets(full[2], tps, True)], dim=1),
                      torch.cat([_rows_of_sets(full[1], tps, False),
                                 _rows_of_sets(full[3], tps, True)], dim=1))]
        else:
            sides = [(_rows_of_sets(sets.row_v, tps, False), _rows_of_sets(sets.row_i, tps, False)),
                     (_rows_of_sets(sets.col_v, tps, True), _rows_of_sets(sets.col_i, tps, True))]
        out = []
        for vals, idx in sides:
            v, pos = torch.topk(vals, min(k, vals.shape[1]), dim=1)
            out += [v, idx.gather(1, pos)]
        return (*out, None, None) if i == j else tuple(out)


def _grid_coords(shape, row0_i: int, row0_j: int, dev):
    rows = torch.arange(shape[0], device=dev)[:, None] + row0_i
    cols = torch.arange(shape[1], device=dev)[None, :] + row0_j
    return rows, cols


def _stripe_topk(counts: torch.Tensor, row0_i: int, row0_j: int, n: int, *, k: int,
                 diagonal: bool):
    """Per-row top-k candidates of one stripe, both orientations: rows of
    block i against block j's columns and, off the diagonal, rows of block
    j against block i's (on the diagonal that set is the same). Invalid
    cells (self pairs, padded rows or columns) rank as −1. Returns
    (vals_i, idx_i, vals_j, idx_j) on the device, the j side None on a
    diagonal stripe; indices are local columns."""
    from stormtpu_torch.query import _top_rows

    dev = counts.device
    with _stage("reduce", dev):
        rows, cols = _grid_coords(counts.shape, row0_i, row0_j, dev)
        masked = torch.where((rows < n) & (cols < n) & (rows != cols), counts, -1)
        vi, ii = _top_rows(masked, k)
        if diagonal:
            return vi, ii, None, None
        vj, ij = _top_rows(masked.T.contiguous(), k)
        return vi, ii, vj, ij


def _stripe_topk_measure(counts: torch.Tensor, nnz_i: torch.Tensor, nnz_j: torch.Tensor,
                         row0_i: int, row0_j: int, n: int, m_f: float, *, measure: str,
                         kk: int, diagonal: bool):
    """Per-row top-``kk`` similarity candidates of one stripe (both
    orientations off the diagonal), float32-ranked, each with its exact
    count for the host's float64 rescore. Invalid cells rank as −inf.
    Returns (scores_i, idx_i, counts_i, scores_j, idx_j, counts_j) on the
    device, the j side None on a diagonal stripe."""
    from stormtpu_torch.query import _screen_vals

    dev = counts.device
    with _stage("reduce", dev):
        scores = _screen_vals(counts, nnz_i, nnz_j, m_f, measure)
        rows, cols = _grid_coords(counts.shape, row0_i, row0_j, dev)
        masked = torch.where((rows < n) & (cols < n) & (rows != cols), scores, -torch.inf)
        sv_i, ix_i = torch.topk(masked, kk, dim=1)
        cv_i = counts.gather(1, ix_i)
        if diagonal:
            return sv_i, ix_i, cv_i, None, None, None
        sv_j, ix_j = torch.topk(masked.T.contiguous(), kk, dim=1)
        cv_j = counts.T.gather(1, ix_j)
        return sv_i, ix_i, cv_i, sv_j, ix_j, cv_j


def _stripe_screen(counts: torch.Tensor, nnz_i: torch.Tensor, nnz_j: torch.Tensor,
                   row0_i: int, row0_j: int, n: int, thresh: float, m_f: float, *,
                   measure: str, out: torch.Tensor) -> None:
    """One stripe's screen on the device: its pairs of measure ≥ ``thresh``
    in the global strict upper triangle (i < j < n) compacted into the hit
    buffer ``out`` (``kernels.screen.stripe_screen``)."""
    from stormtpu_torch.kernels.screen import stripe_screen

    with _stage("reduce", counts.device):
        stripe_screen(counts, nnz_i, nnz_j, row0_i, row0_j, n, thresh, m_f, measure, out)


# the least number of hits a stripe's copy to the host holds (12 bytes a
# hit, with the total 4 more), and the device buffers' room until a
# stripe's hits outgrow it
_SCREEN_HITS = 1 << 14


class _ScreenHits:
    """A screen walk's hit buffers. Each dense stripe's screen compacts its
    hits into one of two device buffers, in turns, and its total with its
    first hits goes in one copy into one of two host buffers (pinned on a
    card), so that the host reads stripe s's hits while stripe s + 1 runs.
    The copy holds ``_SCREEN_HITS`` hits, or as many as the stripe read
    last had where that is more, so it follows the walk's hits both ways.
    A stripe with more hits than its copy holds has the rest read from its
    device buffer, which stripe s + 1 did not touch (counter
    ``screen_refetch``); where they outgrew that buffer too, the stripe is
    screened again from its counts into one grown to fit, and both device
    buffers keep that size. Buffers are made at a walk's first stripes and
    remade only to grow."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.turn = 0
        self.least = _SCREEN_HITS
        self.cap = _SCREEN_HITS
        self.last = 0
        self.bufs: list = [None, None]
        self.host: list = [None, None]

    def _buffers(self, turn: int, room: int):
        from stormtpu_torch.kernels.screen import hit_buffer

        if self.bufs[turn] is None or self.bufs[turn].numel() < 1 + 3 * self.cap:
            self.bufs[turn] = hit_buffer(self.cap, self.dev)
        if self.host[turn] is None or self.host[turn].numel() < 1 + 3 * room:
            pin = self.dev.type == "cuda"
            if pin:
                profiling.count("pinned_allocs")
            self.host[turn] = torch.empty(1 + 3 * room, dtype=torch.int32, pin_memory=pin)
        return self.bufs[turn], self.host[turn]

    def launch(self, counts: torch.Tensor, nnz_i: torch.Tensor, nnz_j: torch.Tensor,
               row0_i: int, row0_j: int, n: int, thresh: float, m_f: float, measure: str):
        """Screen stripe ``counts`` (:func:`_stripe_screen`) and start
        copying its hits to the host; returns what :meth:`collect` takes."""
        turn = self.turn
        self.turn ^= 1
        room = self.least if self.last <= self.least else min(self.cap, next_pow2(self.last))
        buf, host = self._buffers(turn, room)
        screen = (nnz_i, nnz_j, row0_i, row0_j, n, thresh, m_f)
        _stripe_screen(counts, *screen, measure=measure, out=buf)
        size = 1 + 3 * room
        profiling.count("d2h_bytes", 4 * size)
        copied = None
        if self.dev.type == "cuda":
            host[:size].copy_(buf[:size], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        else:
            host[:size].copy_(buf[:size])
        return counts, screen, measure, turn, room, host, copied

    def collect(self, launched) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A launched stripe's hits (local row, local column, count; int64),
        row-major. Waits for its copy alone, unless the hits outgrew it."""
        from stormtpu_torch.kernels.screen import hit_buffer

        counts, screen, measure, turn, room, host, copied = launched
        if copied is not None:
            with profiling.wait("copy"):
                copied.synchronize()
        total = self.last = int(host[0])
        got = host[1:1 + 3 * min(total, room)].numpy()
        if total > room:
            profiling.count("screen_refetch")
            buf = self.bufs[turn]
            if total > (buf.numel() - 1) // 3:
                # stripe s + 2, the next to screen into this buffer, has not
                # been launched: the grown one takes its place
                self.cap = max(self.cap, next_pow2(total))
                buf = self.bufs[turn] = hit_buffer(self.cap, self.dev)
                _stripe_screen(counts, *screen, measure=measure, out=buf)
                got = download(buf[1:1 + 3 * total])
            else:
                got = np.concatenate([got, download(buf[1 + 3 * room:1 + 3 * total])])
        hits = got.reshape(total, 3)
        # the kernel's slots follow its atomics
        order = np.argsort(hits[:, 0].astype(np.int64) * counts.shape[1] + hits[:, 1])
        return tuple(hits[order, k].astype(np.int64) for k in range(3))


def _fetch_hits(hits_d: torch.Tensor, summary: np.ndarray, sb: int):
    """Local (row, col) int64 of a stripe's hit bits, row-major, from its
    word summary on the host: only the nonzero words are gathered on the
    device and downloaded, or the whole bitmap where that costs less (as
    ``query.pairs_above`` does)."""
    from stormtpu_torch.query import _expand_word_coords, _expand_words, _gather_hit_words

    wi_r, wi_w = _expand_words(summary.view(np.uint32), hits_d.shape[1])
    if wi_r.size > hits_d.shape[0] * hits_d.shape[1] // 8:
        return _expand_words(download(hits_d).view(np.uint32), sb)
    if not wi_r.size:
        return wi_r, wi_w
    words = _gather_hit_words(hits_d, wi_r, wi_w).view(np.uint32)
    return _expand_word_coords(wi_r, wi_w, words, sb)


# ----------------------------------------------------------- sparse stripes
class _CooStripe:
    """COO view of a K4 stripe (local li/lj/vv over the full mirrored
    square) plus the two membership queries the zero-intersection
    staircases need, so that no dense sb² buffer is built for a stripe of
    few emissions. ``.T`` swaps orientation (K4 stripes are square)."""

    def __init__(self, li: np.ndarray, lj: np.ndarray, vv: np.ndarray, sb: int):
        self.li, self.lj, self.vv, self.sb = li, lj, vv, sb
        self._keys = np.sort(li.astype(np.int64) * sb + lj)

    @property
    def T(self) -> "_CooStripe":
        return _CooStripe(self.lj, self.li, self.vv, self.sb)

    def is_zero(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """bool [Q]: stripe[rows, cols] == 0 (sorted-key membership)."""
        if not self._keys.size:
            return np.ones(rows.size, dtype=bool)
        q = rows.astype(np.int64) * self.sb + cols
        pos = np.minimum(np.searchsorted(self._keys, q), self._keys.size - 1)
        return self._keys[pos] != q

    def row_nonzero_counts(self, valid_a: int, valid_b: int) -> np.ndarray:
        """int64 [valid_a]: per-row nonzero count within the valid box."""
        sel = (self.li < valid_a) & (self.lj < valid_b)
        return np.bincount(self.li[sel], minlength=valid_a)[:valid_a]


def _stripe_nz(stripe) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(li, lj, vv) nonzeros of a K4 stripe in either representation."""
    if isinstance(stripe, _CooStripe):
        return stripe.li, stripe.lj, stripe.vv
    li, lj = np.nonzero(stripe)
    return li, lj, stripe[li, lj]


def _k4_stripe(plan, i: int, j: int, sb: int):
    """K4's stripe (i, j) as a :class:`_CooStripe`: made on the host where
    the emissions are few, else the nonzeros of the plan's stripe (K4's
    kernels on a card, where only the nonzeros come back; the C++ run walks
    on the CPU)."""
    if plan.emission_eligible(i, j):
        return _CooStripe(*plan.stripe_coo(i, j), sb)
    return _CooStripe(*_stripe_nonzeros(plan.stripe_counts(i, j)), sb)


def _r2_zero_plan(nnz_i: np.ndarray, nnz_j: np.ndarray, m_bits: int, threshold: float):
    """r² scores zero-intersection (anti-correlated) pairs: at zero
    intersection r² = g(ca)·g(cb) with g(c) = c/(m−c), monotone in c, so
    the candidates above a threshold form a staircase enumerable from
    sorted row cardinalities, without any pair K4 never emitted. Returns
    (total count, materialize(stripe, diagonal) → (rows, cols)); the
    materialized pairs are those whose stripe count is zero (the nonzero
    pairs are the COO pass's). The threshold carries a few ulps of slack so
    rounding can only add candidates; the float64 re-filter trims them."""
    m = float(m_bits)
    ca = nnz_i.astype(np.float64)
    cb = nnz_j.astype(np.float64)
    # rows with c ∈ {0, m} form no scoring zero-intersection pair
    with np.errstate(divide="ignore", invalid="ignore"):
        ga = np.where((nnz_i > 0) & (nnz_i < m_bits), ca / (m - ca), 0.0)
        gb = np.where((nnz_j > 0) & (nnz_j < m_bits), cb / (m - cb), 0.0)
    order_b = np.argsort(-gb)
    gbs = gb[order_b]
    t_eff = threshold * (1.0 - 1e-9)
    with np.errstate(divide="ignore"):
        lim = np.where(ga > 0, t_eff / ga, np.inf)
    cnt = np.searchsorted(-gbs, -lim, side="right")
    total = int(cnt.sum())

    def materialize(stripe, diagonal: bool):
        offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        rows = np.repeat(np.arange(cnt.size), cnt)
        cols = order_b[offs]
        # stripe=None: a summary-zero stripe, every count exactly zero
        if stripe is None:
            keep = np.ones(rows.size, dtype=bool)
        elif isinstance(stripe, _CooStripe):
            keep = stripe.is_zero(rows, cols)
        else:
            keep = stripe[rows, cols] == 0
        if diagonal:
            keep &= rows < cols
        return rows[keep], cols[keep]

    return total, materialize


def _k4_zero_topk(
    stripe,
    nnz_a: np.ndarray,
    nnz_b: np.ndarray,
    m_bits: int,
    measure: str,
    k: int,
    *,
    diagonal: bool,
    valid_a: int,
    valid_b: int,
    sb_rows: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k zero-intersection candidates of one stripe for phi
    and r² (the top-k twin of :func:`_r2_zero_plan`). At zero intersection
    a row's partners rank by g(cb) alone (descending for r², ascending for
    phi, whose zero-intersection scores are ≤ 0); the first k + P_a + 1 of
    that order (P_a the row's nonzero partners, +1 for the diagonal self)
    hold the row's zero-intersection top-k, each scored in float64 by
    ``derive_similarity``. Padded partners are left out (their cb = 0 would
    score 0, above phi's negative scores). ``stripe=None`` is a co-empty
    stripe (every pair zero-intersection; pass ``sb_rows``). Returns ([sb,
    k] float64 scores filled −inf, [sb, k] int32 local partners)."""
    from stormtpu_torch.setops import derive_similarity

    if stripe is None:
        sb_a = sb_rows
    elif isinstance(stripe, _CooStripe):
        sb_a = stripe.sb
    else:
        sb_a = stripe.shape[0]
    cand_v = np.full((sb_a, k), -np.inf, dtype=np.float64)
    cand_i = np.zeros((sb_a, k), dtype=np.int32)
    if valid_a <= 0 or valid_b <= 0:
        return cand_v, cand_i
    m = float(m_bits)
    cb = nnz_b[:valid_b].astype(np.float64)
    gb = np.where((cb > 0) & (cb < m), cb / np.maximum(m - cb, 1.0), 0.0)
    order = np.argsort(gb if measure == "phi" else -gb, kind="stable")
    if stripe is None:
        p = np.zeros(valid_a, dtype=np.int64)
    elif isinstance(stripe, _CooStripe):
        p = stripe.row_nonzero_counts(valid_a, valid_b)
    else:
        p = np.count_nonzero(stripe[:valid_a, :valid_b], axis=1)
    t = np.minimum(k + p + (1 if diagonal else 0), valid_b)
    rows = np.repeat(np.arange(valid_a), t)
    offs = np.arange(rows.size) - np.repeat(np.cumsum(t) - t, t)
    cols = order[offs]
    if stripe is None:
        keep = np.ones(rows.size, dtype=bool)
    elif isinstance(stripe, _CooStripe):
        keep = stripe.is_zero(rows, cols)
    else:
        keep = stripe[rows, cols] == 0
    if diagonal:
        keep &= rows != cols
    rows, cols = rows[keep], cols[keep]
    scores = derive_similarity(0, nnz_a[rows], nnz_b[cols], m_bits, measure)
    return _coo_rank_topk(rows, cols.astype(np.int64), scores, sb_a, k, fill=-np.inf)


def _coo_rank_topk(ii: np.ndarray, jj: np.ndarray, vv: np.ndarray, sb: int, k: int,
                   fill: float = -1) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k of COO candidates by rank within the row: lexsort by
    (row, −value), keep rank < k. O(E log E) in the stripe's nonzeros. Rows
    with fewer than k candidates pad with ``fill``; float values rank in
    float64, counts in int64."""
    order = np.lexsort((-vv, ii))
    i_s, j_s, v_s = ii[order], jj[order], vv[order]
    starts = np.flatnonzero(np.r_[True, i_s[1:] != i_s[:-1]])
    counts = np.diff(np.r_[starts, i_s.size])
    rank = np.arange(i_s.size) - np.repeat(starts, counts)
    keep = rank < k
    dtype = np.float64 if np.issubdtype(np.asarray(vv).dtype, np.floating) else np.int64
    cand_v = np.full((sb, k), fill, dtype=dtype)
    cand_i = np.zeros((sb, k), dtype=np.int32)
    cand_v[i_s[keep], rank[keep]] = v_s[keep]
    cand_i[i_s[keep], rank[keep]] = j_s[keep]
    return cand_v, cand_i


def _stripe_topk_candidates_k4(stripe, k: int, *, diagonal: bool):
    """Host top-k of one K4 stripe's counts, both orientations, from its
    nonzeros (a zero count never beats the no-partner padding); self pairs
    dropped on a diagonal stripe. ``stripe``: dense [sb, sb] or a
    :class:`_CooStripe`."""
    sb = stripe.sb if isinstance(stripe, _CooStripe) else stripe.shape[0]
    li, lj, vv = _stripe_nz(stripe)
    if diagonal:
        nz = li != lj
        li, lj, vv = li[nz], lj[nz], vv[nz]
    vi, ii = _coo_rank_topk(li, lj, vv, sb, k)
    if diagonal:
        return vi, ii, None, None
    vj, ij = _coo_rank_topk(lj, li, vv, sb, k)
    return vi, ii, vj, ij


# ------------------------------------------------------------------ top-k
def extend_stream_topk_neighbors(
    bm: BitMatrix,
    out_dir: str,
    *,
    kernel: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Grow a completed ``stream_topk_neighbors(out_dir=...)`` run to
    ``bm``'s larger row count without redoing the old work.

    The checkpoint's running best is exact for every pair inside the old
    complete superblocks, so the extended walk merges only the stripes
    with a new (or old partial) superblock: old rows meet only new
    partners. Candidates whose partner was zero padding in the old run are
    reset first, and ``_merge_topk``'s dedup by partner makes re-merging
    the partial superblock's stripes idempotent. ``k``, the measure and the
    superblock come from the checkpoint; the resolved walk must round to
    the same superblock. An interrupted extend resumes by calling this
    again with the same panel (the checkpoint's ``extend_from`` key pins
    it; a plain resume is refused). Returns what ``stream_topk_neighbors``
    returns."""
    ckpt = os.path.join(out_dir, "topk_ckpt.npz")
    with np.load(ckpt, allow_pickle=False) as z:
        old = json.loads(str(z["params"]))
        best_v = np.array(z["best_v"])
        best_i = np.array(z["best_i"])
        next_i = int(z["next_i"])
    old_n = int(old["n"])
    k = int(old["k"])
    sb_old = int(old["superblock_rows"])
    measure = old.get("measure", "count")
    if bm.m_bits != old["m_bits"]:
        raise ValueError(
            f"extend: m_bits {bm.m_bits} != checkpoint's {old['m_bits']} — a "
            f"changed universe invalidates the best"
        )
    walk_kw = dict(superblock_rows=sb_old, kernel=kernel, measure=measure, config=config,
                   out_dir=out_dir, resume=True, device=device)
    if (old.get("extend_from") is not None and old_n == bm.n
            and old["content"] == _content_fingerprint(bm)):
        # an interrupted extend of this very panel: resume it
        return stream_topk_neighbors(bm, k, _extend_from=int(old["extend_from"]), **walk_kw)
    _check_extend_head(bm, old_n, old["content"], "extend")
    n_super_old = round_up(old_n, sb_old) // sb_old
    if next_i < n_super_old:
        raise ValueError(
            f"extend: the checkpoint is an INCOMPLETE run (next_i={next_i} of "
            f"{n_super_old} rows) — resume it to completion first "
            f"(stream_topk_neighbors(out_dir=...))"
        )
    walk, _sparse, kernel_name = _walk_resolution(bm, sb_old, kernel, config, bitmap=False,
                                                  device=device)
    if walk.sb != sb_old:
        raise ValueError(
            f"extend: the resumed walk rounds superblock_rows to {walk.sb}, not "
            f"the checkpoint's {sb_old} — the running best would misalign; "
            f"match the config/kernel"
        )
    fill = best_v.dtype.type(-1) if best_v.dtype.kind == "i" else -np.inf
    # partners at index >= old_n were zero padding when the best was computed
    stale = best_i >= old_n
    best_v = np.where(stale, fill, best_v)
    best_i = np.where(stale, 0, best_i)
    # rows at or above old_n were padding themselves
    best_v[old_n:] = fill
    best_i[old_n:] = 0
    if walk.n_pad > best_v.shape[0]:
        grow = walk.n_pad - best_v.shape[0]
        best_v = np.concatenate([best_v, np.full((grow, k), fill, dtype=best_v.dtype)])
        best_i = np.concatenate([best_i, np.zeros((grow, k), dtype=best_i.dtype)])
    params = _topk_ckpt_params(bm, k, walk.sb, kernel_name)
    if measure != "count":
        params["measure"] = measure
    params["extend_from"] = old_n
    _save_atomic(ckpt, params=json.dumps(params), best_v=best_v, best_i=best_i, next_i=0)
    return stream_topk_neighbors(bm, k, _extend_from=old_n, **walk_kw)


def stream_topk_neighbors(
    bm: BitMatrix,
    k: int,
    *,
    superblock_rows: int = 4096,
    kernel: str = "auto",
    measure: str = "count",
    config: Optional[EngineConfig] = None,
    out_dir: Optional[str] = None,
    resume: bool = True,
    device=None,
    _extend_from: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k partners by exact intersection count, at any N the
    host holds. Returns (counts int32 [N, k], indices int32 [N, k]) sorted
    descending: the values of ``query.topk_neighbors``. The order among
    equal counts depends on the route, and zero-count entries may carry the
    (0, 0) "no partner" convention.

    ``measure``: "count" or a similarity ("jaccard", "dice", "cosine",
    "overlap", "phi", "r2"): then (values float64 [N, k], indices int32
    [N, k]), exact. Dense stripes take float32-ranked candidates with their
    counts, rescored in float64 on the host and certified per stripe (the
    candidate width doubles until the stripe's own top-k provably lies
    inside); K4 stripes rank their exact scores; phi and r² also merge each
    row's zero-intersection candidates from the cardinality staircase, also
    on co-empty stripes, which take no device work for any measure.

    ``kernel``: "mxu" (K2), "dense" (K1), "xla_int8" / "xla_popcount"
    (plain whole-stripe forms), "auto", or "sparse_outer" (K4 for the
    stripes where the cost model says so, its kernels on a card; needs the
    C++ tier).
    When the device cannot hold the padded operand (as
    ``stream.stream_count_matrix`` judges it), only two superblock slices
    are kept there.

    ``out_dir``: checkpoint the running best after every stripe row
    (written to a temporary name and renamed) and resume from it. The
    checkpoint is keyed on (n, m_bits, k, superblock, kernel) and a content
    fingerprint; a mismatch raises (``resume=False`` overwrites)."""
    if not 1 <= k < max(bm.n, 2):
        raise ValueError(f"k must be in [1, N-1], got k={k}, N={bm.n}")
    with _span("stpu.stream.job") as job:
        dev = resolve_device(device)
        walk, sparse_mode, kernel_name = _walk_resolution(bm, superblock_rows, kernel, config,
                                                          bitmap=False, device=dev)
        sb, n_pad, n_super = walk.sb, walk.n_pad, walk.n_super
        if k > sb:
            raise ValueError(
                f"k={k} exceeds superblock_rows={sb}: each stripe ranks only one "
                f"superblock of partners; raise superblock_rows"
            )
        if measure != "count":
            from stormtpu_torch.query import _validate_screen

            _validate_screen(measure, 1.0)  # validates the measure name
        plan = None
        if sparse_mode:
            from stormtpu_torch.stream import _SparseStripePlan

            with _stage("plan", dev):
                plan = _SparseStripePlan(bm, sb, n_super, dev)
        order = _walk_order(bm, walk, kernel, sparse_mode, out_dir, dev)

        if measure == "count":
            best_v = np.full((n_pad, k), -1, dtype=np.int64)
        else:
            best_v = np.full((n_pad, k), -np.inf, dtype=np.float64)
        best_i = np.zeros((n_pad, k), dtype=np.int32)
        start_i = 0
        ckpt = os.path.join(out_dir, "topk_ckpt.npz") if out_dir else None
        params = _topk_ckpt_params(bm, k, sb, kernel_name)
        if measure != "count":
            params["measure"] = measure
        # an extending walk skips the stripes wholly inside the old complete
        # superblocks (their candidates already sit in the running best); the
        # key rides in params, so that an interrupted extend resumes only as one
        j_skip = 0
        if _extend_from is not None:
            params["extend_from"] = int(_extend_from)
            j_skip = int(_extend_from) // sb
        if ckpt and resume and os.path.exists(ckpt):
            with np.load(ckpt, allow_pickle=False) as z:
                got = json.loads(str(z["params"]))
                if got != params:
                    raise ValueError(f"checkpoint {ckpt} was written for {got}, not {params}")
                best_v = z["best_v"]
                best_i = z["best_i"]
                start_i = int(z["next_i"])
        elif out_dir:
            os.makedirs(out_dir, exist_ok=True)

        perm = None if order is None else order.perm
        occ_sb = _superblock_occupancy(bm, n_pad, sb, perm)
        nnz_pad = np.zeros(n_pad, dtype=np.int64)
        nnz_pad[: bm.n] = bm.row_nnz if order is None else bm.row_nnz[perm]
        source = _StripeCounts(bm, walk, dev, order)
        n = bm.n
        # the count top-k's route on dense stripes: K2-topk on K2's stripes
        route = topk_route(k) if walk.kernel == "mxu" else f"store (stripe kernel {walk.kernel})"
        # the running best lives on the walk's device and is merged there
        best_v = profiling.upload(torch.from_numpy(np.ascontiguousarray(best_v)), dev)
        best_i = profiling.upload(torch.from_numpy(np.ascontiguousarray(best_i)), dev)

        def merge(r: int, cv, ci) -> None:
            """Merge candidates of superblock r's rows (global partner ids;
            host arrays or tensors on the walk's device)."""
            with _stage("merge", dev):
                _merge_topk_torch(best_v, best_i, r * sb, torch.as_tensor(cv, device=dev),
                                  torch.as_tensor(ci, device=dev), dedup=_extend_from is not None)

        def save_checkpoint(next_i: int) -> None:
            with _stage("save", dev):
                _save_atomic(ckpt, params=json.dumps(params), best_v=download(best_v),
                             best_i=download(best_i), next_i=next_i)

        def valid_rows(r: int) -> int:
            return max(0, min(n - r * sb, sb))

        def zero_staircase(i: int, j: int, stripe) -> None:
            """phi / r²: merge both sides' zero-intersection candidates."""
            va, vb = valid_rows(i), valid_rows(j)
            zv, zi = _k4_zero_topk(stripe, nnz_pad[i * sb:(i + 1) * sb],
                                   nnz_pad[j * sb:(j + 1) * sb], bm.m_bits, measure, k,
                                   diagonal=i == j, valid_a=va, valid_b=vb, sb_rows=sb)
            merge(i, zv, zi + j * sb)
            if i != j:
                zv, zi = _k4_zero_topk(None if stripe is None else stripe.T,
                                       nnz_pad[j * sb:(j + 1) * sb],
                                       nnz_pad[i * sb:(i + 1) * sb], bm.m_bits, measure, k,
                                       diagonal=False, valid_a=vb, valid_b=va, sb_rows=sb)
                merge(j, zv, zi + i * sb)

        if measure != "count":
            from stormtpu_torch.cross import _MEASURE_TOPK_SLACK
            from stormtpu_torch.setops import derive_similarity_torch

            kk0 = int(min(next_pow2(max(2 * k, k + 8)), sb))
            m_f = float(np.float32(bm.m_bits))
            nnz_dev = profiling.upload(torch.from_numpy(nnz_pad), dev)
            lane = torch.arange(sb, device=dev)

        def measure_stripe(i: int, j: int, counts: torch.Tensor):
            """Certified candidates of a dense stripe: the float64 rescore
            (``derive_similarity_torch``: the host formulas' values bit for
            bit) of the float32 top-kk, kk doubled until the stripe's own top-k
            provably lies inside (at kk = sb the stripe is enumerated). One
            flag a round is read back."""
            n_valid_j = valid_rows(j) - (1 if i == j else 0)
            n_valid_i = valid_rows(i) - (1 if i == j else 0)
            kk = kk0
            while True:
                out = _stripe_topk_measure(
                    counts, nnz_dev[i * sb:(i + 1) * sb], nnz_dev[j * sb:(j + 1) * sb],
                    i * sb, j * sb, n, m_f, measure=measure, kk=kk, diagonal=i == j)
                sides = []
                checks = []
                with _stage("rescore", dev):
                    for sv, ix, cv, r0, c0, n_valid in ((*out[0:3], i, j, n_valid_j),
                                                        (*out[3:6], j, i, n_valid_i)):
                        if sv is None:
                            sides.append(None)
                            continue
                        f = derive_similarity_torch(cv, nnz_dev[r0 * sb:(r0 + 1) * sb, None],
                                                    nnz_dev[c0 * sb + ix], bm.m_bits, measure)
                        f = torch.where(sv > -torch.inf, f, -torch.inf)
                        sides.append((f, ix + c0 * sb))
                        if n_valid > kk:
                            kth = torch.topk(f, k, dim=1).values[:, k - 1]
                            ok = kth > sv[:, -1] + _MEASURE_TOPK_SLACK
                            checks.append(ok | (lane + r0 * sb >= n))
                    with profiling.wait("flag"):
                        certified = not checks or bool(torch.cat(checks).all())
                if certified or kk >= sb:
                    return sides
                kk = int(min(kk * 2, sb))

        for i in range(start_i, n_super):
            dirty = False
            for j in range(i, n_super):
                if j < j_skip:
                    continue  # both superblocks inside the old complete range
                if occ_sb is not None and not (occ_sb[i] & occ_sb[j]).any():
                    # co-empty stripe: every count is zero. Count and the
                    # nonnegative measures gain nothing (the no-partner
                    # convention covers it); phi / r² take the staircase
                    if measure in ("phi", "r2"):
                        zero_staircase(i, j, None)
                        dirty = True
                    continue
                dirty = True
                with _span("stpu.stream.stripe", job.number, i, j):
                    # phi / r²'s staircase is host work the cost model is charged for
                    z_extra = 0
                    if plan is not None and measure in ("phi", "r2"):
                        z_extra = (1 if i == j else 2) * (sb * (k + 1) + plan.emissions(i, j))
                    if plan is not None:
                        with _stage("plan", dev):
                            k4 = plan.use_k4(i, j, extra_emissions=z_extra, emission_path=True)
                    else:
                        k4 = False
                    if k4:
                        with _stage("k4", dev):
                            stripe = _k4_stripe(plan, i, j, sb)
                        _count_stripe(False)
                        with _stage("merge", dev):
                            if measure == "count":
                                vi, ii, vj, ij = _stripe_topk_candidates_k4(stripe, k,
                                                                            diagonal=i == j)
                            else:
                                # exact COO scores (zero-intersection pairs score 0
                                # for jaccard / dice / cosine / overlap)
                                li, lj, vv = _stripe_nz(stripe)
                                if i == j:
                                    nz = li != lj
                                    li, lj, vv = li[nz], lj[nz], vv[nz]
                                from stormtpu_torch.setops import derive_similarity

                                scores = derive_similarity(vv, nnz_pad[i * sb + li],
                                                           nnz_pad[j * sb + lj], bm.m_bits, measure)
                                vi, ii = _coo_rank_topk(li, lj, scores, sb, k, fill=-np.inf)
                                vj, ij = ((None, None) if i == j else
                                          _coo_rank_topk(lj, li, scores, sb, k, fill=-np.inf))
                        merge(i, vi, ii + j * sb)
                        if i != j:
                            merge(j, vj, ij + i * sb)
                        if measure in ("phi", "r2"):
                            zero_staircase(i, j, stripe)
                        continue
                    if order is not None and order.k4[i, j]:
                        # the density order's K4 stripe: dense, reduced as a stored one
                        with _stage("k4", dev):
                            counts = order.stripe_counts(i, j)
                        _route(ROUTE_K4)
                        _count_stripe(False)
                    else:
                        if measure == "count":
                            _route(route)
                            if route == ROUTE_TOPK:
                                vi, ii, vj, ij = _stripe_topk_sets(source, i, j, k)
                                _count_stripe(True)
                                merge(i, vi, ii)
                                if i != j:
                                    merge(j, vj, ij)
                                continue
                        elif order is not None:
                            _route(walk.kernel)
                        counts = _stripe_counts(source, i, j)
                        _count_stripe(True)
                    if measure != "count":
                        side_i, side_j = measure_stripe(i, j, counts)
                        merge(i, *side_i)
                        if side_j is not None:
                            merge(j, *side_j)
                        continue
                    vi, ii, vj, ij = _stripe_topk(counts, i * sb, j * sb, n, k=k, diagonal=i == j)
                    merge(i, vi, ii + j * sb)
                    if i != j:
                        merge(j, vj, ij + i * sb)
            if ckpt and dirty:
                # a crash restarts at the first unfinished row (its partial
                # merges die with the running best, so nothing is merged
                # twice); skipped rows write nothing
                save_checkpoint(i + 1)
        if ckpt and start_i < n_super:
            # completion marker: trailing skipped rows write no checkpoint, and
            # the extend wrapper needs an unambiguous "every stripe merged"
            save_checkpoint(n_super)
        with _stage("download", dev):
            best_v = download(best_v[:n])
            best_i = download(best_i[:n])
        if order is not None:
            # rows and partners back to the caller's ids; a partner past the
            # rows stays past them
            best_v, best_i = _unorder_rows(perm, best_v), _unorder_rows(perm, best_i)
            best_i = np.where(best_i < n, perm[np.minimum(best_i, n - 1)], n).astype(np.int32)
        by_value = np.argsort(-best_v, axis=1, kind="stable")
        vals = np.take_along_axis(best_v, by_value, axis=1)
        idx = np.take_along_axis(best_i, by_value, axis=1)
        # as query.topk_neighbors: only real partners survive
        if measure != "count":
            valid = np.isfinite(vals) & (idx < n)
            return np.where(valid, vals, 0.0), np.where(valid, idx, 0).astype(np.int32)
        valid = (vals >= 0) & (idx < n)
        return (np.where(valid, vals, 0).astype(np.int32),
                np.where(valid, idx, 0).astype(np.int32))


# ---------------------------------------------------------------- screens
def _purge_partial(out_dir: str, prefix: str, old_n: int, sb: int) -> None:
    """Delete the stripe files that touch the old partial last superblock
    (its zero-padded rows now hold data); nothing when it was whole."""
    if not old_n % sb:
        return
    last = old_n // sb
    n_super_old = round_up(old_n, sb) // sb
    for i in range(n_super_old):
        for j in range(i, n_super_old):
            if i == last or j == last:
                p = os.path.join(out_dir, f"{prefix}{i:05d}_{j:05d}.npz")
                if os.path.exists(p):
                    os.remove(p)


def _prepare_screen_extend(out_dir: str, man_path: str, prefix: str, old: dict,
                           same: bool, sb: int, new_params: dict, what: str) -> Optional[int]:
    """The on-disk preparation of a screen directory's extend. Returns the
    old row count the walk extends from, or None for a plain resume.

    The new manifest (with the key ``extend_from``) is written BEFORE the
    stale stripe files go, so a crash at any point leaves a directory that
    a second call finishes: the key names the stripes to delete again. The
    walk writes the plain manifest when it completes."""
    ext = old.get("extend_from")
    if ext is not None:
        if not same:
            raise ValueError(
                f"{what}: the directory holds an interrupted extend to n={old['n']}; "
                f"finish it with that panel first"
            )
        old_n = int(ext)
    elif same:
        return None
    else:
        old_n = int(old["n"])
        n_super_old = round_up(old_n, sb) // sb
        missing = [
            (i, j) for i in range(n_super_old) for j in range(i, n_super_old)
            if not os.path.exists(os.path.join(out_dir, f"{prefix}{i:05d}_{j:05d}.npz"))
        ]
        if missing:
            raise ValueError(
                f"{what}: the directory is an INCOMPLETE run ({len(missing)} stripe "
                f"files missing, e.g. {missing[0]}) — resume it to completion first"
            )
        _write_manifest(man_path, dict(new_params, extend_from=old_n))
    _purge_partial(out_dir, prefix, old_n, sb)
    return old_n


def extend_stream_pairs_above(
    bm: BitMatrix,
    out_dir: str,
    *,
    kernel: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grow a completed ``stream_pairs_above(out_dir=...)`` directory to
    ``bm``'s larger row count, reusing every hit file wholly inside the old
    complete superblocks (a hit file depends only on its two row
    superblocks). Files touching the old partial superblock are recomputed,
    and those with a new superblock computed. The measure, threshold and
    superblock come from the manifest; the resolved walk must round to the
    same superblock. The new manifest is written before any stale file is
    deleted, so an interrupted extend is finished by calling this again.
    Returns what ``stream_pairs_above`` returns."""
    man_path = os.path.join(out_dir, "screen_manifest.json")
    with open(man_path) as f:
        old = json.load(f)
    sb_old = int(old["superblock_rows"])
    if bm.m_bits != old["m_bits"]:
        raise ValueError(
            f"extend: m_bits {bm.m_bits} != directory's {old['m_bits']} — a changed "
            f"universe invalidates every stripe"
        )
    same = int(old["n"]) == bm.n and old["content"] == _content_fingerprint(bm)
    if not same and old.get("extend_from") is None:
        _check_extend_head(bm, int(old["n"]), old["content"], "extend")
    walk, _sparse, kernel_name = _walk_resolution(bm, sb_old, kernel, config, bitmap=True,
                                                  device=device)
    if walk.sb != sb_old:
        raise ValueError(
            f"extend: the resumed walk rounds superblock_rows to {walk.sb}, not the "
            f"directory's {sb_old} — reused hit files would misalign; match the "
            f"config/kernel"
        )
    measure, threshold = old["measure"], old["threshold"]
    params = _screen_store_params(bm, walk.sb, kernel_name, measure, threshold)
    ext = _prepare_screen_extend(out_dir, man_path, "hits_", old, same, walk.sb, params,
                                 "extend")
    return stream_pairs_above(
        bm, threshold, measure=measure, superblock_rows=walk.sb, kernel=kernel,
        config=config, out_dir=out_dir, resume=True, device=device, _extend_from=ext)


def stream_pairs_above(
    bm: BitMatrix,
    threshold: float,
    *,
    measure: str = "count",
    superblock_rows: int = 4096,
    kernel: str = "auto",
    config: Optional[EngineConfig] = None,
    out_dir: Optional[str] = None,
    resume: bool = True,
    device=None,
    _extend_from: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All unordered pairs (i < j) with measure ≥ threshold, at any N the
    host holds: ``query.pairs_above``'s contract (measure "count" or a
    similarity; (ii, jj, values) row-major, int32 counts or float64
    similarities).

    A stripe's hits are compacted on the device and come back in one copy,
    read while the next stripe runs. ``kernel`` and the operand as in
    :func:`stream_topk_neighbors`; on K4 stripes the exact counts are
    filtered on the host, and for r² the cardinality staircase adds the
    zero-intersection pairs K4 never emits.

    ``out_dir``: every computed stripe's hits go to
    ``hits_{i:05d}_{j:05d}.npz`` (skipped and empty stripes write an empty
    marker) and stripes whose file exists are not computed again. Keyed by
    a manifest on (n, m_bits, superblock, kernel, measure, threshold) and a
    content fingerprint; a mismatch raises (``resume=False`` overwrites)."""
    from stormtpu_torch.query import _validate_screen

    dev_thresh = float(_validate_screen(measure, threshold))
    with _span("stpu.stream.job") as job:
        dev = resolve_device(device)
        walk, sparse_mode, kernel_name = _walk_resolution(bm, superblock_rows, kernel, config,
                                                          bitmap=True, device=dev)
        sb, n_pad, n_super = walk.sb, walk.n_pad, walk.n_super
        plan = None
        if sparse_mode:
            from stormtpu_torch.stream import _SparseStripePlan

            with _stage("plan", dev):
                plan = _SparseStripePlan(bm, sb, n_super, dev)
        order = _walk_order(bm, walk, kernel, sparse_mode, out_dir, dev)
        perm = None if order is None else order.perm
        nnz = np.zeros(n_pad, dtype=np.int32)
        nnz[: bm.n] = bm.row_nnz if order is None else bm.row_nnz[perm]
        nnz_dev = None
        m_f = float(np.float32(bm.m_bits))
        out_i: list[np.ndarray] = []
        out_j: list[np.ndarray] = []
        out_c: list[np.ndarray] = []
        params = _screen_store_params(bm, sb, kernel_name, measure, threshold)
        store = _StripeStore(
            out_dir, "screen_manifest.json", "hits_",
            params if _extend_from is None else dict(params, extend_from=int(_extend_from)),
            resume)

        def emit(i, j, gi, gj, cvals):
            out_i.append(gi)
            out_j.append(gj)
            out_c.append(cvals)
            with _stage("save", dev):
                store.save(i, j, ii=gi, jj=gj, counts=cvals)

        def r2_zero_plan(i, j):
            return _r2_zero_plan(nnz[i * sb:(i + 1) * sb], nnz[j * sb:(j + 1) * sb], bm.m_bits,
                                 threshold)

        # co-empty stripes have all-zero counts, which pass no count screen
        # (threshold >= 1), no positive jaccard / dice / cosine / overlap
        # threshold, and no phi threshold (zero-intersection phi is <= 0); r²
        # scores zero-intersection pairs, and a co-empty stripe is nothing else:
        # the staircase emits its hits on the host
        occ_sb = _superblock_occupancy(bm, n_pad, sb, perm)
        empty64 = np.zeros(0, dtype=np.int64)
        source = _StripeCounts(bm, walk, dev, order)
        # a dense stripe's hits are read while the next stripe runs: its copy
        # starts when it is screened, and the host waits for it only after the
        # next stripe is launched
        hits = None
        pending = None

        def finish(i, j, launched) -> None:
            with _stage("download", dev):
                li, lj, cvals = hits.collect(launched)
            emit(i, j, li + i * sb, lj + j * sb, cvals)

        for i in range(n_super):
            for j in range(i, n_super):
                done = store.load(i, j)
                if done is not None:
                    if done["ii"].size:
                        out_i.append(done["ii"])
                        out_j.append(done["jj"])
                        out_c.append(done["counts"])
                    continue
                if occ_sb is not None and not (occ_sb[i] & occ_sb[j]).any():
                    if measure == "r2":
                        z_total, z_mat = r2_zero_plan(i, j)
                        if z_total:
                            zr, zc = z_mat(None, i == j)
                            emit(i, j, zr.astype(np.int64) + i * sb, zc.astype(np.int64) + j * sb,
                                 np.zeros(zr.size, dtype=np.int64))
                            continue
                    emit(i, j, empty64, empty64, empty64)
                    continue
                with _span("stpu.stream.stripe", job.number, i, j):
                    if plan is not None:
                        # r²'s staircase is counted first: the cost model is charged
                        # for its host work
                        z_total, z_mat = r2_zero_plan(i, j) if measure == "r2" else (0, None)
                        with _stage("plan", dev):
                            k4 = plan.use_k4(i, j, extra_emissions=z_total, emission_path=True)
                        if k4:
                            with _stage("k4", dev):
                                stripe = _k4_stripe(plan, i, j, sb)
                            _count_stripe(False)
                            with _stage("merge", dev):
                                li, lj, vv = _stripe_nz(stripe)
                                if i == j:
                                    up = li < lj  # strict upper triangle, no self
                                    li, lj, vv = li[up], lj[up], vv[up]
                                gi = li.astype(np.int64) + i * sb
                                gj = lj.astype(np.int64) + j * sb
                                if measure == "count":
                                    keep = vv >= threshold
                                else:
                                    from stormtpu_torch.setops import derive_similarity

                                    keep = derive_similarity(vv, nnz[gi], nnz[gj], bm.m_bits,
                                                             measure) >= threshold
                                gi, gj, vv = gi[keep], gj[keep], vv[keep]
                                if z_total:
                                    zr, zc = z_mat(stripe, i == j)
                                    gi = np.concatenate([gi, zr + i * sb])
                                    gj = np.concatenate([gj, zc + j * sb])
                                    vv = np.concatenate([vv, np.zeros(zr.size, dtype=vv.dtype)])
                            emit(i, j, gi, gj, vv.astype(np.int64))
                            continue
                    if nnz_dev is None:
                        nnz_dev = profiling.upload(torch.from_numpy(nnz), dev)
                        hits = _ScreenHits(dev)
                    if order is not None and order.k4[i, j]:
                        # the density order's K4 stripe: dense, screened as a K2 one
                        with _stage("k4", dev):
                            counts = order.stripe_counts(i, j)
                        _route(ROUTE_K4)
                        _count_stripe(False)
                    else:
                        if order is not None:
                            _route(walk.kernel)
                        counts = _stripe_counts(source, i, j)
                        _count_stripe(True)
                    launched = (i, j, hits.launch(
                        counts, nnz_dev[i * sb:(i + 1) * sb], nnz_dev[j * sb:(j + 1) * sb],
                        i * sb, j * sb, bm.n, dev_thresh, m_f, measure))
                    if pending is not None:
                        finish(*pending)
                    pending = launched
                    del counts
        if pending is not None:
            finish(*pending)
        if _extend_from is not None:
            store.finish(params)
        if not out_i:
            empty_v = np.zeros(0, np.int32) if measure == "count" else np.zeros(0, np.float64)
            return np.zeros(0, np.int32), np.zeros(0, np.int32), empty_v
        ii = np.concatenate(out_i)
        jj = np.concatenate(out_j)
        counts = np.concatenate(out_c)
        if order is not None:
            # a density-ordered walk's pairs in the caller's ids, i < j
            ii, jj = perm[ii], perm[jj]
            ii, jj = np.minimum(ii, jj), np.maximum(ii, jj)
        # stripes emit superblock-pair-major; the contract is row-major
        by_row = np.lexsort((jj, ii))
        ii, jj, counts = ii[by_row], jj[by_row], counts[by_row]
        if measure == "count":
            return ii.astype(np.int32), jj.astype(np.int32), counts.astype(np.int32)
        from stormtpu_torch.setops import derive_similarity

        vals = derive_similarity(counts, bm.row_nnz[ii], bm.row_nnz[jj], bm.m_bits, measure)
        keep = vals >= threshold
        return ii[keep].astype(np.int32), jj[keep].astype(np.int32), vals[keep]


# ------------------------------------------------- pairwise-complete screen
class _QuadSlices:
    """The complete screen's four superblock slices on the device, as one
    [4·SB, w_pad] buffer: data and mask of row block i, then data and mask
    of row block j (block i's stay across its row of stripes). Each count
    grid of a stripe is one tile walk on the buffer with block ids."""

    def __init__(self, bm_d: BitMatrix, bm_m: BitMatrix, walk: _Walk, dev: torch.device):
        self.mats, self.walk, self.dev = (bm_d, bm_m), walk, dev
        self.buf = torch.zeros((4 * walk.sb, walk.w_pad), dtype=torch.int32, device=dev)
        self.loaded = [-1] * 4

    def load(self, i: int, j: int) -> None:
        sb, w_pad = self.walk.sb, self.walk.w_pad
        with _stage("upload", self.dev):
            for q, blk in enumerate((i, i) if i == j else (i, i, j, j)):
                if self.loaded[q] == blk:
                    continue
                bm = self.mats[q % 2]
                host = _host_superblock(bm.packed, bm.n, sb, w_pad, blk)
                self.buf[q * sb:(q + 1) * sb].copy_(torch.from_numpy(host.view(np.int32)))
                self.loaded[q] = blk

    def grid(self, qa: int, qb: int, symmetric: bool = False) -> torch.Tensor:
        """Counts int32 [SB, SB] of slice qa's rows against slice qb's
        (``symmetric``: qa == qb, the triangular tiles mirrored)."""
        w = self.walk
        sb, tps = w.sb, w.sb // w.ti
        if w.kernel in ("xla_int8", "xla_popcount"):
            return _block_stripe(self.buf[qa * sb:(qa + 1) * sb],
                                 self.buf[qb * sb:(qb + 1) * sb], w.kernel)
        loc_i, loc_j = _stripe_tile_ids(tps, symmetric)
        return _tile_stripe(self.buf, loc_i + qa * tps, loc_j + qb * tps, loc_i, loc_j, tps,
                            w.ti, w.wk, w.kernel, symmetric)


def _stripe_screen_complete(slices: _QuadSlices, i: int, j: int, n: int, thresh: float, *,
                            measure: str):
    """One stripe of the pairwise-complete screen: four count grids
    (data·dataᵀ, data·maskᵀ, mask·dataᵀ, mask·maskᵀ) feed the per-pair
    universe's screen formulas (``query._screen_vals_core``). On a diagonal
    stripe mask·dataᵀ is data·maskᵀ transposed and the symmetric grids take
    the triangular tiles. Returns the packed hit bits and their summary."""
    from stormtpu_torch.query import _pack_bit_rows, _screen_vals_core, _word_summary

    slices.load(i, j)
    diagonal = i == j
    inter = slices.grid(0, 0, True) if diagonal else slices.grid(0, 2)
    dm = slices.grid(0, 1) if diagonal else slices.grid(0, 3)
    md = dm.T if diagonal else slices.grid(1, 2)
    mm = slices.grid(1, 1, True) if diagonal else slices.grid(1, 3)
    dev = inter.device
    sb = slices.walk.sb
    with _stage("reduce", dev):
        vals = _screen_vals_core(inter, dm.to(torch.float32), md.to(torch.float32),
                                 mm.to(torch.float32), measure)
        rows, cols = _grid_coords(vals.shape, i * sb, j * sb, dev)
        hits = _pack_bit_rows((vals >= thresh) & (cols > rows) & (rows < n) & (cols < n))
        return hits, _word_summary(hits)


def extend_stream_pairs_above_complete(
    data: BitMatrix,
    mask: BitMatrix,
    out_dir: str,
    *,
    kernel: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grow a completed ``stream_pairs_above_complete(out_dir=...)``
    directory to the larger (data, mask) panel: candidate files wholly
    inside the old complete superblocks are reused (the assembly re-derives
    every value from the current packed rows). Both matrices' heads are
    fingerprint-checked; the measure, threshold and superblock come from
    the manifest, which is written before any stale file is deleted."""
    from stormtpu_torch.setops import _complete_operands

    man_path = os.path.join(out_dir, "complete_screen_manifest.json")
    with open(man_path) as f:
        old = json.load(f)
    sb_old = int(old["superblock_rows"])
    bm_d, bm_m = _complete_operands(data, mask)
    if bm_d.m_bits != old["m_bits"]:
        raise ValueError(
            f"extend: m_bits {bm_d.m_bits} != directory's {old['m_bits']} — a changed "
            f"universe invalidates every stripe"
        )
    same = (int(old["n"]) == bm_d.n
            and old["content_data"] == _content_fingerprint(bm_d)
            and old["content_mask"] == _content_fingerprint(bm_m))
    if not same and old.get("extend_from") is None:
        _check_extend_head(bm_d, int(old["n"]), old["content_data"], "extend (data)")
        _check_extend_head(bm_m, int(old["n"]), old["content_mask"], "extend (mask)")
    walk = _resolve_stripe_config(bm_d, sb_old, kernel, config, bitmap=True,
                                  device=device)
    if walk.sb != sb_old:
        raise ValueError(
            f"extend: the resumed walk rounds superblock_rows to {walk.sb}, not the "
            f"directory's {sb_old} — reused candidate files would misalign; match the "
            f"config/kernel"
        )
    measure, threshold = old["measure"], old["threshold"]
    params = _complete_store_params(bm_d, bm_m, walk.sb, walk.kernel, measure, threshold)
    ext = _prepare_screen_extend(out_dir, man_path, "chits_", old, same, walk.sb, params,
                                 "extend")
    return stream_pairs_above_complete(
        data, mask, threshold, measure=measure, superblock_rows=walk.sb, kernel=kernel,
        config=config, out_dir=out_dir, resume=True, device=device, _extend_from=ext)


def stream_pairs_above_complete(
    data: BitMatrix,
    mask: BitMatrix,
    threshold: float,
    *,
    measure: str = "r2",
    superblock_rows: int = 4096,
    kernel: str = "auto",
    config: Optional[EngineConfig] = None,
    out_dir: Optional[str] = None,
    resume: bool = True,
    device=None,
    _extend_from: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pairwise-complete missing-data screen at any N the host holds:
    ``setops.pairs_above_complete``'s contract, with four superblock
    slices on the device a stripe (data and mask of both row blocks). Each
    pair is scored over its co-observed universe: a float32 screen with
    slack on the device, the hits re-derived exactly on the host.

    Stripes are skipped on the data's block summary for jaccard, dice,
    cosine, overlap and phi (no shared data bit: score ≤ 0 below any valid
    threshold), and for r² on the mask's (no data bit of one block meets an
    observed bit of the other, in either direction: a zero denominator).

    ``out_dir``: per-stripe candidate files ``chits_{i:05d}_{j:05d}.npz``
    under a manifest fingerprinting both matrices, as
    :func:`stream_pairs_above` (``resume=False`` overwrites)."""
    from stormtpu_torch.query import _validate_screen
    from stormtpu_torch.setops import SIM_OPS, _complete_operands, _complete_refine

    if measure not in SIM_OPS:
        raise ValueError(
            f"unknown measure {measure!r}; want one of {SIM_OPS} "
            f"('count' does not depend on the mask — use stream_pairs_above)"
        )
    dev_thresh = float(_validate_screen(measure, threshold))
    dev = resolve_device(device)
    bm_d, bm_m = _complete_operands(data, mask)
    walk = _resolve_stripe_config(bm_d, superblock_rows, kernel, config, bitmap=True,
                                  device=dev)
    sb, n_pad, n_super = walk.sb, walk.n_pad, walk.n_super
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    params = _complete_store_params(bm_d, bm_m, sb, walk.kernel, measure, threshold)
    store = _StripeStore(
        out_dir, "complete_screen_manifest.json", "chits_",
        params if _extend_from is None else dict(params, extend_from=int(_extend_from)),
        resume)

    def emit(i, j, gi, gj):
        out_i.append(gi)
        out_j.append(gj)
        with _stage("save", dev):
            store.save(i, j, ii=gi, jj=gj)

    # data ⊆ mask rowwise, so co-empty masks imply both cross conditions
    occ_d = _superblock_occupancy(bm_d, n_pad, sb)
    occ_m = _superblock_occupancy(bm_m, n_pad, sb) if measure == "r2" else None

    def skippable(i: int, j: int) -> bool:
        if occ_d is None:
            return False
        if measure == "r2":
            if occ_m is None:
                return False
            return not (occ_d[i] & occ_m[j]).any() or not (occ_m[i] & occ_d[j]).any()
        return not (occ_d[i] & occ_d[j]).any()

    empty64 = np.zeros(0, dtype=np.int64)
    slices = None
    for i in range(n_super):
        for j in range(i, n_super):
            done = store.load(i, j)
            if done is not None:
                if done["ii"].size:
                    out_i.append(done["ii"])
                    out_j.append(done["jj"])
                continue
            if skippable(i, j):
                emit(i, j, empty64, empty64)
                continue
            if slices is None:
                slices = _QuadSlices(bm_d, bm_m, walk, dev)
            hits_d, summary_d = _stripe_screen_complete(slices, i, j, bm_d.n, dev_thresh,
                                                        measure=measure)
            _count_stripe(True)
            with _stage("download", dev):
                li, lj = _fetch_hits(hits_d, download(summary_d), sb)
            emit(i, j, li + i * sb, lj + j * sb)
    if _extend_from is not None:
        store.finish(params)
    if not sum(a.size for a in out_i):
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float64)
    ii = np.concatenate(out_i)
    jj = np.concatenate(out_j)
    order = np.lexsort((jj, ii))
    with _stage("refine", dev):
        return _complete_refine(bm_d, bm_m, ii[order], jj[order], measure, threshold)
