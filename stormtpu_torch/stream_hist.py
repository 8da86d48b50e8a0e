"""Density-adaptive histogram walks (port of ``stormtpu/stream_hist.py``).

``stats.count_histogram`` routes here by the streaming count walk's
kernel-resolution policy (``stream._resolve_stream_kernel``):

- the K4 regime: :func:`stream_hist_sparse` bins each stripe's exact
  counts from ``_SparseStripePlan`` (K4's kernels on a card, binned there)
  and credits the zero pairs to bin 0 by arithmetic; a stripe where the
  cost model prefers the dense kernel takes the K2 stripe on the card;
- the block-clustered regime: :func:`stream_hist_clustered` runs each
  stripe's summary-AND work list through K5 and bins only the visited
  tiles; the unvisited tiles' pairs go to bin 0 (their counts are exactly
  zero);
- the dense regime above the device's operand budget:
  :func:`stream_hist_streamed` keeps two superblock slices on the device
  (``stream._SliceBuffer``); co-empty stripes bin to 0 without an upload.

A stripe's tiles are binned on their device: the valid pairs (global row <
global column < n) are masked and counted, inside K2-hist
(``kernels.mxu.count_tiles_hist``, the dense stripes of the first and last
walk, up to ``mxu.HIST_EPI_MAX_BINS`` bins) or with one bin count of the
stored tiles (:func:`_bin_counts`: K5's tiles, and the rule
``mxu.hist_route`` above that many bins),
into a device total read back once at the end of the walk (the JAX
package reduces bin by bin because scatter is slow on its TPU). All three
share the manifest of ``stream.stream_count_histogram``: uniform bins, the
last bin absorbing the tail, mass conservation asserted.

Every walk takes ``device=None`` (the card) or ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.layout import BitMatrix
from stormtpu_torch.utils import resolve_device, round_up

__all__ = [
    "stream_hist_sparse",
    "stream_hist_clustered",
    "stream_hist_streamed",
]


def _hist_manifest(n: int, m_bits: int, sb: int, n_super: int, kernel: str,
                   n_bins: int, bin_width: int, hist: np.ndarray,
                   extra: Optional[dict] = None) -> dict:
    expect = n * (n - 1) // 2
    got = int(hist.sum())
    if got != expect:
        raise AssertionError(
            f"histogram mass {got} != n*(n-1)/2 = {expect} — a pair was "
            "double-counted or dropped; this is a bug, not an input error"
        )
    edges = np.minimum(
        np.arange(n_bins + 1, dtype=np.int64) * bin_width, m_bits + 1
    )
    man = {
        "n": n,
        "m_bits": m_bits,
        "superblock_rows": sb,
        "n_super": n_super,
        "kernel": kernel,
        "sink": "histogram",
        "n_bins": n_bins,
        "bin_width": int(bin_width),
        "bin_edges": edges,
        "hist": hist,
        "pairs": got,
    }
    if extra:
        man.update(extra)
    return man


def _valid_rows(n: int, sb: int, i: int) -> int:
    return max(0, min(n - i * sb, sb))


def _stripe_pair_mass(n: int, sb: int, i: int, j: int) -> int:
    """Number of valid global pairs (r < c < n) inside stripe (i, j)."""
    vi, vj = _valid_rows(n, sb, i), _valid_rows(n, sb, j)
    return vi * (vi - 1) // 2 if i == j else vi * vj


def _bin_values(hist: np.ndarray, vals: np.ndarray, bin_width: int,
                n_bins: int) -> None:
    """Accumulate exact integer counts into uniform bins, in place."""
    if vals.size:
        b = np.minimum(vals.astype(np.int64) // bin_width, n_bins - 1)
        hist += np.bincount(b, minlength=n_bins)


def _bin_counts(bins: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(bins, minlength=n)`` (int64 [n]) with the atomics'
    contention spread: element e of value b counts into sub-bin 32·b + e %
    32, and the sub-bins are summed. A histogram's values crowd into a bin
    or two (a panel's pair counts lie within a few sd of their mean), which
    serialises a plain bin count (``scripts/torch_query_ab.py`` times
    both)."""
    lane = torch.arange(bins.numel(), device=bins.device) & 31
    return torch.bincount(bins.flatten() * 32 + lane, minlength=n * 32).view(n, 32).sum(dim=1)


def _bin_tiles(hist_d: torch.Tensor, tiles: torch.Tensor, rows_g: torch.Tensor,
               cols_g: torch.Tensor, n: int, bin_width: int, n_bins: int,
               slot_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the valid pairs of count tiles [T, ti, ti] into ``hist_d`` (int64
    [n_bins] on their device) and return how many there were (a 0-d
    tensor). Tile t's rows are global rows ``rows_g[t]``, its columns
    ``cols_g[t]``; a pair is valid when row < col < n (and its tile's
    ``slot_ok``). Invalid entries go to a spare bin past the last, then
    dropped."""
    from stormtpu_torch.stream import _stage

    with _stage("bin", tiles.device):
        valid = (rows_g[:, :, None] < cols_g[:, None, :]) & (cols_g[:, None, :] < n)
        if slot_ok is not None:
            valid &= slot_ok[:, None, None]
        bins = torch.clamp(tiles // bin_width, max=n_bins - 1)
        hist_d += _bin_counts(torch.where(valid, bins, n_bins), n_bins + 1)[:n_bins]
        return valid.sum(dtype=torch.int64)


class _PairStripes:
    """The dense stripe histograms of the streamed and sparse walks: K2
    tiles of the two-slice buffer (``_SliceBuffer``: a diagonal stripe on
    the i slice alone with its triangular tile list, an off-diagonal one on
    both slices with local ids, the j tiles shifted by a superblock),
    binned on the device, inside K2-hist where ``mxu.hist_route`` says so."""

    def __init__(self, bm: BitMatrix, sb: int, tile_rows: int, tile_words: int,
                 variant: str, dev: torch.device):
        from stormtpu_torch.stream import _SliceBuffer, _stripe_tile_ids

        self.n, self.sb, self.ti, self.wk, self.variant = bm.n, sb, tile_rows, tile_words, variant
        self.tps = sb // tile_rows
        self.slices = _SliceBuffer(bm, sb, round_up(bm.n_words, tile_words), dev)
        self.lists = {d: _stripe_tile_ids(self.tps, d) for d in (True, False)}
        self.lane = torch.arange(tile_rows, device=dev)

    def add(self, hist_d: torch.Tensor, i: int, j: int, bin_width: int, n_bins: int) -> None:
        from stormtpu_torch.kernels import mxu
        from stormtpu_torch.stream import _route, _stage

        x = self.slices.stripe_operand(i, j)
        loc_i, loc_j = self.lists[i == j]
        dev = x.device
        with _stage("plan", dev):
            ids = mxu.device_tile_ids(loc_i, loc_j if i == j else loc_j + self.tps,
                                      x.shape[0] // self.ti, dev)
        col0adj = j * self.sb - (0 if i == j else self.sb)  # the j tiles sit at +tps
        route = mxu.hist_route(n_bins)
        _route(route)
        if route == mxu.ROUTE_HIST:
            with _stage("kernel", dev):
                hist_d += mxu.count_tiles_hist(
                    x, *ids, tile_rows=self.ti, tile_words=self.wk, n_real=self.n,
                    bin_width=bin_width, n_bins=n_bins, row_off=i * self.sb, col_off=col0adj,
                    variant=self.variant, checked=ids)
            return
        with _stage("kernel", dev):
            tiles = mxu.count_tiles_pallas_mxu(x, *ids, tile_rows=self.ti, tile_words=self.wk,
                                               variant=self.variant, checked=ids)
        rows_g = i * self.sb + ids.ibs[:, None] * self.ti + self.lane[None, :]
        cols_g = col0adj + ids.jbs[:, None] * self.ti + self.lane[None, :]
        _bin_tiles(hist_d, tiles, rows_g, cols_g, self.n, bin_width, n_bins)


def stream_hist_streamed(
    bm: BitMatrix,
    *,
    n_bins: int = 64,
    bin_width: Optional[int] = None,
    superblock_rows: int = 4096,
    config: Optional[EngineConfig] = None,
    occupancy: Optional[np.ndarray] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """Operand-streaming histogram walk: only two superblock slices are on
    the device a stripe (the i slice kept across its row), so the padded
    matrix never has to fit there. Co-empty stripes bin to 0 on the host
    and skip the upload."""
    from stormtpu_torch.stream import (
        _read_back,
        _superblock_pairs,
        cap_hist_superblock,
        default_hist_bin_width,
    )
    from stormtpu_torch.stream_query import _superblock_occupancy

    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    n = bm.n
    if bin_width is None:
        bin_width = default_hist_bin_width(bm.m_bits, n_bins)
    tile_rows = min(cfg.k2_tile_rows, round_up(max(n, 32), 32))
    sb = cap_hist_superblock(round_up(superblock_rows, tile_rows), tile_rows)
    n_pad = round_up(n, sb)
    n_super = n_pad // sb
    if occupancy is None:
        occupancy = _superblock_occupancy(bm, n_pad, sb)
    elif occupancy.shape[0] != n_super:
        # a wrong-geometry occupancy is the one error the mass check cannot
        # catch (skipped stripes credit bin 0 by arithmetic)
        raise ValueError(
            f"occupancy has {occupancy.shape[0]} superblocks, walk has "
            f"{n_super} — compute it with the same superblock_rows "
            f"({sb} after tile rounding and the int32 cap)"
        )
    stripes = _PairStripes(bm, sb, tile_rows, cfg.k2_tile_words, cfg.k2_variant, dev)
    hist_d = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    hist = np.zeros(n_bins, dtype=np.int64)
    total = n_super * (n_super + 1) // 2
    done = 0
    skipped = 0
    for i, j in _superblock_pairs(n_super):
        if occupancy is not None and not (occupancy[i] & occupancy[j]).any():
            hist[0] += _stripe_pair_mass(n, sb, i, j)
            skipped += 1
        else:
            stripes.add(hist_d, i, j, bin_width, n_bins)
        done += 1
        if progress is not None:
            progress(done, total)
    hist += _read_back(hist_d)
    return _hist_manifest(
        n, bm.m_bits, sb, n_super, "mxu", n_bins, bin_width, hist,
        extra={"operand_streaming": True, "stripes_skipped": skipped},
    )


def stream_hist_sparse(
    bm: BitMatrix,
    *,
    n_bins: int = 64,
    bin_width: Optional[int] = None,
    superblock_rows: int = 4096,
    config: Optional[EngineConfig] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """K4-regime histogram: per-superblock inverted-index emission
    (``_SparseStripePlan``: K4's kernels on a card, binned there; the C++
    tier on the CPU; the few-emission stripes on the host), binning each
    stripe's exact nonzero counts and crediting its zero pairs to bin 0.
    The cost model decides each stripe between K4 and the K2 stripe on the
    card, as in the counts walk."""
    from stormtpu_torch import native
    from stormtpu_torch.stream import (
        _read_back,
        _SparseStripePlan,
        _stage,
        _superblock_pairs,
        cap_hist_superblock,
        default_hist_bin_width,
    )

    if not native.have_native():
        raise RuntimeError(
            "the sparse histogram route needs the native C++ tier "
            f"(stormtpu_torch.native build failed or was disabled): {native.native_build_error()}"
        )
    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    n = bm.n
    if bin_width is None:
        bin_width = default_hist_bin_width(bm.m_bits, n_bins)
    tile_rows = cfg.k2_tile_rows
    sb = cap_hist_superblock(round_up(superblock_rows, tile_rows), tile_rows)
    n_super = round_up(n, sb) // sb
    with _stage("plan", dev):
        plan = _SparseStripePlan(bm, sb, n_super, dev)
    stripes = None  # made at the first dense stripe: an all-K4 walk uploads nothing
    hist_d = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    hist = np.zeros(n_bins, dtype=np.int64)
    stripe_kernels = {"k4": 0, "dense": 0}
    total = n_super * (n_super + 1) // 2
    done = 0
    for i, j in _superblock_pairs(n_super):
        mass = _stripe_pair_mass(n, sb, i, j)
        if plan.use_k4(i, j, emission_path=True):
            with _stage("k4", dev):
                if plan.emission_eligible(i, j):
                    ci, cj, cv = plan.stripe_coo(i, j)
                    if i == j:
                        # the COO is the full square with the self pairs:
                        # the strict upper triangle keeps each pair once
                        cv = cv[ci < cj]
                    _bin_values(hist, cv, bin_width, n_bins)
                    hist[0] += mass - cv.size
                else:
                    # binned on the stripe's device; its values hold the
                    # zero pairs, whose mass lands in bin 0
                    stripe = plan.stripe_counts(i, j)
                    vi, vj = _valid_rows(n, sb, i), _valid_rows(n, sb, j)
                    if i == j:
                        lane = torch.arange(vi, device=dev)
                        vals = stripe[:vi, :vi][lane[:, None] < lane[None, :]]
                    else:
                        vals = stripe[:vi, :vj].flatten()
                    hist_d += _bin_counts(
                        torch.clamp(vals.long() // bin_width, max=n_bins - 1), n_bins)
                    del stripe, vals
            stripe_kernels["k4"] += 1
        else:
            if stripes is None:
                stripes = _PairStripes(bm, sb, tile_rows, cfg.k2_tile_words,
                                       cfg.k2_variant, dev)
            stripes.add(hist_d, i, j, bin_width, n_bins)
            stripe_kernels["dense"] += 1
        done += 1
        if progress is not None:
            progress(done, total)
    hist += _read_back(hist_d)
    return _hist_manifest(
        n, bm.m_bits, sb, n_super, "sparse_outer", n_bins, bin_width, hist,
        extra={"stripe_kernels": stripe_kernels},
    )


def stream_hist_clustered(
    bm: BitMatrix,
    *,
    n_bins: int = 64,
    bin_width: Optional[int] = None,
    superblock_rows: int = 4096,
    config: Optional[EngineConfig] = None,
    operand_streaming: Optional[bool] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> Optional[dict]:
    """K5-regime histogram: per-stripe summary-AND work lists, so only the
    co-occupied (tile pair, K-group) items run; the unvisited tiles' pairs
    go to bin 0. The visited tiles' valid pairs are counted on the device
    beside their bins, so the bin-0 remainder is one subtraction. Returns
    None for a single K-group (the caller takes the dense route)."""
    from stormtpu_torch.kernels.clustered import (
        _block_occupancy,
        build_stripe_worklist,
        count_tiles_worklist,
        device_worklist,
        padded_operand,
    )
    from stormtpu_torch.stream import (
        _device_operand_budget,
        _read_back,
        _SliceBuffer,
        _stage,
        _superblock_pairs,
        cap_hist_superblock,
        default_hist_bin_width,
    )

    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    geo = _block_occupancy(bm, cfg)
    if geo is None:
        return None
    occ, ti, wk, _, nb, ng = geo
    n = bm.n
    if bin_width is None:
        bin_width = default_hist_bin_width(bm.m_bits, n_bins)
    sb = cap_hist_superblock(round_up(superblock_rows, ti), ti)
    tps = sb // ti
    n_sb_pad = round_up(n, sb)
    nb_sb = n_sb_pad // ti
    if nb_sb > nb:
        occ = np.concatenate([occ, np.zeros((nb_sb - nb, ng), dtype=bool)], axis=0)
    n_super = n_sb_pad // sb
    w_pad = (ng + 1) * wk  # a trailing zero pad K-group
    if operand_streaming is None:
        operand_streaming = n_sb_pad * w_pad * 4 > _device_operand_budget(dev, 4 * sb * sb)
    packed_d = slices = None
    lane = torch.arange(ti, device=dev)
    hist_d = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    valid_d = torch.zeros((), dtype=torch.int64, device=dev)
    hist = np.zeros(n_bins, dtype=np.int64)
    work_items = 0
    total = n_super * (n_super + 1) // 2
    done = 0
    skipped = 0
    for i, j in _superblock_pairs(n_super):
        mass = _stripe_pair_mass(n, sb, i, j)
        with _stage("plan", dev):
            wl = build_stripe_worklist(occ, i * tps, j * tps, tps, i == j)
        if wl is None:
            hist[0] += mass
            skipped += 1
        else:
            if operand_streaming:
                if slices is None:
                    slices = _SliceBuffer(bm, sb, w_pad, dev)
                x = slices.stripe_operand(i, j)
                shift = dict(ibs_shift=i * tps,
                             jbs_shift=i * tps if i == j else (j - 1) * tps)
            else:
                if packed_d is None:
                    with _stage("upload", dev):
                        packed_d = padded_operand(bm, n_sb_pad, w_pad, dev)
                x, shift = packed_d, {}
            with _stage("plan", dev):
                work = device_worklist(wl, dev, nb=x.shape[0] // ti, ng=ng + 1,
                                       tile_rows=ti, **shift)
                # global tile coordinates of each visited slot
                vis = torch.from_numpy(np.stack([wl.vis_loc_i + i * tps,
                                                 wl.vis_loc_j + j * tps])).to(dev)
            with _stage("kernel", dev):
                tiles = count_tiles_worklist(
                    x, *work, n_slots=wl.n_vis, tile_rows=ti, tile_words=wk,
                    variant=cfg.k2_variant, checked=work,
                )
            rows_g = vis[0][:, None] * ti + lane[None, :]
            cols_g = vis[1][:, None] * ti + lane[None, :]
            valid_d += _bin_tiles(hist_d, tiles, rows_g, cols_g, n, bin_width, n_bins)
            # unvisited tiles hold exactly-zero counts: their share of the
            # stripe's valid pairs goes to bin 0
            hist[0] += mass
            work_items += wl.n_work
            del tiles
        done += 1
        if progress is not None:
            progress(done, total)
    with _stage("read_back", dev):
        hist += _read_back(hist_d)
        hist[0] -= int(_read_back(valid_d))
    return _hist_manifest(
        n, bm.m_bits, sb, n_super, "clustered", n_bins, bin_width, hist,
        extra={"work_items": work_items, "stripes_skipped": skipped,
               "operand_streaming": bool(operand_streaming),
               "tile_rows": ti},
    )
