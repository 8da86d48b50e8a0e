"""K5 — the block-clustered work list (port of
``stormtpu/kernels/clustered.py`` for one matrix).

The host plans, the card counts. ``BitMatrix.block_summary`` gives each
row's K-group occupancy (one group = one K2 K step of ``wk`` words),
OR-reduced per ``ti``-row block to ``occ[nb, ng]``. Every upper-triangular
tile pair (ib, jb) needs only the groups where ``occ[ib] & occ[jb]``: one
work item (tile pair, group) per such group, sorted by output slot. Tile
pairs with no co-occupied group never reach the card; their counts are
exactly zero. :func:`build_clustered_plan` is a copy of the JAX package's
planner and gives the same arrays.

:func:`count_tiles_worklist` runs the items on the card with the K2 tile
body (CUDA entry ``k5_launch`` in ``csrc/k2_mxu.cu``); a tensor on the CPU
takes its plain version, :func:`count_tiles_worklist_plain`. The CUDA
kernel runs "units": one 128×256 sub-tile of one slot, whose block walks
the slot's items with the sums in registers and stores once. So it needs
the items sorted by slot and ``first`` marking each slot's first item (the
wrapper checks both). One block an SM takes unit after unit off a schedule
built on the host from the slots' lengths (:func:`schedule_units`: longest
first, so that the card's SMs end together) and keeps its loads running
from one unit into the next. A slot with no items comes out zero; the JAX
kernel leaves such memory undefined, so no valid result changes.

The check and the schedule need the work list on the host. A caller with
bare device tensors pays a read-back for them on every call. The path
does not: :func:`device_worklist` checks the plan's numpy arrays and
builds the schedule once, and hands the wrapper a :class:`DeviceWorklist`
(``checked=``), which the wrapper accepts only for the very tensors that
were checked.

Exactness: as K2 (0/1 products, int32 sums, M < 2³¹); a dropped
(tile pair, group) contributes zero by construction of the summary.
``variant`` ("concat"/"planes") is accepted for parity and has no effect.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from stormtpu_torch.config import WORD_BITS, EngineConfig, default_config
from stormtpu_torch.kernels.mxu import (
    _check_cuda_ids,
    _check_cuda_operand,
    _check_geometry,
    _check_variant,
    _launch,
    count_matrix_pallas_mxu,
    k2_tile_shape,
)
from stormtpu_torch.kernels.xla import int8_dot_nt, unpack_to_int8
from stormtpu_torch.utils import (
    assemble_triangular_torch,
    download,
    quantize_bucket,
    resolve_device,
    round_up,
)

__all__ = [
    "LAUNCHES",
    "ClusteredPlan",
    "DeviceWorklist",
    "ShardedClusteredPlan",
    "StripeWorklist",
    "build_clustered_plan",
    "build_sharded_clustered_plan",
    "build_stripe_worklist",
    "check_worklist",
    "clustered_work_fraction",
    "count_matrix_clustered",
    "count_tiles_worklist",
    "count_tiles_worklist_plain",
    "device_operand",
    "device_worklist",
    "pack_sharded_clustered_operand",
    "padded_operand",
    "reset_launches",
    "schedule_units",
]

# CUDA launches of the K5 wrapper; the plain version does not count.
LAUNCHES = {"k5": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class ClusteredPlan:
    """Host-built execution plan for the K5 work-list kernel."""

    ti: int                 # tile rows
    wk: int                 # words per K-group (= K2 K step)
    n_pad: int
    w_pad: int              # includes one trailing all-zero pad group
    nb: int                 # row blocks
    ng: int                 # real K-groups (pad group excluded)
    slot_ibs: np.ndarray    # int32 [P] visited tile-pair row blocks
    slot_jbs: np.ndarray    # int32 [P]
    ibs_w: np.ndarray       # int32 [T_pad] work-item row block
    jbs_w: np.ndarray       # int32 [T_pad]
    gsel_w: np.ndarray      # int32 [T_pad] work-item K-group
    slots_w: np.ndarray     # int32 [T_pad] output slot
    first_w: np.ndarray     # int32 [T_pad] 1 = first item of its slot
    n_slots: int            # bucket-padded output slots (≥ P); pad slots
                            # are zero-written by one filler item each
    n_work: int             # real items (before bucket padding)
    work_fraction: float    # n_work / (T_tri · ng): the dispatch statistic


def _block_occupancy(bm, cfg: EngineConfig):
    """Per-tile-block K-group occupancy bool [nb, ng] (+ tile geometry),
    cached on the BitMatrix — the one O(N·W) summary scan, shared by the
    dispatch statistic and the planner. None when ng < 2 (a single
    K-group: the summary cannot skip anything)."""
    n, w = bm.n, bm.n_words
    if n == 0 or w == 0:
        return None
    ti, wk = k2_tile_shape(cfg, n, w)
    ng = -(-w // wk)
    if ng < 2:
        return None
    cache = bm.__dict__.setdefault("_occ_cache", {})
    key = (ti, wk)
    hit = cache.get(key)
    if hit is None:
        n_pad = round_up(n, ti)
        nb = n_pad // ti
        occ_rows = bm.block_summary(block_bits=wk * WORD_BITS).astype(bool)
        occ = np.zeros((nb * ti, ng), dtype=bool)
        occ[:n] = occ_rows
        occ = occ.reshape(nb, ti, ng).any(axis=1)  # [nb, ng]
        hit = (occ, ti, wk, n_pad, nb, ng)
        cache[key] = hit
    return hit


def clustered_work_fraction(
    bm, config: Optional[EngineConfig] = None
) -> Optional[float]:
    """Fraction of (upper-triangular tile pair, K-group) cells whose
    summaries co-occupy — K5's work relative to the full K2 walk. None
    where the skip is inapplicable (single K-group)."""
    cfg = config or default_config()
    geo = _block_occupancy(bm, cfg)
    if geo is None:
        return None
    occ, ti, wk, n_pad, nb, ng = geo
    ibs_t, jbs_t = np.triu_indices(nb)
    co = occ[ibs_t] & occ[jbs_t]
    return float(co.sum()) / float(ibs_t.size * ng)


def build_clustered_plan(
    bm, config: Optional[EngineConfig] = None
) -> Optional[ClusteredPlan]:
    """Summary-AND planning: per-tile-block K-group occupancy → sorted
    (tile pair, group) work list. None for degenerate shapes (single
    K-group) or an all-empty matrix."""
    cfg = config or default_config()
    geo = _block_occupancy(bm, cfg)
    if geo is None:
        return None
    occ, ti, wk, n_pad, nb, ng = geo

    ibs_t, jbs_t = np.triu_indices(nb)
    co = occ[ibs_t] & occ[jbs_t]               # [T_tri, ng] summary AND
    pair_idx, group_idx = np.nonzero(co)       # sorted by pair (row-major)
    n_work = pair_idx.size
    t_tri = ibs_t.size
    work_fraction = n_work / float(t_tri * ng)
    if n_work == 0:
        return None

    # visited tile pairs → output slots, in pair order
    visited, slot_of_item = np.unique(pair_idx, return_inverse=True)
    slot_ibs = ibs_t[visited].astype(np.int32)
    slot_jbs = jbs_t[visited].astype(np.int32)
    first = np.empty(n_work, dtype=np.int32)
    first[0] = 1
    first[1:] = (slot_of_item[1:] != slot_of_item[:-1]).astype(np.int32)

    # bucket the slot and item counts (≤12.5% padding): pad slots are
    # zero-written by one filler item each (first=1, zero pad K-group),
    # then tail items are exact no-ops (first=0, zero group) into the last
    # slot
    p = visited.size
    n_slots = quantize_bucket(p)
    n_fill = n_slots - p
    t_pad = quantize_bucket(n_work + n_fill)
    ibs_w = np.zeros(t_pad, dtype=np.int32)
    jbs_w = np.zeros(t_pad, dtype=np.int32)
    gsel_w = np.full(t_pad, ng, dtype=np.int32)
    slots_w = np.full(t_pad, n_slots - 1, dtype=np.int32)
    first_w = np.zeros(t_pad, dtype=np.int32)
    ibs_w[:n_work] = ibs_t[pair_idx]
    jbs_w[:n_work] = jbs_t[pair_idx]
    gsel_w[:n_work] = group_idx
    slots_w[:n_work] = slot_of_item
    first_w[:n_work] = first
    if n_fill:
        slots_w[n_work : n_work + n_fill] = np.arange(p, n_slots, dtype=np.int32)
        first_w[n_work : n_work + n_fill] = 1

    return ClusteredPlan(
        ti=ti, wk=wk, n_pad=n_pad, w_pad=(ng + 1) * wk, nb=nb, ng=ng,
        slot_ibs=slot_ibs, slot_jbs=slot_jbs,
        ibs_w=ibs_w, jbs_w=jbs_w, gsel_w=gsel_w, slots_w=slots_w,
        first_w=first_w, n_slots=n_slots, n_work=n_work,
        work_fraction=work_fraction,
    )


@dataclasses.dataclass(frozen=True)
class StripeWorklist:
    """Work list for ONE superblock stripe of the streaming walk
    (``stream.py``): the summary-AND skip at streaming scale, where the
    N×N result cannot be one matrix and :class:`ClusteredPlan` does not
    apply. A copy of the JAX package's, bucket padding included (slot and
    item counts padded to 1/8-octave buckets: padding slots are
    zero-written by one filler item each, tail items are exact no-ops into
    the last slot); :func:`device_worklist` hands the card the real items
    ``[:n_work]`` and ``n_vis`` slots only."""

    ibs: np.ndarray        # int32 [T_pad] GLOBAL row-block ids
    jbs: np.ndarray        # int32 [T_pad]
    gsel: np.ndarray       # int32 [T_pad] K-group (ng = zero pad group)
    slots: np.ndarray      # int32 [T_pad] ascending
    first: np.ndarray      # int32 [T_pad]
    vis_loc_i: np.ndarray  # int32 [n_vis] visited LOCAL tile coords
    vis_loc_j: np.ndarray  # int32 [n_vis]
    n_slots: int           # bucket-padded output slots
    n_vis: int             # real visited pairs (prefix of the slots)
    n_work: int            # real items


def build_stripe_worklist(
    occ: np.ndarray, base_i: int, base_j: int, tps: int, triangular: bool
) -> Optional[StripeWorklist]:
    """Summary-AND work list for the superblock stripe whose row blocks
    are ``[base_i, base_i+tps)`` × ``[base_j, base_j+tps)`` of the global
    per-tile-block occupancy ``occ`` (bool [nb, ng]). ``triangular``
    restricts to local upper-triangular pairs (diagonal stripes — the
    caller mirrors at assembly). None when no (pair, group) co-occupies:
    the stripe is exactly zero and need not touch the device."""
    ng = occ.shape[1]
    if triangular:
        loc_i, loc_j = np.triu_indices(tps)
        loc_i = loc_i.astype(np.int32)
        loc_j = loc_j.astype(np.int32)
    else:
        loc_i, loc_j = np.meshgrid(
            np.arange(tps, dtype=np.int32),
            np.arange(tps, dtype=np.int32),
            indexing="ij",
        )
        loc_i, loc_j = loc_i.ravel(), loc_j.ravel()
    gi = base_i + loc_i
    gj = base_j + loc_j
    co = occ[gi] & occ[gj]                     # [P, ng] summary AND
    pair_idx, group_idx = np.nonzero(co)       # sorted pair-major
    n_work = pair_idx.size
    if n_work == 0:
        return None
    visited, slot_of_item = np.unique(pair_idx, return_inverse=True)
    n_vis = visited.size
    first = np.empty(n_work, dtype=np.int32)
    first[0] = 1
    first[1:] = (slot_of_item[1:] != slot_of_item[:-1]).astype(np.int32)

    n_slots = quantize_bucket(n_vis)
    n_fill = n_slots - n_vis
    t_pad = quantize_bucket(n_work + n_fill)
    ibs = np.full(t_pad, gi[visited[-1]], dtype=np.int32)
    jbs = np.full(t_pad, gj[visited[-1]], dtype=np.int32)
    gsel = np.full(t_pad, ng, dtype=np.int32)
    slots = np.full(t_pad, n_slots - 1, dtype=np.int32)
    first_w = np.zeros(t_pad, dtype=np.int32)
    ibs[:n_work] = gi[pair_idx]
    jbs[:n_work] = gj[pair_idx]
    gsel[:n_work] = group_idx
    slots[:n_work] = slot_of_item
    first_w[:n_work] = first
    if n_fill:
        slots[n_work : n_work + n_fill] = np.arange(n_vis, n_slots, dtype=np.int32)
        first_w[n_work : n_work + n_fill] = 1
    return StripeWorklist(
        ibs=ibs, jbs=jbs, gsel=gsel, slots=slots, first=first_w,
        vis_loc_i=loc_i[visited], vis_loc_j=loc_j[visited],
        n_slots=n_slots, n_vis=n_vis, n_work=n_work,
    )


@dataclasses.dataclass(frozen=True)
class ShardedClusteredPlan:
    """Per-rank work lists for the bits-axis (K-shard) K5 form, the arrays
    of the JAX package's planner.

    Every rank covers the SAME output slot set (the union of tile pairs
    co-occupied in ANY word slice) so that the int32 tile partials can be
    summed over the ranks; a rank whose slice never touches a slot gets one
    filler item on its local all-zero K-group with ``first=1`` (an exact
    zero tile). The padded operand has one zero K-group at the END of every
    rank's word slice, for the fillers and the tail padding."""

    ti: int
    wk: int
    n_pad: int
    w_pad: int              # R · (gpd + 1) · wk, a zero group per slice
    nb: int
    gpd: int                # real K-groups per rank
    r: int                  # ranks
    slot_ibs: np.ndarray    # int32 [P] (real visited pairs)
    slot_jbs: np.ndarray    # int32 [P]
    n_slots: int            # bucket-padded kernel output slots (≥ P)
    ibs_w: np.ndarray       # int32 [R, T_pad]
    jbs_w: np.ndarray       # int32 [R, T_pad]
    gsel_w: np.ndarray      # int32 [R, T_pad] LOCAL group ids
    slots_w: np.ndarray     # int32 [R, T_pad]
    first_w: np.ndarray     # int32 [R, T_pad]
    work_fraction: float


def build_sharded_clustered_plan(
    bm, r: int, config: Optional[EngineConfig] = None
) -> Optional[ShardedClusteredPlan]:
    """Bits-axis K5 planning over ``r`` word shards (wk = 128 words per
    K-group), a copy of the JAX package's planner. None when the geometry
    degenerates (fewer than one real group per rank, or nothing
    co-occupies)."""
    cfg = config or default_config()
    n, w = bm.n, bm.n_words
    if n == 0 or w == 0:
        return None
    wk = 128
    ti = min(cfg.k2_tile_rows, round_up(max(n, 32), 32))
    gpd = -(-w // (r * wk))         # real groups per rank (ceil)
    if gpd < 1:
        return None
    ng = gpd * r
    n_pad = round_up(n, ti)
    nb = n_pad // ti
    # global group occupancy at wk granularity, OR-reduced per tile block
    occ_rows = bm.block_summary(block_bits=wk * WORD_BITS).astype(bool)
    occ = np.zeros((nb * ti, ng), dtype=bool)
    occ[:n, : occ_rows.shape[1]] = occ_rows
    occ = occ.reshape(nb, ti, ng).any(axis=1)   # [nb, ng]

    ibs_t, jbs_t = np.triu_indices(nb)
    co = occ[ibs_t] & occ[jbs_t]                # [T_tri, ng]
    pair_idx, group_idx = np.nonzero(co)
    if pair_idx.size == 0:
        return None
    work_fraction = pair_idx.size / float(ibs_t.size * ng)
    visited, slot_global = np.unique(pair_idx, return_inverse=True)
    p = visited.size
    # bucket the shared slot count: pad slots are zero-written on EVERY
    # rank (they land in each rank's filler set below), so the summed
    # partials stay exact
    n_slots = quantize_bucket(p)
    slot_ibs = ibs_t[visited].astype(np.int32)
    slot_jbs = jbs_t[visited].astype(np.int32)
    lut_ibs = np.concatenate([slot_ibs, np.zeros(n_slots - p, dtype=np.int32)])
    lut_jbs = np.concatenate([slot_jbs, np.zeros(n_slots - p, dtype=np.int32)])

    dev_of_item = group_idx // gpd
    lists = []
    for d in range(r):
        sel = dev_of_item == d
        sl = slot_global[sel]
        gl = (group_idx[sel] - d * gpd).astype(np.int64)
        # fillers: slots this slice never touches (the bucket pad slots
        # included) → local zero group (index gpd), first=1 zero-writes
        missing = np.setdiff1d(np.arange(n_slots), sl, assume_unique=False)
        sl = np.concatenate([sl, missing])
        gl = np.concatenate([gl, np.full(missing.size, gpd, dtype=np.int64)])
        order = np.argsort(sl, kind="stable")
        sl, gl = sl[order], gl[order]
        first = np.empty(sl.size, dtype=np.int32)
        first[0] = 1
        first[1:] = (sl[1:] != sl[:-1]).astype(np.int32)
        lists.append((sl, gl, first))

    t_pad = quantize_bucket(max(sl.size for sl, _, _ in lists))
    ibs_w = np.empty((r, t_pad), dtype=np.int32)
    jbs_w = np.empty((r, t_pad), dtype=np.int32)
    gsel_w = np.empty((r, t_pad), dtype=np.int32)
    slots_w = np.empty((r, t_pad), dtype=np.int32)
    first_w = np.zeros((r, t_pad), dtype=np.int32)
    for d, (sl, gl, first) in enumerate(lists):
        k = sl.size
        ibs_w[d, :k] = lut_ibs[sl]
        jbs_w[d, :k] = lut_jbs[sl]
        gsel_w[d, :k] = gl
        slots_w[d, :k] = sl
        first_w[d, :k] = first
        # tail padding: no-op items into the last slot via the zero group
        ibs_w[d, k:] = lut_ibs[sl[-1]]
        jbs_w[d, k:] = lut_jbs[sl[-1]]
        gsel_w[d, k:] = gpd
        slots_w[d, k:] = sl[-1]

    return ShardedClusteredPlan(
        ti=ti, wk=wk, n_pad=n_pad, w_pad=r * (gpd + 1) * wk, nb=nb,
        gpd=gpd, r=r, slot_ibs=slot_ibs, slot_jbs=slot_jbs,
        n_slots=n_slots,
        ibs_w=ibs_w, jbs_w=jbs_w, gsel_w=gsel_w, slots_w=slots_w,
        first_w=first_w, work_fraction=work_fraction,
    )


def pack_sharded_clustered_operand(bm, plan: ShardedClusteredPlan) -> np.ndarray:
    """Host-padded operand uint32 [n_pad, w_pad] laid out so that cutting
    it into ``r`` equal word slices gives every rank [real groups | one
    zero group]."""
    per_dev = (plan.gpd + 1) * plan.wk
    xp = np.zeros((plan.n_pad, plan.r * per_dev), dtype=np.uint32)
    w = bm.n_words
    for d in range(plan.r):
        src0 = d * plan.gpd * plan.wk
        src1 = min(src0 + plan.gpd * plan.wk, w)
        if src1 > src0:
            xp[: bm.n, d * per_dev : d * per_dev + (src1 - src0)] = bm.packed[:, src0:src1]
    return xp


# ----------------------------------------------------------------- plain form
def count_tiles_worklist_plain(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    gsel: torch.Tensor,
    slots: torch.Tensor,
    first: torch.Tensor,
    *,
    n_slots: int,
    tile_rows: int,
    tile_words: int,
) -> torch.Tensor:
    """Plain version of :func:`count_tiles_worklist`, the JAX semantics
    item by item: zero the slot on ``first``, then add the int8 product of
    the item's two row blocks over its K-group. Slots no item visits are
    zero."""
    ti, wk = tile_rows, tile_words
    out = torch.zeros((n_slots, ti, ti), dtype=torch.int32, device=packed.device)
    items = zip(*(x.cpu().tolist() for x in (ibs, jbs, gsel, slots, first)))
    for ib, jb, g, s, f in items:
        if f:
            out[s] = 0
        cols = slice(g * wk, (g + 1) * wk)
        ua = unpack_to_int8(packed[ib * ti : (ib + 1) * ti, cols].contiguous())
        ub = unpack_to_int8(packed[jb * ti : (jb + 1) * ti, cols].contiguous())
        out[s] += int8_dot_nt(ua, ub)
    return out


# ------------------------------------------------------------- kernel wrapper
def check_worklist(
    ibs: np.ndarray, jbs: np.ndarray, gsel: np.ndarray, slots: np.ndarray,
    first: np.ndarray, *, n_slots: int, nb: int, ng: int,
) -> np.ndarray:
    """Check a work list (numpy arrays on the host) and return each slot's
    first item, int32 [n_slots + 1] (slot s owns items [start[s],
    start[s+1])). Raises on ids out of range, slots not ascending, or
    ``first`` flags that do not mark exactly each slot's first item."""
    if not ibs.shape == jbs.shape == gsel.shape == slots.shape == first.shape or ibs.ndim != 1:
        raise ValueError("work-list arrays must be 1-D of equal length")
    if ibs.size:
        for name, ids, hi in (("ibs", ibs, nb), ("jbs", jbs, nb), ("gsel", gsel, ng),
                              ("slots", slots, n_slots)):
            if ids.min() < 0 or ids.max() >= hi:
                raise ValueError(f"{name} must lie in [0, {hi})")
        if np.any(slots[1:] < slots[:-1]):
            raise ValueError("work-list slots must be ascending")
        want = np.ones(slots.size, dtype=bool)
        want[1:] = slots[1:] != slots[:-1]
        if not np.array_equal(first, want.astype(first.dtype)):
            raise ValueError("first must flag exactly each slot's first item")
    return np.searchsorted(slots, np.arange(n_slots + 1)).astype(np.int32)


def _slot_starts(
    ibs, jbs, gsel, slots, first, *, n_slots: int, nb: int, ng: int
) -> np.ndarray:
    """:func:`check_worklist` of work-list tensors: reads them back to the
    host (five synchronising copies when they lie on the card)."""
    return check_worklist(
        *(x.cpu().numpy() for x in (ibs, jbs, gsel, slots, first)),
        n_slots=n_slots, nb=nb, ng=ng,
    )


def schedule_units(starts: np.ndarray, n_sub: int) -> np.ndarray:
    """The CUDA kernel's schedule, int32 [n_slots · n_sub, 4]: one unit
    (first item, items, slot, sub-tile) per sub-tile of every slot, a slot
    with no items included (it stores zeros), longest first; slots of
    equal length keep their order and a slot's sub-tiles stay together.
    The kernel's blocks, one an SM, take units in this order as they fall
    free, so the longest start first and the short ones fill the end."""
    n_slots = starts.size - 1
    items = np.diff(starts)
    order = np.argsort(-items, kind="stable")
    units = np.empty((n_slots, n_sub, 4), dtype=np.int32)
    units[:, :, 0] = starts[order, None]
    units[:, :, 1] = items[order, None]
    units[:, :, 2] = order[:, None]
    units[:, :, 3] = np.arange(n_sub)
    return units.reshape(-1, 4)


@dataclasses.dataclass(frozen=True)
class DeviceWorklist:
    """A work list on a device that :func:`check_worklist` passed on the
    host, with what the check and the schedule were made for.
    :func:`count_tiles_worklist` takes it as ``checked=`` in place of its
    own read-back and check."""

    tensors: tuple          # (ibs, jbs, gsel, slots, first) on the device
    versions: tuple         # each tensor's in-place version when checked
    n_slots: int
    tile_rows: int          # tile size the schedule's sub-tiles are for
    nb: int                 # row blocks the ids were checked against
    ng: int                 # K-groups the ids were checked against
    starts: np.ndarray      # int32 [n_slots + 1], host
    units: Optional[torch.Tensor]   # schedule_units on the device; None on the CPU

    def __iter__(self):
        return iter(self.tensors)

    def starts_for(
        self, tensors, *, n_slots: int, tile_rows: int, nb: int, ng: int
    ) -> np.ndarray:
        """``starts`` if ``tensors`` are the tensors that were checked,
        unchanged since, against this geometry; raises otherwise."""
        if not (len(tensors) == len(self.tensors)
                and all(a is b for a, b in zip(tensors, self.tensors))):
            raise ValueError("checked= belongs to other work-list tensors")
        if tuple(t._version for t in tensors) != self.versions:
            raise ValueError("a work-list tensor was written to after its check")
        if (n_slots, tile_rows, nb, ng) != (self.n_slots, self.tile_rows, self.nb, self.ng):
            raise ValueError(
                f"checked= was made for n_slots={self.n_slots}, tile_rows={self.tile_rows}, "
                f"{self.nb} row blocks, {self.ng} K-groups; got {n_slots}, {tile_rows}, "
                f"{nb}, {ng}"
            )
        return self.starts


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _k2_sub_tiles(tile_rows: int) -> int:
    """Blocks per tile_rows × tile_rows output tile of the CUDA tile body."""
    from stormtpu_torch.kernels._build import library

    return library("k2_mxu").k2_sub_tiles(tile_rows)


def count_tiles_worklist(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    gsel: torch.Tensor,
    slots: torch.Tensor,
    first: torch.Tensor,
    *,
    n_slots: int,
    tile_rows: int,
    tile_words: int,
    variant: str = "planes",
    checked: Optional[DeviceWorklist] = None,
) -> torch.Tensor:
    """``n_slots`` count tiles int32 [n_slots, TI, TI]: work item t adds
    the (ibs[t], jbs[t]) row-block pair over K-group gsel[t] (words
    ``[gsel·WK, gsel·WK + WK)``) into slot slots[t]. Items must be sorted
    by slot with ``first`` marking each slot's first item; a slot no item
    visits is zero. The list is checked on every call, after a read-back
    to the host, unless ``checked`` (from :func:`device_worklist`) says
    that these very tensors were checked when they were made."""
    _check_variant(variant)
    _check_geometry("count_tiles_worklist", packed, tile_rows, tile_words)
    if n_slots < 0:
        raise ValueError(f"n_slots={n_slots} must be >= 0")
    n_pad, w_pad = packed.shape
    geometry = dict(n_slots=n_slots, nb=n_pad // tile_rows, ng=w_pad // tile_words)
    if checked is None:
        starts = _slot_starts(ibs, jbs, gsel, slots, first, **geometry)
    else:
        starts = checked.starts_for(
            (ibs, jbs, gsel, slots, first), tile_rows=tile_rows, **geometry
        )
    kw = dict(n_slots=n_slots, tile_rows=tile_rows, tile_words=tile_words)
    if packed.device.type == "cpu":
        return count_tiles_worklist_plain(packed, ibs, jbs, gsel, slots, first, **kw)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    _check_cuda_operand("count_tiles_worklist", packed)
    _check_cuda_ids(packed.device, ibs=ibs, jbs=jbs, gsel=gsel)
    out = torch.empty((n_slots, tile_rows, tile_rows), dtype=torch.int32,
                      device=packed.device)
    if n_slots == 0:
        return out
    if checked is not None and checked.units is not None:
        units = checked.units
    else:
        units = torch.from_numpy(
            schedule_units(starts, _k2_sub_tiles(tile_rows))).to(packed.device)
    n_units = units.shape[0]
    # the blocks' shared position in the schedule; one block an SM
    counter = torch.zeros(1, dtype=torch.int32, device=packed.device)
    _launch("k2_mxu", "k5_launch", packed.device, packed.data_ptr(), ibs.data_ptr(),
            jbs.data_ptr(), gsel.data_ptr(), units.data_ptr(), counter.data_ptr(),
            out.data_ptr(), n_units, min(_sm_count(packed.device), n_units),
            tile_rows, tile_words, w_pad)
    LAUNCHES["k5"] += 1
    return out


# ------------------------------------------------------------------ the path
def padded_operand(bm, n_pad: int, w_pad: int, device) -> torch.Tensor:
    """``bm.packed`` zero-padded to [n_pad, w_pad] as int32 words on
    ``device``, padded there and cached on the matrix
    (``BitMatrix.device_padded2d``): repeated calls do not upload it again."""
    return bm.device_padded2d(n_pad, w_pad, device=device)


def device_operand(bm, plan: ClusteredPlan, device) -> torch.Tensor:
    """:func:`padded_operand` at the plan's [n_pad, w_pad] (the last
    K-group all zero)."""
    return padded_operand(bm, plan.n_pad, plan.w_pad, device)


def device_worklist(
    plan, device, *, nb: Optional[int] = None, ng: Optional[int] = None,
    tile_rows: Optional[int] = None, ibs_shift: int = 0, jbs_shift: int = 0,
    shard: Optional[int] = None,
) -> DeviceWorklist:
    """The real work items (ibs, jbs, gsel, slots, first) of a
    :class:`ClusteredPlan` or a :class:`StripeWorklist` on ``device``, for
    its visited slots only: checked here, on the host arrays, and on the
    card scheduled for the kernel, so that :func:`count_tiles_worklist`
    reads nothing back. The five arrays go up in one copy.

    Of a :class:`ShardedClusteredPlan`, the list of rank ``shard`` over all
    ``n_slots`` slots (every rank writes every slot, so that the partials
    sum), its fillers included, without the tail's no-op items (zero group,
    ``first=0``), for an operand of that rank's word slice.

    A stripe's work list carries no geometry: ``nb``, ``ng`` (row blocks
    and K-groups of the operand it will run on, the zero pad group
    included) and ``tile_rows`` say it, and ``ibs_shift`` / ``jbs_shift``
    are subtracted from its global row-block ids where that operand is a
    slice of the matrix (operand streaming: the two-slice buffer).

    The bucket padding (one filler item per pad slot, then no-op tail
    items into the last slot) bounds the JAX package's compile shapes. The
    CUDA kernel compiles once and zeroes a slot no item visits, so the
    padding is pure cost here, and a serial one: every tail item lands in
    the last slot, whose blocks walk them one by one."""
    if isinstance(plan, ShardedClusteredPlan):
        if shard is None:
            raise ValueError("a sharded plan's work list needs shard=")
        arrays = (plan.ibs_w[shard], plan.jbs_w[shard], plan.gsel_w[shard],
                  plan.slots_w[shard], plan.first_w[shard])
        keep = (arrays[2] != plan.gpd) | (arrays[4] != 0)
        arrays = tuple(a[keep] for a in arrays)
        k = arrays[0].size
        n_slots, tile_rows, nb, ng = plan.n_slots, plan.ti, plan.nb, plan.gpd + 1
    elif isinstance(plan, ClusteredPlan):
        k = plan.n_work
        arrays = (plan.ibs_w, plan.jbs_w, plan.gsel_w, plan.slots_w, plan.first_w)
        n_slots, tile_rows, nb = plan.slot_ibs.size, plan.ti, plan.nb
        # ids up to the operand's pad group (device_operand) are in range
        ng = plan.w_pad // plan.wk
    else:
        if nb is None or ng is None or tile_rows is None:
            raise ValueError("a stripe work list needs nb, ng and tile_rows")
        arrays = (plan.ibs, plan.jbs, plan.gsel, plan.slots, plan.first)
        k = plan.n_work
        n_slots = plan.n_vis
    host = np.stack([a[:k] for a in arrays])
    host[0] -= ibs_shift
    host[1] -= jbs_shift
    geometry = dict(n_slots=n_slots, nb=nb, ng=ng)
    starts = check_worklist(*host, **geometry)
    dev = torch.device(device)
    tensors = tuple(torch.from_numpy(host).to(dev))
    units = None
    if dev.type == "cuda":
        units = torch.from_numpy(schedule_units(starts, _k2_sub_tiles(tile_rows))).to(dev)
    return DeviceWorklist(
        tensors=tensors, versions=tuple(t._version for t in tensors),
        tile_rows=tile_rows, starts=starts, units=units, **geometry,
    )


def count_matrix_clustered(
    bm,
    *,
    config: Optional[EngineConfig] = None,
    variant: Optional[str] = None,
    plan: Optional[ClusteredPlan] = None,
    device=None,
) -> np.ndarray:
    """Full N×N exact counts (numpy int32) via the K5 work list and the
    symmetric mirror on the tiles' device (one download of the finished
    matrix), on ``device`` (``None``: the card). Tile pairs with no
    co-occupied K-group are never computed — their counts are exactly zero. A degenerate plan (single K-group) takes the K2
    walk; an empty matrix gives zeros."""
    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    variant = variant or cfg.k2_variant
    if plan is None:
        plan = build_clustered_plan(bm, cfg)
    if plan is None:
        if bm.n == 0 or bm.nnz == 0:
            return np.zeros((bm.n, bm.n), dtype=np.int32)
        return count_matrix_pallas_mxu(
            bm.device_padded(bm.n, device=dev), config=cfg, variant=variant
        )

    work = device_worklist(plan, dev)
    tiles = count_tiles_worklist(
        device_operand(bm, plan, dev), *work,
        n_slots=plan.slot_ibs.size, tile_rows=plan.ti,
        tile_words=plan.wk, variant=variant, checked=work,
    )
    return download(
        assemble_triangular_torch(tiles, plan.slot_ibs, plan.slot_jbs, plan.nb, bm.n)
    )
