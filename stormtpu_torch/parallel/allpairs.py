"""Ring-streaming row-sharded all-pairs (port of
``stormtpu/parallel/allpairs.py``).

- X (packed words [N, W]) is **row-sharded**: rank d of the ring holds
  X_d = X[d·n_loc : (d+1)·n_loc] on its device.
- The partner shard **streams around the ring**: at step s, rank d
  computes the count block X_d × X_{(d+s) mod R} while :func:`ppermute`
  hands the streaming buffer one hop on for step s+1.
- Triangular ring: each UNORDERED shard pair is computed once, and the
  transposed block is shipped back over the ring for the mirror entry.
  The result stays row-sharded ([n_loc, N] a rank) until
  :func:`~stormtpu_torch.parallel.mesh.fetch_global` gathers it.

The block kernel is pluggable (``block_fn``); by default
``kernels.count_block_auto`` (K2-rect on the card). The bits axis shards
the words instead: every rank counts its word slice (K2-tri tiles, or K5's
work list on block-clustered inputs) and :func:`psum` merges the exact int32
partials.

The ring's block kernels are the spans ``stpu.parallel.kernel`` and its
sums and hops ``stpu.parallel.collective`` (``utils.profiling``); under
``utils.profiling.record_stages()`` they are the stages ``kernel`` and
``collective``.

The JAX package's ``sharded fn``s map global arrays to global arrays. Here
each is a function of this rank's shard that returns this rank's part of
the result, and must be called on every rank of the mesh. The JAX
package's compile caches have no counterpart: there is nothing to compile.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.parallel.mesh import (
    Mesh,
    fetch_global,
    local_shard,
    make_row_mesh,
    ppermute,
    psum,
)
from stormtpu_torch.utils import download, profiling, round_up

__all__ = ["distributed_count_matrix", "ring_count_rows", "ring_count_rows_2d"]

_stage = functools.partial(profiling.stage, "parallel")

BlockFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _ring_local_fn(mesh: Mesh, axis: str, r: int, n_loc: int, block_fn: BlockFn,
                   psum_axis: Optional[str] = None):
    """Triangular ring: rank d computes (d, d+s) for s = 0..S and ships
    the transposed count block back over the ring for the mirror entry.

    Step census: s = 0 is the diagonal; 1 ≤ s ≤ S pairs d with d+s. For
    odd R, S = (R−1)/2 covers every unordered pair once (mirror shipped).
    For even R, S = R/2 and at s = S the pairing d ↔ d+R/2 is mutual: both
    ranks compute their own block and no mirror is shipped.

    ``psum_axis``: the 2-D form — each rank holds a WORD slice of its row
    shard, ``block_fn`` yields an exact int32 partial, and the sum over the
    bits axis completes each block before the ring bookkeeping."""

    def local_fn(x_local: torch.Tensor) -> torch.Tensor:
        dev = x_local.device
        my = mesh.axis_index(axis)
        out = torch.zeros((x_local.shape[0], r * n_loc), dtype=torch.int32, device=dev)
        buf = x_local
        s_max = r // 2 if r % 2 == 0 else (r - 1) // 2
        for s in range(s_max + 1):
            partner = (my + s) % r
            with _stage("kernel", dev):
                counts = block_fn(x_local, buf).to(torch.int32)
            with _stage("collective", dev):
                if psum_axis is not None:
                    counts = psum(counts, mesh, psum_axis)
                out[:, partner * n_loc : (partner + 1) * n_loc] = counts
                if 0 < s and not (r % 2 == 0 and s == s_max):
                    # countsᵀ (rows of the partner × columns of mine) goes
                    # s hops on, to the rank that owns those rows
                    src = (my - s) % r
                    out[:, src * n_loc : (src + 1) * n_loc] = ppermute(counts.T, mesh, axis, s)
                if s < s_max:
                    # rank i sends its buffer to i-1: after the hop rank d
                    # holds shard (d + s + 1) mod R
                    buf = ppermute(buf, mesh, axis, -1)
        return out

    return local_fn


def ring_count_rows(mesh: Mesh, axis: str, n_loc: int, block_fn: BlockFn):
    """This rank's row shard int32 [n_loc, W] → its rows of the counts
    int32 [n_loc, R·n_loc]."""
    return _ring_local_fn(mesh, axis, mesh.shape[axis], n_loc, block_fn)


def ring_count_rows_2d(mesh: Mesh, row_axis: str, bit_axis: str, n_loc: int,
                       block_fn: BlockFn):
    """On a 2-D [rows × bits] mesh: this rank's word slice of its row
    shard → its rows of the counts int32 [n_loc, R·n_loc] (the ring streams
    row shards; a sum over the bits axis completes every block)."""
    return _ring_local_fn(mesh, row_axis, mesh.shape[row_axis], n_loc, block_fn,
                          psum_axis=bit_axis)


def kshard_count_rows(mesh: Mesh, axis: str, block_fn: BlockFn):
    """Bit-axis (K) sharding, square form: this rank's word slice of every
    row → the full counts, the exact partials summed over ``axis``."""

    def local_fn(x_local: torch.Tensor) -> torch.Tensor:
        return psum(block_fn(x_local, x_local).to(torch.int32), mesh, axis)

    return local_fn


def kshard_count_tiles(mesh: Mesh, axis: str, *, tile_rows: int, tile_words: int,
                       variant: str = "planes"):
    """Triangular form of the K-shard variant: K2-tri on this rank's word
    slice, for a tile list checked on the host (``mxu.device_tile_ids``),
    the int32 tile partials summed over ``axis``; the caller mirrors at
    assembly. Half the work of :func:`kshard_count_rows`."""
    from stormtpu_torch.kernels.mxu import count_tiles_pallas_mxu

    def local_fn(x_local: torch.Tensor, ids) -> torch.Tensor:
        tiles = count_tiles_pallas_mxu(x_local, *ids, tile_rows=tile_rows,
                                       tile_words=tile_words, variant=variant, checked=ids)
        return psum(tiles, mesh, axis)

    return local_fn


def kshard_count_tiles_clustered(mesh: Mesh, axis: str, *, tile_rows: int, tile_words: int,
                                 n_slots: int, variant: str = "planes"):
    """Bits-axis K5: every rank runs the work list of its OWN word slice
    (``clustered.device_worklist(plan, dev, shard=rank)``) and the exact
    int32 tile partials are summed over ``axis``. A rank whose slice never
    touches a slot writes an exact zero tile there."""
    from stormtpu_torch.kernels.clustered import count_tiles_worklist

    def local_fn(x_local: torch.Tensor, work) -> torch.Tensor:
        tiles = count_tiles_worklist(x_local, *work, n_slots=n_slots, tile_rows=tile_rows,
                                     tile_words=tile_words, variant=variant, checked=work)
        return psum(tiles, mesh, axis)

    return local_fn


def distributed_count_matrix(
    packed: np.ndarray,
    *,
    mesh: Optional[Mesh] = None,
    config: Optional[EngineConfig] = None,
    block_fn: Optional[BlockFn] = None,
    shard_axis: str = "rows",
    device=None,
) -> np.ndarray:
    """Exact N×N counts computed data-parallel over the ranks of ``mesh``
    (default: :func:`make_row_mesh` on ``device``, ``None`` meaning this
    rank's card). Every rank of the mesh calls it with the same ``packed``
    and gets the whole matrix.

    ``shard_axis="rows"``: row-sharded X, the triangular ring (scales N).
    ``shard_axis="bits"``: word-sharded X, the sum of exact int32 partials
    (scales M): K2-tri tiles per word slice, or K5's work lists where the
    input is block-clustered, or the square block form below 128 words a
    rank. A 2-D mesh composes both, whatever ``shard_axis`` says."""
    cfg = config or default_config()
    if mesh is None:
        mesh = make_row_mesh(device=device)
    dev = mesh.device
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    packed = np.asarray(packed, dtype=np.uint32)
    n, w = packed.shape
    cfg.validate(w * 32)
    caller_block_fn = block_fn is not None
    if block_fn is None:
        from stormtpu_torch.kernels import count_block_auto

        block_fn = lambda a, b: count_block_auto(a, b, config=cfg)  # noqa: E731

    if len(mesh.axis_names) == 2:
        # composed 2-D form (rows × bits): ring over row shards, sum over
        # word slices; shard_axis is ignored, the mesh says both
        row_axis, bit_axis = mesh.axis_names
        rr, rb = mesh.shape[row_axis], mesh.shape[bit_axis]
        n_pad = round_up(max(n, rr), rr * 8)
        n_loc, w_loc = n_pad // rr, round_up(max(w, rb), rb) // rb
        i, b = mesh.axis_index(row_axis), mesh.axis_index(bit_axis)
        x_local = local_shard(packed, (i * n_loc, (i + 1) * n_loc), (b * w_loc, (b + 1) * w_loc), dev)
        fn = ring_count_rows_2d(mesh, row_axis, bit_axis, n_loc, block_fn)
        return fetch_global(fn(x_local), mesh, row_axis)[:n, :n]
    if shard_axis == "bits":
        d = mesh.axis_index(axis)
        wk = 128
        if caller_block_fn or w < r * wk:
            # a caller's rectangle kernel, or under one 128-word K step a
            # rank: the square form (the tile walk's padding would exceed
            # its triangular saving)
            w_loc = round_up(max(w, r), r) // r
            x_local = local_shard(packed, (0, n), (d * w_loc, (d + 1) * w_loc), dev)
            return download(kshard_count_rows(mesh, axis, block_fn)(x_local))[:n, :n]
        # block-clustered inputs take the K-shard K5 work-list form, decided
        # by the co-occupancy statistic of the single-card dispatch
        from stormtpu_torch.kernels.clustered import (
            build_sharded_clustered_plan,
            device_worklist,
        )
        from stormtpu_torch.kernels.mxu import device_tile_ids
        from stormtpu_torch.layout import BitMatrix
        from stormtpu_torch.utils import assemble_triangular_torch, triangular_tile_ids

        bm = BitMatrix.from_packed(packed, m_bits=w * 32)
        splan = build_sharded_clustered_plan(bm, r, cfg)
        if (splan is not None
                and splan.work_fraction < cfg.clustered_work_fraction_threshold):
            # this rank's block of pack_sharded_clustered_operand: its
            # real groups, then one zero group
            real = splan.gpd * splan.wk
            x_local = local_shard(packed, (0, splan.n_pad), (d * real, (d + 1) * real), dev,
                             width=real + splan.wk)
            work = device_worklist(splan, dev, shard=d)
            tiles = kshard_count_tiles_clustered(
                mesh, axis, tile_rows=splan.ti, tile_words=splan.wk,
                n_slots=splan.n_slots, variant=cfg.k2_variant,
            )(x_local, work)
            # pad slots (zero on every rank) are cut before assembly
            return download(assemble_triangular_torch(
                tiles[: splan.slot_ibs.size], splan.slot_ibs, splan.slot_jbs, splan.nb, n))
        # triangular K2 tiles per word slice, summed, mirrored at assembly
        ti = min(cfg.k2_tile_rows, round_up(max(n, 32), 32))
        w_loc = round_up(w, r * wk) // r
        n_pad = round_up(n, ti)
        nb = n_pad // ti
        ibs, jbs = triangular_tile_ids(nb)
        x_local = local_shard(packed, (0, n_pad), (d * w_loc, (d + 1) * w_loc), dev)
        tiles = kshard_count_tiles(mesh, axis, tile_rows=ti, tile_words=wk,
                                   variant=cfg.k2_variant)(
            x_local, device_tile_ids(ibs, jbs, nb, dev))
        return download(assemble_triangular_torch(tiles, ibs, jbs, nb, n))
    if shard_axis != "rows":
        raise ValueError(f"shard_axis must be 'rows' or 'bits', got {shard_axis!r}")

    n_loc = round_up(max(n, r), r * 8) // r
    i = mesh.axis_index(axis)
    x_local = local_shard(packed, (i * n_loc, (i + 1) * n_loc), (0, w), dev)
    return fetch_global(ring_count_rows(mesh, axis, n_loc, block_fn)(x_local), mesh)[:n, :n]
