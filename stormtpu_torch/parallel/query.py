"""Distributed queries over a row-sharded mesh: top-k partners and
threshold screens (port of ``stormtpu/parallel/query.py``).

At the 1M × 1M scale the count matrix cannot exist, so the queries are the
forms users run there. Layout follows the ring of ``allpairs``: X
row-sharded over the mesh, the partner shard streamed around the ring
while each rank updates per-row state for its own rows only; what leaves a
rank is O(N·k) (top-k) or one bit a pair (screens).

- The **screen** rides the TRIANGULAR ring: each unordered shard pair's
  count block is computed once and the transposed hit tile — 32× smaller
  than a count tile — goes back to the partner.
- **Top-k** runs the full square ring: a row's best k says nothing about
  its column's, so there is no mirror to ship.

The top-k's rows ring also takes a :class:`RowShard`: this rank's rows,
already on its device, which the caller fills itself (the rows
:func:`shard_rows` names), so that no process ever holds the whole panel.
Its partner shard moves on in place (``mesh.ring_shift_``), so a rank
holds two shards and a staging buffer, never three.

Both offer the bits axis (``shard_axis="bits"``) on a 1-D mesh: each rank
holds a word slice of every row, the K2-tri tiles of each chunk are summed
over the ranks to the exact tiles, then screened (:func:`_kshard_hits`) or
merged into the running top-k (``query._topk_tile_walk`` with its ``psum``
hook). A 2-D [rows × bits] mesh sums each count block over the bits axis
before the ring bookkeeping.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch

from stormtpu_torch.api import MatrixLike, _as_bitmatrix
from stormtpu_torch.config import default_config
from stormtpu_torch.kernels import count_block_auto
from stormtpu_torch.parallel.mesh import (
    Mesh,
    bit_axis_of,
    fetch_global,
    local_shard,
    make_row_mesh,
    ppermute,
    psum,
    ring_shift_,
    shift_stage,
)
from stormtpu_torch.query import (
    _TILE_GROUP,
    _blocked_tile_ids,
    _chunk_tiles,
    _default_block_rows,
    _expand_and_refine,
    _pack_bit_rows,
    _pairs_of_hits,
    _screen_tiles,
    _screen_vals,
    _tile_chunk,
    _validate_screen,
    _word_summary,
)
from stormtpu_torch.utils import download, next_pow2, profiling, round_up

__all__ = ["RowShard", "distributed_topk_neighbors", "distributed_pairs_above", "shard_rows"]

_stage = functools.partial(profiling.stage, "parallel")


@dataclasses.dataclass(frozen=True)
class RowShard:
    """One rank's rows of a row-sharded panel, already on its device: the
    input form of :func:`distributed_topk_neighbors` for a panel no process
    holds whole.

    ``words``: int32 [rows, ⌈m_bits/32⌉] on the rank's device (the bit
    view of the packed uint32 words), global rows ``row0`` … ``row0 +
    rows``; ``n`` and ``m_bits``: the whole panel's rows and bits. Every
    rank of the mesh passes its own: exactly the rows :func:`shard_rows`
    names (those past ``n`` are padding, of any content)."""

    words: torch.Tensor
    row0: int
    n: int
    m_bits: int


def _ring_geometry(n: int, m_bits: int, r: int, device, block_rows: Optional[int]):
    """(block_rows, n_loc) of the rows ring: N padded to R·block_rows rows,
    a rank's shard n_loc of them."""
    if block_rows is None:
        block_rows = _default_block_rows(m_bits, -(-n // r), device)
    n_pad = round_up(max(n, r), r * block_rows)
    return block_rows, n_pad // r


def shard_rows(n: int, m_bits: int, mesh: Optional[Mesh] = None, *,
               block_rows: Optional[int] = None, device=None) -> tuple[int, int]:
    """The global rows [row0, row1) this rank holds in the rows ring of
    :func:`distributed_topk_neighbors` over an N × ``m_bits`` panel on
    ``mesh`` (default: :func:`make_row_mesh` on ``device``) with
    ``block_rows`` (default: the entry point's own). Rows from ``n`` on
    are padding: the last ranks' ranges run past ``n``, or lie wholly
    past it. Fill a :class:`RowShard` with exactly these rows."""
    if mesh is None:
        mesh = make_row_mesh(device=device)
    if len(mesh.axis_names) != 1:
        raise ValueError("a RowShard lies on a 1-D row mesh")
    axis = mesh.axis_names[0]
    _, n_loc = _ring_geometry(n, m_bits, mesh.shape[axis], mesh.device, block_rows)
    row0 = mesh.axis_index(axis) * n_loc
    return row0, row0 + n_loc


def _sharded_operands(bm, mesh: Mesh, n_pad: int):
    """This rank's row shard of ``bm`` padded to ``n_pad`` rows (its word
    slice of it on a 2-D mesh), the shard's row nnz and every row's nnz,
    on the mesh's device."""
    axis = mesh.axis_names[0]
    bit_axis = bit_axis_of(mesh)
    n_loc = n_pad // mesh.shape[axis]
    i = mesh.axis_index(axis)
    w_loc, b = bm.n_words, 0
    if bit_axis is not None:
        rb = mesh.shape[bit_axis]
        w_loc = round_up(max(bm.n_words, rb), rb) // rb
        b = mesh.axis_index(bit_axis)
    x_local = local_shard(bm.packed, (i * n_loc, (i + 1) * n_loc),
                          (b * w_loc, (b + 1) * w_loc), mesh.device)
    nnz_all = bm.device_nnz(n_pad, device=mesh.device)
    return x_local, nnz_all[i * n_loc : (i + 1) * n_loc], nnz_all


def _kshard_operands(bm, mesh: Mesh, ti: int, wk: int):
    """This rank's word slice of every row for the bits-axis queries
    (rows padded to ``ti``, words to R·``wk``), and n_pad."""
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    n_pad = round_up(max(bm.n, 1), ti)
    w_loc = round_up(bm.n_words, r * wk) // r
    d = mesh.axis_index(axis)
    return local_shard(bm.packed, (0, n_pad), (d * w_loc, (d + 1) * w_loc), mesh.device), n_pad


def _ring_topk_local(mesh: Mesh, axis: str, r: int, n_loc: int, k: int, block_rows: int,
                     n_real: int, psum_axis: Optional[str] = None):
    """This rank's ring loop with a running top-k for its rows. Self pairs
    and padding columns (global column ≥ ``n_real``) count −1: a padded
    row counts 0 and would tie with a real partner of count 0.

    A global top-k partner of row i is, within its own shard, among that
    shard's top-min(k, n_loc) columns for row i, so keeping min(k, n_loc)
    candidates a step and the top-k of (running ∪ new) loses nothing. Tie
    order may differ from the single-device form; values do not.
    ``psum_axis``: 2-D mesh — each count block is summed over the bits
    axis, exactly, before the merge touches it.

    The partner shard takes one hop a step: the first into a second
    buffer, the later ones in place through one staging buffer, so a rank
    holds two shards at most. Spans: ``stpu.parallel.step`` (s),
    ``.kernel``, ``.merge``, ``.collective`` (the hops); counters
    ``ring_steps``, ``shift_bytes``, and on a card ``shift_device_us`` and
    ``merge_device_us`` through ``clock`` (a ``profiling.DeviceClock``)."""
    kk = min(k, n_loc)

    def local_fn(x_local: torch.Tensor, clock: profiling.DeviceClock):
        dev = x_local.device
        my = mesh.axis_index(axis)
        buf = x_local
        stage = None
        best_v = torch.full((n_loc, k), -1, dtype=torch.int32, device=dev)
        best_i = torch.zeros((n_loc, k), dtype=torch.int64, device=dev)
        lane = torch.arange(block_rows, device=dev)
        cols = torch.arange(n_loc, device=dev)
        for s in range(r):
            with profiling.span("stpu.parallel.step", s):
                c0 = ((my + s) % r) * n_loc
                for b0 in range(0, n_loc, block_rows):
                    with _stage("kernel", dev):
                        counts = count_block_auto(x_local[b0 : b0 + block_rows], buf)
                    if psum_axis is not None:
                        with _stage("collective", dev):
                            counts = psum(counts.to(torch.int32), mesh, psum_axis)
                    with _stage("merge", dev), clock.time("merge_device_us"):
                        row_g = lane + my * n_loc + b0
                        col_g = cols + c0
                        counts = counts.to(torch.int32).masked_fill(
                            (row_g[:, None] == col_g[None, :]) | (col_g[None, :] >= n_real), -1)
                        v, i = torch.topk(counts, kk, dim=1)
                        cand_v = torch.cat([best_v[b0 : b0 + block_rows], v], dim=1)
                        cand_i = torch.cat([best_i[b0 : b0 + block_rows], i + c0], dim=1)
                        nv, sel = torch.topk(cand_v, k, dim=1)
                        best_v[b0 : b0 + block_rows] = nv
                        best_i[b0 : b0 + block_rows] = torch.gather(cand_i, 1, sel)
                    del counts  # its memory serves the next block's kernel
                if s < r - 1:
                    with _stage("collective", dev), clock.time("shift_device_us"):
                        if buf is x_local:
                            buf = ppermute(x_local, mesh, axis, -1)
                        else:
                            if stage is None:
                                stage = shift_stage(buf, mesh, axis)
                            ring_shift_(buf, mesh, axis, -1, stage)
                    profiling.count("shift_bytes", buf.numel() * buf.element_size())
                profiling.count("ring_steps")
        return best_v, best_i.to(torch.int32)

    return local_fn


def _ring_topk_job(x_local: torch.Tensor, mesh: Mesh, k: int, block_rows: int, n_loc: int,
                   n_real: int):
    """One whole rows-ring top-k over this rank's shard ``x_local`` (its
    word slice on a 2-D mesh): the ring, then the all-gather of every
    rank's rows. Returns host (vals, idx) [N, k] with masked (−1) entries
    left in. Spans ``stpu.parallel.job`` (k, N, ranks) round it all and
    ``stpu.parallel.collective`` round the all-gather."""
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    dev = x_local.device
    clock = profiling.DeviceClock(dev)
    with profiling.span("stpu.parallel.job", k, n_real, r):
        vals_d, idx_d = _ring_topk_local(mesh, axis, r, n_loc, k, block_rows, n_real,
                                         psum_axis=bit_axis_of(mesh))(x_local, clock)
        with _stage("collective", dev):
            vals = fetch_global(vals_d, mesh)[:n_real]
            idx = fetch_global(idx_d, mesh)[:n_real]
        # the downloads above waited for the device
        clock.count()
    return vals, idx


def _shard_operand(shard: RowShard, mesh: Mesh, k: int, block_rows: Optional[int]):
    """(x_local, block_rows, n_loc) of a :class:`RowShard`, checked against
    the ring's geometry on ``mesh``."""
    if len(mesh.axis_names) != 1:
        raise ValueError("a RowShard runs on a 1-D row mesh")
    axis = mesh.axis_names[0]
    if not 1 <= k < max(shard.n, 2):
        raise ValueError(f"k must be in [1, N-1], got k={k}, N={shard.n}")
    w = shard.words
    words = -(-shard.m_bits // 32)
    if w.dtype != torch.int32 or w.dim() != 2 or w.shape[1] != words:
        raise ValueError(f"a RowShard's words are int32 [rows, {words}], got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.device != mesh.device:
        raise ValueError(f"this rank's shard lies on {w.device}, its mesh on {mesh.device}")
    block_rows, n_loc = _ring_geometry(shard.n, shard.m_bits, mesh.shape[axis], mesh.device,
                                       block_rows)
    row0 = mesh.axis_index(axis) * n_loc
    if shard.row0 != row0 or w.shape[0] != n_loc:
        raise ValueError(f"this rank holds rows [{row0}, {row0 + n_loc}) of the ring "
                         f"(shard_rows), got {w.shape[0]} rows from {shard.row0}")
    return w.contiguous(), block_rows, n_loc


def _ring_topk_measure_local(mesh: Mesh, axis: str, r: int, n_loc: int, kk: int,
                             block_rows: int, measure: str, psum_axis: Optional[str] = None):
    """This rank's ring loop keeping the running top-``kk`` CANDIDATES of
    its rows by float32 similarity, each with its exact count for the
    host's float64 rescore. Self pairs and padding columns (global column ≥
    ``n_real``) score −inf."""
    kk_step = min(kk, n_loc)

    def local_fn(x_local, nnz_local, nnz_all, m_f: float, n_real: int):
        dev = x_local.device
        my = mesh.axis_index(axis)
        buf = x_local
        best_s = torch.full((n_loc, kk), -float("inf"), dtype=torch.float32, device=dev)
        best_c = torch.zeros((n_loc, kk), dtype=torch.int32, device=dev)
        best_i = torch.zeros((n_loc, kk), dtype=torch.int64, device=dev)
        lane = torch.arange(block_rows, device=dev)
        cols = torch.arange(n_loc, device=dev)
        for s in range(r):
            c0 = ((my + s) % r) * n_loc
            nnz_cols = nnz_all[c0 : c0 + n_loc]
            col_g = cols + c0
            for b0 in range(0, n_loc, block_rows):
                blk = slice(b0, b0 + block_rows)
                counts = count_block_auto(x_local[blk], buf).to(torch.int32)
                if psum_axis is not None:
                    counts = psum(counts, mesh, psum_axis)
                scores = _screen_vals(counts, nnz_local[blk], nnz_cols, m_f, measure)
                row_g = lane + my * n_loc + b0
                scores = scores.masked_fill(
                    (row_g[:, None] == col_g[None, :]) | (col_g[None, :] >= n_real),
                    -float("inf"))
                v, i = torch.topk(scores, kk_step, dim=1)
                cg = torch.gather(counts, 1, i)
                ns, sel = torch.topk(torch.cat([best_s[blk], v], dim=1), kk, dim=1)
                best_c[blk] = torch.gather(torch.cat([best_c[blk], cg], dim=1), 1, sel)
                best_i[blk] = torch.gather(torch.cat([best_i[blk], i + c0], dim=1), 1, sel)
                best_s[blk] = ns
            if s < r - 1:
                buf = ppermute(buf, mesh, axis, -1)
        return best_s, best_c, best_i.to(torch.int32)

    return local_fn


def _distributed_topk_measure(bm, k: int, measure: str, mesh: Mesh,
                              block_rows: Optional[int]):
    """Certified-exact similarity top-k over the rows ring (and the 2-D
    mesh): float32 candidates with exact counts from the ring, a float64
    rescore on the host, the candidate width doubled until the k-th value
    clears the excluded columns' float32 bound plus slack."""
    from stormtpu_torch.cross import _MEASURE_TOPK_SLACK
    from stormtpu_torch.setops import derive_similarity

    _validate_screen(measure, 1.0)  # validates the measure name
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    if block_rows is None:
        block_rows = _default_block_rows(bm.m_bits, -(-bm.n // r), mesh.device)
    n_pad = round_up(max(bm.n, r), r * block_rows)
    n_loc = n_pad // r
    x_local, nnz_local, nnz_all = _sharded_operands(bm, mesh, n_pad)
    m_f = float(np.float32(bm.m_bits))
    nnz_host = np.zeros(n_pad, dtype=np.int64)
    nnz_host[: bm.n] = bm.row_nnz
    real = np.arange(n_pad) < bm.n
    kk = int(next_pow2(max(2 * k, k + 8)))
    kk_cap = int(min(n_pad, max(4096, 64 * k)))
    while True:
        kk_run = min(kk, n_pad)
        local = _ring_topk_measure_local(mesh, axis, r, n_loc, kk_run, block_rows, measure,
                                         psum_axis=bit_axis_of(mesh))
        s32_d, cc_d, gi_d = local(x_local, nnz_local, nnz_all, m_f, bm.n)
        s32 = fetch_global(s32_d, mesh)
        cc = fetch_global(cc_d, mesh)
        gi = fetch_global(gi_d, mesh).astype(np.int64)
        valid = s32 > -np.inf
        f = derive_similarity(cc, nnz_host[:, None], nnz_host[gi], bm.m_bits, measure)
        f = np.where(valid, f, -np.inf)
        g = np.where(valid, gi, np.int64(2**62))
        order = np.lexsort((g, -f), axis=1)
        f = np.take_along_axis(f, order, axis=1)
        g = np.take_along_axis(g, order, axis=1)
        if kk_run >= bm.n:
            break  # every real column was a candidate
        ok = f[:, k - 1] > s32[:, -1] + _MEASURE_TOPK_SLACK
        if bool(np.all(ok | ~real)):
            break
        if kk >= kk_cap:
            raise RuntimeError(
                f"measure top-k certification did not converge by "
                f"kk={kk} (pathologically tie-dense scores) — screen "
                f"with distributed_pairs_above(measure=...) instead"
            )
        kk *= 2
    return f[: bm.n, :k], g[: bm.n, :k].astype(np.int32)


def _kshard_tile_ids(bm, r: int):
    """(ti, wk, tile ids) of the bits-axis tile walks: K2 tiles of at most
    the configured rows, one 128-word K step a rank at least."""
    ti = min(default_config().k2_tile_rows, round_up(max(bm.n, 32), 32))
    nb = round_up(max(bm.n, 1), ti) // ti
    return ti, 128, _blocked_tile_ids(nb, _TILE_GROUP)


def distributed_topk_neighbors(
    x: Union[MatrixLike, RowShard],
    k: int,
    *,
    mesh: Optional[Mesh] = None,
    block_rows: Optional[int] = None,
    shard_axis: str = "rows",
    measure: str = "count",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k partners by exact intersection count (self
    excluded), computed sharded over ``mesh`` (default:
    :func:`make_row_mesh` on ``device``). Returns (counts int32 [N, k],
    indices int32 [N, k]) as the single-device form; values equal it, tie
    order among equal counts may differ.

    ``measure``: "count" or a similarity ("jaccard", "dice", "cosine",
    "overlap", "phi", "r2"): then (values float64 [N, k], indices int32
    [N, k]), certified exact, ties toward the lower index. On the rows ring
    (or a 2-D mesh) float32 candidates with their exact counts are
    rescored in float64 on the host; ``shard_axis="bits"`` on a 1-D mesh
    ranks the summed exact counts on the host (N ≤ 32768).

    ``shard_axis="bits"`` (1-D mesh, ≥ 128 words a rank): each rank's word
    slice, the K2-tri tiles summed before the merge; fewer words fall back
    to the ring.

    ``x`` may be a :class:`RowShard`, this rank's rows on its device (each
    rank passes its own; :func:`shard_rows` names them): the count top-k
    on the rows ring of a 1-D mesh, which no rank then reads past its own
    shard and the partner shard passing through. Every rank returns the
    whole result, as from the host form."""
    if isinstance(x, RowShard):
        if mesh is None:
            mesh = make_row_mesh(device=x.words.device if device is None else device)
        if shard_axis != "rows" or measure != "count":
            raise ValueError("a RowShard runs the count top-k on the rows ring "
                             "(shard_axis='rows', measure='count')")
        x_local, block_rows, n_loc = _shard_operand(x, mesh, k, block_rows)
        return _reported(*_ring_topk_job(x_local, mesh, k, block_rows, n_loc, x.n))
    bm = _as_bitmatrix(x)
    if mesh is None:
        mesh = make_row_mesh(device=device)
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    if shard_axis not in ("rows", "bits"):
        raise ValueError(f"shard_axis must be 'rows' or 'bits', got {shard_axis!r}")
    if not 1 <= k < max(bm.n, 2):
        raise ValueError(f"k must be in [1, N-1], got k={k}, N={bm.n}")
    if measure != "count":
        if shard_axis == "bits" and len(mesh.axis_names) == 1:
            from stormtpu_torch.parallel.allpairs import distributed_count_matrix
            from stormtpu_torch.query import _rank_similarity_topk
            from stormtpu_torch.setops import derive_similarity

            _validate_screen(measure, 1.0)
            if bm.n > 32768:
                raise ValueError(
                    f"measure={measure!r} on shard_axis='bits' ranks the "
                    f"N² score matrix on host (N ≤ 32768; got N={bm.n}) "
                    f"— use a rows/2-D mesh (certified ring ranking) at "
                    f"this N"
                )
            c = distributed_count_matrix(bm.packed, mesh=mesh, shard_axis="bits")
            sim = derive_similarity(c, bm.row_nnz[:, None], bm.row_nnz[None, :],
                                    bm.m_bits, measure)
            return _rank_similarity_topk(np.asarray(sim, dtype=np.float64), k)
        return _distributed_topk_measure(bm, k, measure, mesh, block_rows)
    if shard_axis == "bits" and len(mesh.axis_names) == 1 and bm.n_words >= r * 128:
        from stormtpu_torch.query import _topk_tile_walk

        ti, wk, (ibs, jbs) = _kshard_tile_ids(bm, r)
        x_local, _ = _kshard_operands(bm, mesh, ti, wk)
        vals_d, idx_d = _topk_tile_walk(
            x_local, ibs, jbs, k=k, ti=ti, wk=wk, variant=default_config().k2_variant,
            n_real=bm.n, psum=lambda tiles: psum(tiles, mesh, axis))
        vals, idx = download(vals_d[: bm.n]), download(idx_d[: bm.n])
        return _reported(vals, idx)
    block_rows, n_loc = _ring_geometry(bm.n, bm.m_bits, r, mesh.device, block_rows)
    if bit_axis_of(mesh) is None:
        # the same shard a caller of the sharded form fills on its device
        row0 = mesh.axis_index(axis) * n_loc
        shard = RowShard(local_shard(bm.packed, (row0, row0 + n_loc), (0, bm.n_words),
                                     mesh.device), row0, bm.n, bm.m_bits)
        return distributed_topk_neighbors(shard, k, mesh=mesh, block_rows=block_rows)
    x_local, _, _ = _sharded_operands(bm, mesh, n_loc * r)
    return _reported(*_ring_topk_job(x_local, mesh, k, block_rows, n_loc, bm.n))


def _reported(vals: np.ndarray, idx: np.ndarray):
    """A masked entry (−1) is ranked only where a row has fewer than k
    partners, that is at N = 1: it is reported as (0, 0), as the
    single-device form does."""
    valid = vals >= 0
    return np.where(valid, vals, 0), np.where(valid, idx, 0)


def _ring_hits_local(mesh: Mesh, axis: str, r: int, n_loc: int, block_rows: int,
                     measure: str, psum_axis: Optional[str] = None):
    """This rank's TRIANGULAR ring loop: the packed hit bitmap of its rows
    over all N columns, int32 [n_loc, N/32].

    Each unordered shard pair (d, e=d+s) is computed once, by d: the count
    block is screened without the triangle mask, then split into d's half
    (global column > row) and e's half (the transpose of the rest), which
    rides the ring back packed. Step census as the count ring: s = 0 is
    the diagonal (no mirror); even R has a mutual step s = R/2 where both
    ranks compute their own half."""
    wloc = n_loc // 32
    s_max = r // 2 if r % 2 == 0 else (r - 1) // 2

    def local_fn(x_local, nnz_local, nnz_all, thresh: torch.Tensor, m_f: float):
        dev = x_local.device
        my = mesh.axis_index(axis)
        buf = x_local
        out = torch.zeros((n_loc, r * wloc), dtype=torch.int32, device=dev)
        lane = torch.arange(block_rows, device=dev)
        cols = torch.arange(n_loc, device=dev)
        for s in range(s_max + 1):
            partner = (my + s) % r
            c0 = partner * n_loc
            nnz_cols = nnz_all[c0 : c0 + n_loc]
            want_mirror = 0 < s and not (r % 2 == 0 and s == s_max)
            theirs = []
            for b0 in range(0, n_loc, block_rows):
                blk = slice(b0, b0 + block_rows)
                counts = count_block_auto(x_local[blk], buf)
                if psum_axis is not None:
                    # the float32 screen is not a sum of partial screens:
                    # complete the counts first
                    counts = psum(counts.to(torch.int32), mesh, psum_axis)
                row_g = (lane + my * n_loc + b0)[:, None]
                col_g = (cols + c0)[None, :]
                hit = _screen_vals(counts, nnz_local[blk], nnz_cols, m_f, measure) >= thresh
                out[blk, partner * wloc : (partner + 1) * wloc] = _pack_bit_rows(hit & (col_g > row_g))
                if want_mirror:
                    # the partner's half, as (partner rows × my rows)
                    theirs.append(_pack_bit_rows((hit & (row_g > col_g)).T))
            if want_mirror:
                # block b's words cover my rows [b·B, (b+1)·B): side by side
                # they are the mirror tile [n_loc, wloc] in bit order
                src = (my - s) % r
                out[:, src * wloc : (src + 1) * wloc] = ppermute(
                    torch.cat(theirs, dim=1), mesh, axis, s)
            if s < s_max:
                buf = ppermute(buf, mesh, axis, -1)
        return out

    return local_fn


def _kshard_hits(mesh: Mesh, axis: str, x_local, ibs, jbs, nnz, thresh, m_f: float, *,
                 ti: int, wk: int, measure: str):
    """Bits-axis screen: this rank's K2-tri tile partials a chunk at a
    time, summed over ``axis`` to the exact tiles, screened and packed into
    the hit bitmap int32 [n_pad, n_pad/32] (the same on every rank)."""
    dev = x_local.device
    n_pad = x_local.shape[0]
    nb, wt = n_pad // ti, ti // 32
    bitmap = torch.zeros((n_pad, n_pad // 32), dtype=torch.int32, device=dev)
    grid = bitmap.view(nb, ti, nb, wt)
    thresh_d = torch.tensor(thresh, dtype=torch.float32, device=dev)
    chunk = _tile_chunk(ti)
    variant = default_config().k2_variant
    for c0 in range(0, ibs.size, chunk):
        ib_c, jb_c = ibs[c0 : c0 + chunk], jbs[c0 : c0 + chunk]
        tiles, ids = _chunk_tiles(x_local, ib_c, jb_c, ti, wk, variant)
        tiles = psum(tiles, mesh, axis)
        grid[ids.ibs.long(), :, ids.jbs.long(), :] = _screen_tiles(
            tiles, ids, nnz, thresh_d, m_f, ti, measure, np.flatnonzero(ib_c == jb_c))
        del tiles
    return bitmap


def distributed_pairs_above(
    x: MatrixLike,
    threshold: float,
    *,
    measure: str = "count",
    mesh: Optional[Mesh] = None,
    block_rows: Optional[int] = None,
    shard_axis: str = "rows",
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All unordered pairs (i < j) with measure ≥ threshold, screened over
    ``mesh`` (default: :func:`make_row_mesh` on ``device``). Same contract
    as ``stormtpu_torch.pairs_above``: a float32 screen with slack, an
    exact host refine — rounding can only add candidates, never drop a
    true hit.

    ``shard_axis="rows"``: row-sharded X, the triangular ring.
    ``shard_axis="bits"`` (1-D mesh, ≥ 128 words a rank): word-sharded X,
    the K2-tri tiles summed before the screen; fewer words fall back to the
    ring."""
    bm = _as_bitmatrix(x)
    if mesh is None:
        mesh = make_row_mesh(device=device)
    dev = mesh.device
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    if shard_axis not in ("rows", "bits"):
        raise ValueError(f"shard_axis must be 'rows' or 'bits', got {shard_axis!r}")
    dev_thresh = _validate_screen(measure, threshold)
    m_f = float(np.float32(bm.m_bits))
    if shard_axis == "bits" and len(mesh.axis_names) == 1 and bm.n_words >= r * 128:
        ti, wk, (ibs, jbs) = _kshard_tile_ids(bm, r)
        x_local, n_pad = _kshard_operands(bm, mesh, ti, wk)
        hits_d = _kshard_hits(mesh, axis, x_local, ibs, jbs, bm.device_nnz(n_pad, device=dev),
                              dev_thresh, m_f, ti=ti, wk=wk, measure=measure)
        return _pairs_of_hits(bm, hits_d, _word_summary(hits_d), measure, threshold, dev)
    if block_rows is None:
        block_rows = _default_block_rows(bm.m_bits, -(-bm.n // r), dev)
    # mirror tiles pack bits along the local-row axis a block at a time,
    # so the block must be word-aligned
    block_rows = int(round_up(block_rows, 32))
    n_pad = round_up(max(bm.n, r), r * block_rows)
    n_loc = n_pad // r
    x_local, nnz_local, nnz_all = _sharded_operands(bm, mesh, n_pad)
    thresh_d = torch.tensor(dev_thresh, dtype=torch.float32, device=dev)
    hits = fetch_global(
        _ring_hits_local(mesh, axis, r, n_loc, block_rows, measure,
                         psum_axis=bit_axis_of(mesh))(x_local, nnz_local, nnz_all, thresh_d, m_f),
        mesh)
    return _expand_and_refine(bm, hits.view(np.uint32), measure, threshold, dev)
