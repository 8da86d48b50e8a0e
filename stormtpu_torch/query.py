"""Query layer: explicit-pair counts, top-k neighbours, threshold screens
(port of ``stormtpu/query.py``).

- ``pair_counts``    — counts for an explicit (i, j) list: the pairs'
                       rows gathered on the card into two [P, W] operands
                       and streamed through K0 (``pair_count_stream_pallas``)
- ``topk_neighbors`` — per-row k best partners by intersection count
                       (self excluded), or by a similarity measure
- ``pairs_above``    — all pairs with count (or similarity) ≥ threshold: a
                       packed hit bitmap on the card, a one-bit-a-word
                       summary of it downloaded first, then only its
                       nonzero words, expanded to COO on the host

Routes follow D1 as in the JAX package: the triangular K2 tile walk
(``count_tiles_pallas_mxu``) with a screen or a top-k merge after each
chunk of tiles; the block form on ``count_block_auto`` (K2-rect above
``kernels.plain_product_max_bits``); a host filter or host top-k on the full count matrix for the
sparse and block-clustered (K5) regimes. The screen, merge and packing
passes are PyTorch operations on the tiles' device. Counts are exact;
similarity screens run in float32 with the reference's slack and are
refined exactly in float64 on the host, so the result sets are the
reference's. Tie order among equal counts depends on the route (and on
``torch.topk``), as it does in the reference; the values do not.

Every entry point takes ``device=None`` (the card) or ``device="cpu"``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from stormtpu_torch.api import MatrixLike, _as_bitmatrix
from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels import count_block_auto
from stormtpu_torch.utils import (
    download,
    profiling,
    resolve_device,
    round_up,
    triangular_tile_ids,
)

__all__ = ["pair_counts", "topk_neighbors", "pairs_above"]

_stage = functools.partial(profiling.stage, "query")

# Per-operand word budget for the pair_counts gather (~256 MB).
_PAIR_GATHER_MAX_WORDS = 1 << 26

# Host ceiling for routes that materialize the N×N score matrix on the
# host (N² float64 = 8 GB at 32768).
_MEASURE_HOST_N_CEILING = 32768

# Count-tile bytes of one chunk of the tile-walk queries: 1024 tiles at
# 256 rows. The JAX package takes 64 tiles, to bound its compiled shapes and
# the duplicate tiles that pad its list; the CUDA kernel compiles once and
# the port's list is not padded, so the chunk is set by memory alone: the
# tiles and the screen's float32 values and packing temporaries stay near
# a gigabyte, and each launch holds enough tiles to fill the card.
_SCREEN_TILE_CHUNK_BYTES = 1 << 28


def _tile_chunk(ti: int) -> int:
    return max(1, _SCREEN_TILE_CHUNK_BYTES // (4 * ti * ti))


def _default_block_rows(m_bits: int, n_cols: int = 0, device=None) -> int:
    """Row-block size of the block-form queries on ``device``. Above
    ``kernels.plain_product_max_bits`` the block kernel is the K2
    rectangle, which pads row blocks to its tile: match the tile. Below,
    the plain int8 product unpacks the whole partner matrix at every
    block, so the block is sized by a counts-memory budget (~512 MB of
    int32) and balanced to shave the last block's padding."""
    from stormtpu_torch.kernels import plain_product_max_bits

    if m_bits > plain_product_max_bits(device):
        return default_config().k2_tile_rows
    if n_cols <= 0:
        return 64
    budget = max(64, (1 << 29) // max(4 * n_cols, 1))
    n64 = round_up(n_cols, 64)
    blk = min(budget, n64, 8192)
    nb = -(-n64 // blk)
    blk = round_up(-(-n64 // nb), 64)
    return int(blk)


# ------------------------------------------------------------ pair counts
def pair_counts(x: MatrixLike, ii, jj, *, device=None) -> np.ndarray:
    """Exact counts int32 [P] for explicit row pairs (ii[p], jj[p])."""
    bm = _as_bitmatrix(x)
    ii = np.asarray(ii, dtype=np.int32)
    jj = np.asarray(jj, dtype=np.int32)
    if ii.shape != jj.shape or ii.ndim != 1:
        raise ValueError("ii and jj must be equal-length 1-D index arrays")
    if ii.size and (
        ii.min() < 0 or jj.min() < 0 or ii.max() >= bm.n or jj.max() >= bm.n
    ):
        raise ValueError("pair index out of range")
    if ii.size == 0:
        return np.zeros(0, dtype=np.int32)
    from stormtpu_torch.kernels.dense import pair_count_stream_pallas

    dev = resolve_device(device)
    # any larger cached buffer serves (the screen's padded copy): indices
    # are < N, so a second full copy is never pinned beside it
    packed_d = bm.device_padded(bm.n, device=dev, reuse_larger=True)
    # the gather materializes two [chunk, W] operands: chunk them so that
    # a long pair list never allocates P·W·8 bytes at once
    budget_rows = max(8, _PAIR_GATHER_MAX_WORDS // max(packed_d.shape[1], 1) // 8 * 8)
    idx = torch.from_numpy(np.stack([ii, jj]).astype(np.int64)).to(dev)
    out = torch.empty(ii.size, dtype=torch.int32, device=dev)
    for o in range(0, ii.size, budget_rows):
        a = packed_d.index_select(0, idx[0, o : o + budget_rows])
        b = packed_d.index_select(0, idx[1, o : o + budget_rows])
        out[o : o + budget_rows] = pair_count_stream_pallas(a, b)
    return download(out)


# ------------------------------------------------------------ top-k
def _topk_blocks(packed: torch.Tensor, k: int, block_rows: int, n_real: int):
    """Block-form top-k: each row block's counts against every row on
    ``count_block_auto``, the self pair and the padding columns (global
    column ≥ ``n_real``) masked to −1, ``torch.topk``. A padded row counts
    0 and would tie with a real partner of count 0; ``torch.topk`` does not
    prefer the lower index, so padding is masked, never out-ranked."""
    n = packed.shape[0]
    vals, idx = [], []
    lane = torch.arange(block_rows, device=packed.device)
    for b0 in range(0, n, block_rows):
        with _stage("kernel", packed.device):
            counts = count_block_auto(packed[b0 : b0 + block_rows], packed)
        with _stage("merge", packed.device):
            counts[lane, b0 + lane] = -1  # drop self
            counts[:, n_real:] = -1  # drop padding
            v, i = torch.topk(counts, k, dim=1)
        vals.append(v)
        idx.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idx)


def topk_neighbors(
    x: MatrixLike, k: int, *, measure: str = "count",
    block_rows: Optional[int] = None,
    on_host_limit: str = "stream",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k partners by exact intersection count (self excluded).

    Returns (counts int32 [N, k], indices int32 [N, k]), sorted
    descending. Counts are uniquely determined; the order of indices among
    equal counts depends on the route. ``block_rows`` tunes the block
    route only.

    ``measure``: "count" or a similarity of :func:`similarity_matrix`
    ("jaccard", "dice", "cosine", "overlap", "phi", "r2"): then (values
    float64 [N, k], indices int32 [N, k]), exact, ties toward the lower
    index. Similarity ranking materializes the N×N score matrix on the
    host up to N = 32768; above it ``on_host_limit="stream"`` takes the
    streamed walk (``stream_query.stream_topk_neighbors``: exact values,
    tie order the walk's), and ``"raise"`` raises ``ValueError``.
    """
    bm = _as_bitmatrix(x)
    if not 1 <= k < max(bm.n, 2):
        raise ValueError(f"k must be in [1, N-1], got k={k}, N={bm.n}")
    if on_host_limit not in ("stream", "raise"):
        raise ValueError(
            f"on_host_limit must be 'stream' or 'raise', got {on_host_limit!r}"
        )
    dev = resolve_device(device)
    if measure != "count":
        if bm.n > _MEASURE_HOST_N_CEILING:
            if on_host_limit == "raise":
                raise ValueError(
                    f"measure={measure!r} top-k materializes the N² score "
                    f"matrix on host (N ≤ {_MEASURE_HOST_N_CEILING}; got "
                    f"N={bm.n}) and on_host_limit='raise' — use "
                    f"stream_topk_neighbors or on_host_limit='stream'"
                )
            from stormtpu_torch.stream_query import stream_topk_neighbors

            return stream_topk_neighbors(bm, k, measure=measure, device=dev)
        from stormtpu_torch.setops import similarity_matrix

        if bm.n == 1:
            # k=1 is admitted at N=1: no partner, the (0, 0) convention
            return (np.zeros((1, k), dtype=np.float64),
                    np.zeros((1, k), dtype=np.int32))
        sim = similarity_matrix(bm, measure=measure, device=dev)
        return _rank_similarity_topk(sim, k)
    from stormtpu_torch.stream import require_device_budget

    if bm.n > 2:
        # every route (tile walk, block form, and the clustered host
        # route's count matrix) uploads the packed operand
        require_device_budget(
            4 * bm.n * bm.n_words,
            f"N={bm.n}: the packed operand",
            "use stormtpu_torch.stream_query.stream_topk_neighbors "
            "(host-RAM-bounded)",
            device=dev,
        )
    from stormtpu_torch.dispatch import choose_strategy

    strategy = (
        choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm, device=dev)
        if bm.n > 1 else "popcount"
    )
    if strategy == "clustered" and bm.n <= 32768:
        # block-clustered input with a host-sized C: K5's counts skip the
        # co-empty tiles; the top-k is taken on the host
        from stormtpu_torch.api import intersect_count_matrix

        with _stage("count_matrix", dev):
            c = intersect_count_matrix(bm, device=dev).astype(np.int64)
        np.fill_diagonal(c, -1)
        idx = np.argpartition(-c, min(k, bm.n - 1) - 1, axis=1)[:, :k]
        vals = np.take_along_axis(c, idx, axis=1)
        order = np.argsort(-vals, axis=1, kind="stable")
        vals = np.take_along_axis(vals, order, axis=1).astype(np.int32)
        idx = np.take_along_axis(idx, order, axis=1).astype(np.int32)
        valid = vals >= 0
        vals = np.where(valid, vals, 0)
        idx = np.where(valid, idx, 0)
        return vals, idx
    if bm.n > 1 and strategy in ("pallas_mxu", "clustered"):
        # triangular K2 tile walk: half the work of the block form
        packed_d, ibs, jbs, ti, wk, _ = _tile_walk_operands(bm, dev)
        vals_d, idx_d = _topk_tile_walk(packed_d, ibs, jbs, k=k, ti=ti, wk=wk,
                                        variant=default_config().k2_variant, n_real=bm.n)
    else:
        if block_rows is None:
            block_rows = _default_block_rows(bm.m_bits, bm.n, dev)
        n_pad = round_up(bm.n, block_rows)
        vals_d, idx_d = _topk_blocks(bm.device_padded(n_pad, device=dev), k, block_rows,
                                     bm.n)
    with _stage("download", dev):
        vals = download(vals_d[: bm.n])
        idx = download(idx_d[: bm.n])
    # a masked entry (−1) is ranked only where a row has fewer than k
    # partners, that is at N = 1: it is reported as (0, 0)
    valid = vals >= 0
    vals = np.where(valid, vals, 0)
    idx = np.where(valid, idx, 0)
    return vals, idx


def _rank_similarity_topk(sim: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-row top-k of a float64 similarity matrix, ties toward the
    lower index. Sets ``sim``'s diagonal to −inf."""
    n = sim.shape[0]
    np.fill_diagonal(sim, -np.inf)
    kk = min(k, n - 1)
    idx = np.argpartition(-sim, kk - 1, axis=1)[:, :k]
    vals = np.take_along_axis(sim, idx, axis=1)
    # argpartition picks arbitrarily among scores tied at the k-th place;
    # rows whose boundary value occurs beyond the selection are re-resolved
    # over their full candidate set, lower index first
    vk = vals.min(axis=1)
    tied = np.flatnonzero((sim >= vk[:, None]).sum(axis=1) > kk)
    for r in tied:
        cand = np.flatnonzero(sim[r] >= vk[r])
        cand = cand[np.lexsort((cand, -sim[r, cand]))][:k]
        idx[r] = cand
        vals[r] = sim[r, cand]
    order = np.lexsort((idx, -vals), axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    idx = np.take_along_axis(idx, order, axis=1).astype(np.int32)
    return vals, idx


# ------------------------------------------------------------ screens
def _screen_vals(counts, nnz_rows, nnz_cols, m_f, measure: str) -> torch.Tensor:
    """float32 screen values [B, C] of a counts block (what the device
    threshold is compared with). Similarity measures are screened in
    float32 with the caller's slack; the host re-filters the hits exactly
    in float64, so float32 rounding can only add candidates."""
    if measure == "count":
        return counts.to(torch.float32)
    return _screen_vals_core(
        counts,
        nnz_rows[:, None].to(torch.float32),
        nnz_cols[None, :].to(torch.float32),
        m_f,
        measure,
    )


def _screen_vals_core(counts, ca, cb, m_f, measure: str) -> torch.Tensor:
    """The similarity screen formulas over broadcastable float32 operands;
    ``ca``/``cb``/``m_f`` may be per-pair tensors (the pairwise-complete
    screen's co-observed universes)."""
    inter = counts.to(torch.float32)
    if measure == "jaccard":
        denom = ca + cb - inter
    elif measure == "dice":
        inter = 2.0 * inter
        denom = ca + cb
    elif measure == "cosine":
        denom = torch.sqrt(ca * cb)
    elif measure in ("phi", "r2"):
        # num = m·inter − ca·cb cancels catastrophically in float32 on
        # dense rows, so it is inflated by a rounding bound: products and
        # integers ≥ 2²⁴ carry relative error ~6e-8 each, and 2e-6·|terms|
        # covers their sum with a wide margin. The host re-filters exactly.
        terms = m_f * inter + ca * cb
        err = 2e-6 * terms + 1e-3
        num = m_f * inter - ca * cb + err
        den = torch.sqrt(ca * cb * (m_f - ca) * (m_f - cb))
        if measure == "r2":
            num = torch.abs(m_f * inter - ca * cb) + err
            num = num * num
            den = den * den
        inter = num
        denom = den
    else:  # overlap
        denom = torch.minimum(ca, cb)
    pos = denom > 0
    return torch.where(pos, inter / torch.where(pos, denom, 1.0), 0.0)


_BIT_WEIGHTS: dict = {}


def _bit_weights(device) -> torch.Tensor:
    """int32 [32]: 1 << b for b < 31 and −2³¹ for bit 31 — the int32
    bit-view of each bit's uint32 weight. A sum of distinct weights never
    leaves int32's range, so summing them in int32 is exact."""
    key = str(device)
    if key not in _BIT_WEIGHTS:
        w = np.array([(1 << b) - ((1 << 32) if b == 31 else 0) for b in range(32)],
                     dtype=np.int32)
        _BIT_WEIGHTS[key] = torch.from_numpy(w).to(device)
    return _BIT_WEIGHTS[key]


def _pack_bit_rows(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., Y] (Y % 32 == 0) → int32 bit-view [..., Y/32], little bit
    order: bit y of a row lands in word y//32 at weight 1 << (y % 32), the
    layout ``layout.unpack_bits`` inverts. Read on the host with
    ``.view(np.uint32)``."""
    y = mask.shape[-1]
    bits = mask.reshape(*mask.shape[:-1], y // 32, 32)
    return torch.where(bits, _bit_weights(mask.device), 0).sum(dim=-1, dtype=torch.int32)


def _word_summary(flat: torch.Tensor) -> torch.Tensor:
    """One bit a word of a packed hit bitmap [R, W] → int32 [R, ceil(W/32)]
    (the first fetch of the two-phase download: 1024× fewer bytes than
    counts)."""
    wout = flat.shape[1]
    nz = flat != 0
    pad = round_up(wout, 32) - wout
    if pad:
        nz = torch.nn.functional.pad(nz, (0, pad))
    return _pack_bit_rows(nz)


# Tile blocks of the query walks' order: 16 × 16 tiles, the tiles of one
# stripe of the streaming walk at superblock 4096 and 256-row tiles.
_TILE_GROUP = 16


def _blocked_tile_ids(nb: int, group: int) -> tuple[np.ndarray, np.ndarray]:
    """The triangular tile list (ib ≤ jb) in blocks of group × group tiles,
    block-row major and i-major inside a block: the tiles a launch holds at
    once then share a few row blocks of the operand, as a stripe of the
    streaming walk does, instead of streaming the whole matrix past one row
    block (the i-major order)."""
    ib, jb = triangular_tile_ids(nb)
    order = np.lexsort((jb, ib, jb // group, ib // group))
    return ib[order], jb[order]


def _tile_walk_operands(bm, device):
    """The K2 tile-walk queries' operands: the padded operand [n_pad,
    w_pad] on ``device`` (cached on the matrix, shared with the histogram
    walk's copy where one exists) and the triangular tile list on the host
    (:func:`_blocked_tile_ids`), with the tile geometry. The list is not
    padded: the CUDA kernel takes any length, so the last chunk is simply
    shorter and no tile is listed twice."""
    from stormtpu_torch.kernels.mxu import k2_tile_shape

    cfg = default_config()
    ti, wk = k2_tile_shape(cfg, bm.n, bm.n_words)
    n_pad = round_up(bm.n, ti)
    ibs, jbs = _blocked_tile_ids(n_pad // ti, _TILE_GROUP)
    packed_d = bm.device_padded2d(n_pad, round_up(bm.n_words, wk), device=device)
    return packed_d, ibs, jbs, ti, wk, n_pad


def _chunk_tiles(packed, ibs_c, jbs_c, ti, wk, variant):
    """One chunk's K2 count tiles [c, ti, ti], the ids checked on the host
    and uploaded in one copy (nothing is read back), and the ids on the
    device."""
    from stormtpu_torch.kernels.mxu import count_tiles_pallas_mxu, device_tile_ids

    dev = packed.device
    with _stage("plan", dev):
        ids = device_tile_ids(ibs_c, jbs_c, packed.shape[0] // ti, dev)
    with _stage("kernel", dev):
        tiles = count_tiles_pallas_mxu(packed, *ids, tile_rows=ti, tile_words=wk,
                                       variant=variant, checked=ids)
    return tiles, ids


# k up to which _top_rows takes k passes of max (above it, torch.topk)
_TOP_PASSES = 16


def _top_rows(x: torch.Tensor, k: int):
    """The k largest values along the last dim of int32 ``x`` and their
    positions, descending. For k ≤ ``_TOP_PASSES``: k passes of ``max``,
    each masking its winner, where ``torch.topk`` sorts each short row
    (``scripts/torch_query_ab.py`` times both on a chunk of 1024 tiles of
    256²). Ties pick distinct positions."""
    if k > _TOP_PASSES:
        return torch.topk(x, k, dim=-1)
    x = x.clone()
    vals, idx = [], []
    for _ in range(k):
        v, i = x.max(dim=-1, keepdim=True)
        vals.append(v)
        idx.append(i)
        x.scatter_(-1, i, torch.iinfo(x.dtype).min)
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def _merge_sets(best_v: torch.Tensor, best_i: torch.Tensor, tgt: np.ndarray,
                cand_v: torch.Tensor, cand_i: torch.Tensor, ti: int) -> None:
    """Merge candidate sets into the running per-row top-k, in place: set s
    offers ``cand_v[s]`` / ``cand_i[s]`` ([ti, kk] values and global
    indices) to the rows of row block ``tgt[s]`` (host). One sort of (row,
    value) keys lines up every touched row's candidates and its current
    best, highest value first; each row keeps the first k of its segment.
    The work is the candidates' count, whatever the order of the sets."""
    dev = cand_v.device
    s_n, _, kk = cand_v.shape
    k = best_v.shape[1]
    lane = torch.arange(ti, device=dev)
    targets, counts = np.unique(tgt, return_counts=True)
    ids = torch.from_numpy(np.concatenate([tgt, targets]).astype(np.int64)).to(dev)
    rows_c = (ids[:s_n, None] * ti + lane).unsqueeze(2).expand(s_n, ti, kk)
    rows_b = ids[s_n:, None] * ti + lane                     # [U, ti] touched rows
    rows = torch.cat([rows_c.reshape(-1), rows_b.unsqueeze(2).expand(-1, ti, k).reshape(-1)])
    vals = torch.cat([cand_v.reshape(-1), best_v[rows_b].reshape(-1)])
    idx = torch.cat([cand_i.reshape(-1), best_i[rows_b].reshape(-1)])
    # rows ascending, then values descending (counts lie in [-1, 2³¹))
    order = torch.argsort((rows << 32) | ((1 << 31) - 1 - vals.to(torch.int64)))
    # a row of target t holds k + kk·counts[t] entries; the segments follow
    # the rows' order
    seg = k + kk * counts
    base = np.concatenate([[0], np.cumsum(ti * seg)[:-1]])
    geo = torch.from_numpy(np.stack([base, seg]).astype(np.int64)).to(dev)
    start = geo[0][:, None] + lane * geo[1][:, None]          # [U, ti]
    pick = order[start.unsqueeze(2) + torch.arange(k, device=dev)]
    best_v[rows_b] = vals[pick]
    best_i[rows_b] = idx[pick]


def _chunk_topk_sets(packed, ibs_c, jbs_c, ti, wk, variant, k: int, n_real: int):
    """One chunk's K2-topk candidate sets (``mxu.TileTopk``), the ids
    checked on the host and uploaded in one copy."""
    from stormtpu_torch.kernels.mxu import count_tiles_topk, device_tile_ids

    dev = packed.device
    with _stage("plan", dev):
        ids = device_tile_ids(ibs_c, jbs_c, packed.shape[0] // ti, dev)
    with _stage("kernel", dev):
        return count_tiles_topk(packed, *ids, tile_rows=ti, tile_words=wk, k=k,
                                n_real=n_real, variant=variant, checked=ids)


def _one_set_a_tile(v: torch.Tensor, i: torch.Tensor, kk: int):
    """K2-topk's sets of T tiles, [T, s, ti, kk] (one a sub-tile), cut to
    one set a tile [T, ti, kk]: each lane's kk best over its s sets (a
    lane's best in the tile lie among each sub-tile's best)."""
    t, s, ti, _ = v.shape
    if s == 1:
        return v[:, 0], i[:, 0]
    top, pos = torch.topk(v.permute(0, 2, 1, 3).reshape(t, ti, s * kk), kk, dim=2)
    return top, i.permute(0, 2, 1, 3).reshape(t, ti, s * kk).gather(2, pos)


def _topk_tile_walk(packed, ibs, jbs, *, k: int, ti: int, wk: int, variant: str,
                    n_real: int, psum=None):
    """Triangular top-k: the K2 tile walk with a running per-row top-k,
    ``best`` (values, indices) [n_pad, k] on the device.

    Route (``mxu.topk_route``): for k ≤ ``mxu.TOPK_EPI_MAX`` on exact tiles,
    K2-topk (``count_tiles_topk``) ranks each tile inside the kernel and
    the tiles are never stored; its sets (a row's best over a sub-tile's
    columns, a column's best over a sub-tile's rows) are merged as they
    come. Otherwise the tiles are stored and ranked here, as follows.

    Each upper tile (ib, jb) offers candidates to both row blocks: its
    rows (partners in jb) and, transposed, jb's rows (partners in ib). A
    pair (i, j) lies in exactly one upper tile, so no partner is offered
    to a row twice: top-k merges are not idempotent, and a diagonal tile
    offers one side only (its transpose is the same set), its diagonal
    masked to −1, as are the padding columns (global column ≥ ``n_real``)
    of the last column block. Each side of a tile is first cut to its own top-min(k,
    ti) a row (a row's top-k partners are among the top-k of each tile they
    lie in); then a chunk's candidate sets are merged into ``best`` all at
    once (:func:`_merge_sets`), so the merge takes a fixed number of
    operations a chunk, in any tile order.

    Values equal the reference's; the order among equal values is the
    sort's.

    ``psum``: when set, ``packed`` is one rank's WORD slice and each
    chunk's count tiles are int32 K-partials; ``psum(tiles)`` sums them
    over the ranks to the exact tiles before any top-k touches them (the
    bits-axis form of ``parallel.query``). The merge then runs on the same
    exact tiles on every rank."""
    from stormtpu_torch.kernels import mxu
    from stormtpu_torch.stream import _route

    dev = packed.device
    n_pad = packed.shape[0]
    kk = min(k, ti)
    best_v = torch.full((n_pad, k), -1, dtype=torch.int32, device=dev)
    best_i = torch.zeros((n_pad, k), dtype=torch.int64, device=dev)
    self_mask = torch.eye(ti, dtype=torch.bool, device=dev)
    chunk = _tile_chunk(ti)
    route = mxu.topk_route(k, partial=psum is not None)
    for c0 in range(0, ibs.size, chunk):
        ib_c, jb_c = ibs[c0 : c0 + chunk], jbs[c0 : c0 + chunk]
        _route(route)
        if route == mxu.ROUTE_TOPK:
            sets = _chunk_topk_sets(packed, ib_c, jb_c, ti, wk, variant, k, n_real)
            with _stage("merge", dev):
                # each tile's row set (partners in jb) and each off-diagonal
                # tile's column set (partners in ib), a tile's sub-tile sets
                # cut to one: the merge sees what the store route's does
                off = np.flatnonzero(ib_c != jb_c)
                o = torch.from_numpy(off).to(dev)
                rv, ri = _one_set_a_tile(sets.row_v, sets.row_i, kk)
                cv, ci = _one_set_a_tile(sets.col_v[o], sets.col_i[o], kk)
                _merge_sets(best_v, best_i, np.concatenate([ib_c, jb_c[off]]),
                            torch.cat([rv, cv]), torch.cat([ri, ci]).long(), ti)
            del sets
            continue
        tiles, ids = _chunk_tiles(packed, ib_c, jb_c, ti, wk, variant)
        if psum is not None:
            tiles = psum(tiles)
        with _stage("merge", dev):
            edge = np.flatnonzero(jb_c == n_real // ti) if n_real % ti else ()
            if len(edge):
                # padded rows count 0 and would tie with real partners
                tiles[torch.from_numpy(edge).to(dev), :, n_real % ti :] = -1
            diag = np.flatnonzero(ib_c == jb_c)
            off = np.flatnonzero(ib_c != jb_c)
            sel = torch.from_numpy(np.concatenate([diag, off])).to(dev)
            if diag.size:
                d = sel[: diag.size]
                tiles[d] = tiles[d].masked_fill(self_mask, -1)
            # each tile's rows (partners in jb), then each off-diagonal
            # tile's columns (partners in ib)
            rv, ri = _top_rows(tiles, kk)
            ri += ids.jbs.long()[:, None, None] * ti
            o = sel[diag.size :]
            mv, mi = _top_rows(tiles[o].transpose(1, 2), kk)
            mi += ids.ibs.long()[o][:, None, None] * ti
            _merge_sets(best_v, best_i, np.concatenate([ib_c, jb_c[off]]),
                        torch.cat([rv, mv]), torch.cat([ri, mi]), ti)
        del tiles
    return best_v, best_i.to(torch.int32)


def _screen_tiles(tiles, ids, nnz, thresh, m_f, ti, measure, diag):
    """Packed hit words int32 [c, ti, ti/32] of a chunk of count tiles at
    block coordinates ``ids``: measure ≥ thresh in the strict upper
    triangle (off-diagonal tiles are all upper; a diagonal tile keeps
    col > row)."""
    dev = tiles.device
    if measure == "count":
        vals = tiles.to(torch.float32)
    else:
        lane = torch.arange(ti, device=dev)
        nzr = nnz[ids.ibs.long()[:, None] * ti + lane].to(torch.float32)
        nzc = nnz[ids.jbs.long()[:, None] * ti + lane].to(torch.float32)
        vals = _screen_vals_core(tiles, nzr[:, :, None], nzc[:, None, :], m_f, measure)
    hit = vals >= thresh
    del vals
    if diag.size:
        d = torch.from_numpy(diag).to(dev)
        hit[d] &= torch.ones((ti, ti), dtype=torch.bool, device=dev).triu(1)
    return _pack_bit_rows(hit)


def _hits_tiles_and_summary(packed, ibs, jbs, thresh, nnz, m_f, *, ti: int, wk: int,
                            variant: str, measure: str):
    """Triangular screen: the K2 tile walk with the screen and bit packing
    after each chunk of tiles, so the count tiles never exist beyond one
    chunk. Returns (hit bitmap int32 [n_pad, n_pad/32], word summary), both
    on the device."""
    dev = packed.device
    n_pad = packed.shape[0]
    nb, wt = n_pad // ti, ti // 32
    bitmap = torch.zeros((n_pad, n_pad // 32), dtype=torch.int32, device=dev)
    grid = bitmap.view(nb, ti, nb, wt)
    thresh_d = torch.tensor(thresh, dtype=torch.float32, device=dev)
    chunk = _tile_chunk(ti)
    for c0 in range(0, ibs.size, chunk):
        ib_c, jb_c = ibs[c0 : c0 + chunk], jbs[c0 : c0 + chunk]
        tiles, ids = _chunk_tiles(packed, ib_c, jb_c, ti, wk, variant)
        with _stage("screen", dev):
            words = _screen_tiles(tiles, ids, nnz, thresh_d, m_f, ti, measure,
                                  np.flatnonzero(ib_c == jb_c))
            del tiles
            grid[ids.ibs.long(), :, ids.jbs.long(), :] = words
    with _stage("screen", dev):
        return bitmap, _word_summary(bitmap)


def _hits_and_summary(packed, thresh, nnz, block_rows: int, measure: str, m_f):
    """Block screen: each row block's counts against every row on
    ``count_block_auto``, screened and packed to hit bits [B, n_pad/32] in
    the strict upper triangle (global ids). Returns (hit bitmap, word
    summary) on the device."""
    dev = packed.device
    n = packed.shape[0]
    flat = torch.empty((n, n // 32), dtype=torch.int32, device=dev)
    thresh_d = torch.tensor(thresh, dtype=torch.float32, device=dev)
    cols = torch.arange(n, device=dev)
    for b0 in range(0, n, block_rows):
        blk = packed[b0 : b0 + block_rows]
        with _stage("kernel", dev):
            counts = count_block_auto(blk, packed)
        with _stage("screen", dev):
            vals = _screen_vals(counts, nnz[b0 : b0 + block_rows], nnz, m_f, measure)
            rows = cols[b0 : b0 + block_rows]
            hit = (vals >= thresh_d) & (cols[None, :] > rows[:, None])
            flat[b0 : b0 + block_rows] = _pack_bit_rows(hit)
    with _stage("screen", dev):
        return flat, _word_summary(flat)


def _complete_screen_block(d_pad, m_pad, r0: int, n_valid: int, thresh, *,
                           measure: str, bl: int):
    """One row block of the pairwise-complete screen
    (``setops.pairs_above_complete``): four rectangle counts (data·dataᵀ,
    data·maskᵀ, mask·dataᵀ, mask·maskᵀ) feed the per-pair-universe screen
    formulas. Returns the packed upper-triangle hit bitmap and its word
    summary, on the device."""
    dev = d_pad.device
    d_blk = d_pad[r0 : r0 + bl]
    m_blk = m_pad[r0 : r0 + bl]
    with _stage("kernel", dev):
        inter = count_block_auto(d_blk, d_pad)
        ca = count_block_auto(d_blk, m_pad).to(torch.float32)
        cb = count_block_auto(m_blk, d_pad).to(torch.float32)
        m_pair = count_block_auto(m_blk, m_pad).to(torch.float32)
    with _stage("screen", dev):
        vals = _screen_vals_core(inter, ca, cb, m_pair, measure)
        row_g = torch.arange(bl, device=dev)[:, None] + r0
        col_g = torch.arange(vals.shape[1], device=dev)[None, :]
        thresh_d = torch.tensor(thresh, dtype=torch.float32, device=dev)
        hit = (vals >= thresh_d) & (col_g > row_g) & (col_g < n_valid)
        hits = _pack_bit_rows(hit)
        return hits, _word_summary(hits)


def _validate_screen(measure: str, threshold: float) -> np.float32:
    """Validate (measure, threshold) and return the float32 device-screen
    threshold (with under-admission slack for similarity measures)."""
    from stormtpu_torch.setops import SIM_OPS

    if measure != "count" and measure not in SIM_OPS:
        raise ValueError(f"unknown measure {measure!r}")
    if measure == "count":
        if threshold < 1:
            raise ValueError("count threshold must be >= 1 (0 matches every pair)")
        return np.float32(threshold)
    if not 0.0 < threshold <= 1.0:
        raise ValueError("similarity threshold must be in (0, 1]")
    return np.float32(threshold) - np.float32(1e-4)  # slack


def _gather_hit_words(flat: torch.Tensor, ri: np.ndarray, wi: np.ndarray) -> np.ndarray:
    """The words ``flat[ri[k], wi[k]]`` of a device bitmap (or counts
    block), gathered on its device and downloaded in one copy."""
    at = profiling.upload(torch.from_numpy(np.stack([ri, wi]).astype(np.int64)), flat.device)
    return download(flat[at[0], at[1]])


def _fetch_hit_words(hits_d: torch.Tensor, summary_d: torch.Tensor, n_rows: int):
    """The two-phase download of a hit bitmap's first ``n_rows`` rows: the
    one-bit-a-word summary, then only the nonzero words. Returns (row,
    word, words uint32) of the nonzero words; or (None, None, bitmap
    uint32 [n_rows, W]) for a dense screen, where word by word would cost
    more than the bitmap itself."""
    dev = hits_d.device
    wout = hits_d.shape[1]
    with _stage("summary", dev):
        wi_r, wi_w = _expand_words(download(summary_d[:n_rows]).view(np.uint32), wout)
    with _stage("gather", dev):
        if wi_r.size > hits_d.shape[0] * wout // 8:
            return None, None, download(hits_d[:n_rows]).view(np.uint32)
        if not wi_r.size:
            return wi_r, wi_w, np.zeros(0, np.uint32)
        return wi_r, wi_w, _gather_hit_words(hits_d, wi_r, wi_w).view(np.uint32)


def pairs_above(
    x: MatrixLike,
    threshold: float,
    *,
    measure: str = "count",
    block_rows: Optional[int] = None,
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All unordered pairs (i < j) with measure ≥ threshold.

    measure: "count" (exact integer intersection count) or a similarity —
    "jaccard", "dice", "cosine", "overlap", "phi", "r2" (for phi the screen
    keeps positively correlated pairs, threshold ∈ (0, 1]). Returns (ii,
    jj, values); values are int32 counts for "count", float64 similarities
    otherwise.

    The hit bitmap stays on the device; the host downloads its one-bit-a-
    word summary first, then only the nonzero words, so the download grows
    with the hits and not with N². For similarities the device screen runs
    in float32 with slack and the host re-filters the hits exactly in
    float64: rounding can only add candidates, never drop a true hit.
    """
    del config
    bm = _as_bitmatrix(x)
    dev_thresh = _validate_screen(measure, threshold)
    dev = resolve_device(device)
    # screens follow D1 as the counts do: where the host sparse paths or
    # K5 win and the count matrix fits the host, the exact counts are
    # filtered directly (every measure, phi/r2 of zero-overlap pairs
    # included)
    from stormtpu_torch.dispatch import choose_strategy

    strategy = (
        choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm, device=dev)
        if bm.n > 1 else "popcount"
    )
    if strategy == "clustered" and bm.n > 32768:
        # C no longer fits the host: the triangular tile screen is exact
        strategy = "pallas_mxu"
    if strategy in ("sparse", "sparse_outer", "clustered"):
        from stormtpu_torch.api import intersect_count_matrix

        with _stage("count_matrix", dev):
            c = intersect_count_matrix(bm, device=dev)
        # filter block-wise: a whole-triangle copy (np.triu, or the full
        # triangle r2 needs) would add O(N²) host transients beside c
        with _stage("screen", dev):
            blk = max(1, (1 << 27) // max(bm.n, 1))
            parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
            cols = np.arange(bm.n)
            for r0 in range(0, bm.n, blk):
                rows = np.arange(r0, min(r0 + blk, bm.n))
                cb = c[r0 : r0 + rows.size]
                if measure == "count":
                    vals_b = cb
                else:
                    from stormtpu_torch.setops import derive_similarity

                    vals_b = derive_similarity(
                        cb, bm.row_nnz[rows][:, None], bm.row_nnz[None, :],
                        bm.m_bits, measure,
                    )
                tri = cols[None, :] > rows[:, None]
                si_b, sj_b = np.nonzero(tri & (vals_b >= threshold))
                out_v = (cb[si_b, sj_b].astype(np.int32) if measure == "count"
                         else vals_b[si_b, sj_b])
                parts.append((rows[si_b].astype(np.int32), sj_b.astype(np.int32), out_v))
            ii = np.concatenate([p[0] for p in parts])
            jj = np.concatenate([p[1] for p in parts])
            return ii, jj, np.concatenate([p[2] for p in parts])
    # device screen: the operand and the hit bitmap must fit the device
    from stormtpu_torch.stream import require_device_budget

    if bm.n > 2:
        require_device_budget(
            4 * bm.n * bm.n_words + bm.n * bm.n // 8,
            f"N={bm.n}: the screen operand plus device hit bitmap",
            "use stormtpu_torch.stream_query.stream_pairs_above "
            "(host-RAM-bounded)",
            device=dev,
        )
    m_f = float(np.float32(bm.m_bits))
    if strategy == "pallas_mxu":
        # triangular K2 tile screen: half the work of the block screen
        packed_d, ibs, jbs, ti, wk, n_pad = _tile_walk_operands(bm, dev)
        hits_d, summary_d = _hits_tiles_and_summary(
            packed_d, ibs, jbs, dev_thresh, bm.device_nnz(n_pad, device=dev), m_f,
            ti=ti, wk=wk, variant=default_config().k2_variant, measure=measure,
        )
    else:
        if block_rows is None:
            block_rows = _default_block_rows(bm.m_bits, bm.n, dev)
        lcm = int(np.lcm(block_rows, 32))
        n_pad = round_up(max(bm.n, 1), lcm)
        hits_d, summary_d = _hits_and_summary(
            bm.device_padded(n_pad, device=dev), dev_thresh,
            bm.device_nnz(n_pad, device=dev), block_rows, measure, m_f,
        )
    return _pairs_of_hits(bm, hits_d, summary_d, measure, threshold, dev)


def _pairs_of_hits(bm, hits_d, summary_d, measure: str, threshold: float, device):
    """The screen's pairs from a device hit bitmap and its word summary:
    the two-phase download, the expansion to COO and the exact refine."""
    wi_r, wi_w, words = _fetch_hit_words(hits_d, summary_d, bm.n)
    del hits_d, summary_d
    if wi_r is None:
        return _expand_and_refine(bm, words, measure, threshold, device)
    ii, jj = _expand_bits(bm, wi_r, wi_w, words)
    return _refine(bm, ii, jj, measure, threshold, device)


# Words expanded per host chunk (~0.5 GB transient of unpacked bits).
_EXPAND_CHUNK_WORDS = 1 << 24


def _expand_word_coords(
    wi_r: np.ndarray, wi_w: np.ndarray, words: np.ndarray, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Set-bit coordinates from nonzero bitmap words: ``words[k]`` packs
    columns [wi_w[k]·32, +32) of row wi_r[k]; keeps col < ``width``, in
    row-major (sorted) order. Chunked so the unpacked-bit transient stays
    bounded."""
    if not words.size:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    out_r: list[np.ndarray] = []
    out_c: list[np.ndarray] = []
    for o in range(0, words.size, _EXPAND_CHUNK_WORDS):
        w = words[o : o + _EXPAND_CHUNK_WORDS]
        bits = np.unpackbits(w.view("<u1").reshape(-1, 4), axis=1, bitorder="little")
        sel, bit = np.nonzero(bits)
        # nonzero orders are row-major, so (row, word, bit) stays sorted
        cols = wi_w[o + sel] * 32 + bit
        keep = cols < width
        out_r.append(wi_r[o + sel][keep])
        out_c.append(cols[keep])
    return np.concatenate(out_r), np.concatenate(out_c)


def _expand_words(rows: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Set-bit coordinates of a packed uint32 bitmap [R, W/32] → (row,
    col) with col < ``width``; only the nonzero words are expanded."""
    ri, wi = np.nonzero(rows)
    if not ri.size:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _expand_word_coords(ri, wi, rows[ri, wi], width)


def _expand_bits(bm, wi_r: np.ndarray, wi_w: np.ndarray, words: np.ndarray):
    """COO pair indices (int32) from nonzero hit-bitmap words."""
    ii, jj = _expand_word_coords(wi_r, wi_w, words, bm.n)
    return ii.astype(np.int32), jj.astype(np.int32)


def _refine(bm, ii: np.ndarray, jj: np.ndarray, measure: str, threshold: float,
            device=None):
    """Exact re-filter of screen candidates: int counts by
    :func:`pair_counts` (K0 on the card), float64 for similarities."""
    dev = resolve_device(device)
    with _stage("refine", dev):
        counts = pair_counts(bm, ii, jj, device=dev) if ii.size else np.zeros(0, np.int32)
        if measure == "count":
            return ii, jj, counts
        from stormtpu_torch.setops import derive_similarity

        vals = derive_similarity(counts, bm.row_nnz[ii], bm.row_nnz[jj], bm.m_bits, measure)
        keep = vals >= threshold
        return ii[keep], jj[keep], vals[keep]


def _expand_and_refine(bm, hits: np.ndarray, measure: str, threshold: float, device=None):
    """Expand a packed hit bitmap [≥N, n_pad/32] on the host to COO and
    refine it (the dense-screen download of :func:`pairs_above`)."""
    ii, jj = _expand_words(hits[: bm.n], bm.n)
    return _refine(bm, ii.astype(np.int32), jj.astype(np.int32), measure, threshold, device)
