"""Cross-set queries: one bitmap set against another (port of
``stormtpu/cross.py``).

- :func:`cross_topk_neighbors`: per row of A, the top-k rows of B by exact
  intersection count (or, certified exact, by a similarity);
- :func:`cross_pairs_above`: every (i, j) with measure(A_i, B_j) ≥
  threshold.

Both run on ``count_block_auto`` (the K2 rectangle above
``kernels.plain_product_max_bits``), a block of A rows against a chunk of
B rows at a time, with the top-k or the screen on the device. There is
no self-pair or triangle rule: the full Na×Nb rectangle is scored. A B
beyond the device budget is walked in chunks and merged on the host, so
the cross queries are bounded by host memory, not device memory.

Every entry point takes ``device=None`` (the card) or ``device="cpu"``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels import count_block_auto
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.utils import download, next_pow2, profiling, resolve_device, round_up

__all__ = ["cross_topk_neighbors", "cross_pairs_above"]

_stage = functools.partial(profiling.stage, "cross")

# A rows a device block: the counts block [bl, Nb_pad] stays ≤ ~256 MB at
# Nb = 16384.
_BLOCK_ROWS = 4096


def _operands(a, b):
    from stormtpu_torch.api import _as_bitmatrix

    bm_a = _as_bitmatrix(a)
    bm_b = _as_bitmatrix(b)
    if bm_a.m_bits != bm_b.m_bits:
        raise ValueError(f"bit-universe mismatch: {bm_a.m_bits} vs {bm_b.m_bits}")
    if bm_a.n == 0 or bm_b.n == 0:
        raise ValueError("cross queries need non-empty matrices")
    return bm_a, bm_b


def _block_plan(na: int) -> tuple[int, int]:
    """(block_rows, n_pad) for walking A: blocks ≤ _BLOCK_ROWS."""
    bl = min(_BLOCK_ROWS, next_pow2(na))
    return bl, round_up(na, bl)


def _b_chunk_rows(nb: int, w: int, bl: int, na_pad: int, bitmap: bool, device) -> int:
    """Rows of B on the device a chunk: the whole (padded) B when it fits
    the refusal budget beside the resident A operand and one A block's
    counts, else the largest 32-multiple on a 1/8-octave grid that does.
    Raises (the shared guard) only when A itself and a 32-row chunk cannot
    fit."""
    from stormtpu_torch.stream import _device_refuse_budget, require_device_budget

    budget = _device_refuse_budget(device)
    per_b_row = 4 * (w + bl) + (bl // 8 if bitmap else 0)
    fixed = 4 * (na_pad * w + bl * w)
    require_device_budget(
        fixed + 32 * per_b_row,
        f"Na={na_pad} (padded): the resident A operand plus a 32-row B chunk",
        "reduce the query panel or the bit universe",
        device=device,
    )
    nb_pad = round_up(nb, 32)
    cb = (budget - fixed) // per_b_row
    if cb >= nb_pad:
        return nb_pad  # a single resident chunk (the cached operand)
    e = max(5, cb.bit_length() - 4)
    return (cb >> e) << e


def _b_chunks(bm_b, cb: int, dev):
    """(b0, operand [cb, W] on the device, valid rows) for each B chunk:
    the cached padded operand when one chunk holds B, else a chunk
    uploaded at a time."""
    from stormtpu_torch.stream import _host_superblock

    nb_walk = round_up(bm_b.n, cb)
    for b0 in range(0, nb_walk, cb):
        with _stage("upload", dev):
            if nb_walk == cb:
                b_dev = bm_b.device_padded(cb, device=dev)
            else:
                b_dev = to_device_words(
                    _host_superblock(bm_b.packed, bm_b.n, cb, bm_b.n_words, b0 // cb), dev)
        yield b0, b_dev, min(bm_b.n - b0, cb)


def _chunk_k_check(k: int, cb: int) -> None:
    if k > cb:
        raise ValueError(
            f"k={k} exceeds the {cb}-row B chunk the device budget "
            f"allows: each chunk ranks only its own rows; reduce k or "
            f"raise STORMTPU_DEVICE_REFUSE_BUDGET_BYTES"
        )


def cross_topk_neighbors(
    a, b, k: int, *, measure: str = "count",
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per row of A, the top-k rows of B by exact intersection count.

    Returns (counts int32 [Na, k], indices int32 [Na, k]) sorted
    descending; counts are uniquely determined, the order among equal
    counts depends on the route. A and B are BitMatrices or {0,1} dense
    arrays over one bit universe.

    ``measure``: "count" or a similarity ("jaccard", "dice", "cosine",
    "overlap", "phi", "r2"): then (values float64 [Na, k], indices int32
    [Na, k]), exact: float32-ranked candidates with their integer counts
    come from the device, the host rescores them in float64, and a
    certification a chunk (the k-th candidate must clear the excluded
    columns' float32 bound plus slack) widens the candidate set until the
    true top-k is provably inside. Ties break toward the lower B index.
    """
    with profiling.span("stpu.cross.request") as request:
        with profiling.span("stpu.cross.plan"):
            bm_a, bm_b = _operands(a, b)
            cfg = config or default_config()
            cfg.validate(bm_a.m_bits)
            if not 1 <= k <= bm_b.n:
                raise ValueError(f"k must be in [1, Nb], got k={k}, Nb={bm_b.n}")
            dev = resolve_device(device)
            if measure == "count":
                w = bm_a.n_words
                bl, na_pad = _block_plan(bm_a.n)
                cb = _b_chunk_rows(bm_b.n, w, bl, na_pad, False, dev)
                _chunk_k_check(k, cb)
        request.add_ids(bm_a.n, bm_b.n)
        if measure != "count":
            return _cross_topk_measure(bm_a, bm_b, k, measure, dev)
        return _cross_topk_count(bm_a, bm_b, k, dev, bl, na_pad, cb)


def _cross_topk_count(bm_a, bm_b, k: int, dev, bl: int, na_pad: int, cb: int):
    """:func:`cross_topk_neighbors` by count, on the planned geometry."""
    from stormtpu_torch.stream_query import _merge_topk

    a_dev = bm_a.device_padded(na_pad, device=dev)
    best_v = np.full((na_pad, k), -1, dtype=np.int64)
    best_i = np.zeros((na_pad, k), dtype=np.int32)
    col = torch.arange(cb, device=dev)
    for b0, b_dev, nb_valid in _b_chunks(bm_b, cb, dev):
        for r0 in range(0, na_pad, bl):
            with _stage("kernel", dev):
                c = count_block_auto(a_dev[r0 : r0 + bl], b_dev)
            with _stage("merge", dev):
                v, i = torch.topk(torch.where(col < nb_valid, c, -1), k, dim=1)
                _merge_topk(best_v, best_i, slice(r0, r0 + bl),
                            download(v).astype(np.int64), download(i) + b0, k)
    best_v = best_v[: bm_a.n]
    best_i = best_i[: bm_a.n]
    order = np.argsort(-best_v, axis=1, kind="stable")
    vals = np.take_along_axis(best_v, order, axis=1)
    idx = np.take_along_axis(best_i, order, axis=1)
    # Nb >= k real columns exist, so every kept entry is a real count
    return vals.astype(np.int32), idx.astype(np.int32)


def _cross_topk_measure_block(a_blk, b_pad, nnz_a, nnz_b, nb_valid: int, m_f, *,
                              measure: str, kk: int):
    """Top-``kk`` candidate columns a row of A by float32 similarity, with
    their exact integer counts (for the float64 host rescore)."""
    from stormtpu_torch.query import _screen_vals

    dev = a_blk.device
    with _stage("kernel", dev):
        c = count_block_auto(a_blk, b_pad)
    with _stage("merge", dev):
        s = _screen_vals(c, nnz_a, nnz_b, m_f, measure)
        col = torch.arange(c.shape[1], device=dev)
        s = torch.where(col < nb_valid, s, -torch.inf)
        svals, idx = torch.topk(s, kk, dim=1)
        return svals, idx, c.gather(1, idx)


# Certification margin of the measure top-k: float32 screen values of the
# [0, 1] measures lie within ~1e-4 of the float64 truth (the screens'
# slack; phi/r2's inflated numerator keeps the score an over-estimate, so
# the bound holds one-sidedly there too). A column the device did not
# return scores ≤ s_cut in float32, so ≤ s_cut + slack in truth: a
# candidate set whose k-th float64 value clears that bound holds the true
# top-k.
_MEASURE_TOPK_SLACK = 2e-4


def _cross_topk_measure(bm_a, bm_b, k: int, measure: str, dev):
    """Certified-exact similarity top-k over the B-chunk walk: float32
    candidates on the device, the float64 rescore on the host, and per
    chunk a certification that doubles the candidate width until the
    boundary clears or the chunk is fully enumerated."""
    from stormtpu_torch.query import _validate_screen
    from stormtpu_torch.setops import derive_similarity

    _validate_screen(measure, 1.0)  # validates the measure name
    w = bm_a.n_words
    bl, na_pad = _block_plan(bm_a.n)
    cb = _b_chunk_rows(bm_b.n, w, bl, na_pad, False, dev)
    _chunk_k_check(k, cb)
    nb_walk = round_up(bm_b.n, cb)
    m_f = float(np.float32(bm_a.m_bits))
    a_dev = bm_a.device_padded(na_pad, device=dev)
    nnz_a_dev = bm_a.device_nnz(na_pad, device=dev)
    nnz_a_host = np.zeros(na_pad, dtype=np.int64)
    nnz_a_host[: bm_a.n] = bm_a.row_nnz
    nnz_b_pad = np.zeros(nb_walk, dtype=np.int64)
    nnz_b_pad[: bm_b.n] = bm_b.row_nnz
    kk0 = int(min(next_pow2(max(2 * k, k + 8)), cb))
    chunk_vals: list[np.ndarray] = []
    chunk_idx: list[np.ndarray] = []
    for b0, b_dev, nb_valid in _b_chunks(bm_b, cb, dev):
        nnz_b_host = torch.from_numpy(nnz_b_pad[b0 : b0 + cb].astype(np.int32))
        nnz_b_dev = profiling.upload(nnz_b_host, dev)
        kk = kk0
        while True:
            f_rows, g_rows, cut_rows = [], [], []
            for r0 in range(0, na_pad, bl):
                sv, ix, cv = _cross_topk_measure_block(
                    a_dev[r0 : r0 + bl], b_dev, nnz_a_dev[r0 : r0 + bl], nnz_b_dev,
                    nb_valid, m_f, measure=measure, kk=kk,
                )
                sv = download(sv)
                ix = download(ix).astype(np.int64)
                cv = download(cv)
                valid = sv > -np.inf
                f = derive_similarity(cv, nnz_a_host[r0 : r0 + bl, None],
                                      nnz_b_pad[b0 + ix], bm_a.m_bits, measure)
                f_rows.append(np.where(valid, f, -np.inf))
                g_rows.append(np.where(valid, ix + b0, np.int64(2**62)))
                cut_rows.append(sv[:, -1])
            f_all = np.concatenate(f_rows)
            g_all = np.concatenate(g_rows)
            s_cut = np.concatenate(cut_rows)
            order = np.lexsort((g_all, -f_all), axis=1)
            f_all = np.take_along_axis(f_all, order, axis=1)
            g_all = np.take_along_axis(g_all, order, axis=1)
            if nb_valid <= kk:
                break  # every valid column is a candidate
            # real rows must clear the exclusion bound at the k-th place
            real = np.arange(na_pad) < bm_a.n
            ok = f_all[:, k - 1] > s_cut + _MEASURE_TOPK_SLACK
            if bool(np.all(ok | ~real)) or kk >= cb:
                break
            kk = int(min(kk * 2, cb))
        chunk_vals.append(f_all[:, :k])
        chunk_idx.append(g_all[:, :k])
    # the global top-k lies in the union of the certified chunk lists;
    # ties break toward the lower global index
    f_m = np.concatenate(chunk_vals, axis=1)
    g_m = np.concatenate(chunk_idx, axis=1)
    order = np.lexsort((g_m, -f_m), axis=1)
    f_m = np.take_along_axis(f_m, order, axis=1)[: bm_a.n, :k]
    g_m = np.take_along_axis(g_m, order, axis=1)[: bm_a.n, :k]
    return f_m, g_m.astype(np.int32)


def cross_pairs_above(
    a,
    b,
    threshold: float,
    *,
    measure: str = "count",
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (i, j) with measure(A_i, B_j) ≥ threshold over the full Na×Nb
    rectangle (no triangle or self rule).

    measure: "count" (exact int32 counts) or a similarity ("jaccard",
    "dice", "cosine", "overlap", "phi", "r2": float64, exact host
    re-filter). Returns (ii, jj, values) in row-major order. The device
    packs the hits to a bitmap; the host downloads it and gathers the hit
    counts from the device-resident counts block."""
    from stormtpu_torch.query import (
        _expand_words,
        _gather_hit_words,
        _pack_bit_rows,
        _screen_vals,
        _validate_screen,
    )
    from stormtpu_torch.setops import derive_similarity

    with profiling.span("stpu.cross.request") as request:
        with profiling.span("stpu.cross.plan"):
            bm_a, bm_b = _operands(a, b)
            cfg = config or default_config()
            cfg.validate(bm_a.m_bits)
            dev_thresh = _validate_screen(measure, threshold)
            dev = resolve_device(device)
            w = bm_a.n_words
            bl, na_pad = _block_plan(bm_a.n)
            cb = _b_chunk_rows(bm_b.n, w, bl, na_pad, True, dev)
        request.add_ids(bm_a.n, bm_b.n)
        nb_walk = round_up(bm_b.n, cb)
        m_f = float(np.float32(bm_a.m_bits))
        a_dev = bm_a.device_padded(na_pad, device=dev)
        nnz_a_dev = bm_a.device_nnz(na_pad, device=dev)
        nnz_b_pad = np.zeros(nb_walk, dtype=np.int32)
        nnz_b_pad[: bm_b.n] = bm_b.row_nnz.astype(np.int32)
        thresh_d = torch.tensor(dev_thresh, dtype=torch.float32, device=dev)
        col = torch.arange(cb, device=dev)
        out_i: list[np.ndarray] = []
        out_j: list[np.ndarray] = []
        out_c: list[np.ndarray] = []
        for b0, b_dev, nb_valid in _b_chunks(bm_b, cb, dev):
            nnz_b = profiling.upload(torch.from_numpy(nnz_b_pad[b0 : b0 + cb]), dev)
            for r0 in range(0, na_pad, bl):
                with _stage("kernel", dev):
                    c = count_block_auto(a_dev[r0 : r0 + bl], b_dev)
                with _stage("screen", dev):
                    vals = _screen_vals(c, nnz_a_dev[r0 : r0 + bl], nnz_b, m_f, measure)
                    hits = _pack_bit_rows((vals >= thresh_d) & (col < nb_valid))
                    del vals
                with _stage("summary", dev):
                    li, lj = _expand_words(download(hits).view(np.uint32), nb_valid)
                if not li.size:
                    continue
                with _stage("gather", dev):
                    cvals = _gather_hit_words(c, li, lj)
                out_i.append((li + r0).astype(np.int64))
                out_j.append((lj + b0).astype(np.int64))
                out_c.append(cvals.astype(np.int64))
        if not out_i:
            empty_v = np.zeros(0, np.int32) if measure == "count" else np.zeros(0, np.float64)
            return np.zeros(0, np.int32), np.zeros(0, np.int32), empty_v
        ii = np.concatenate(out_i)
        jj = np.concatenate(out_j)
        counts = np.concatenate(out_c)
        keep = ii < bm_a.n  # padded A rows are all zero, dropped all the same
        ii, jj, counts = ii[keep], jj[keep], counts[keep]
        # chunked walks emit B-chunk-major order; the contract is row-major
        order = np.lexsort((jj, ii))
        ii, jj, counts = ii[order], jj[order], counts[order]
        if measure == "count":
            return ii.astype(np.int32), jj.astype(np.int32), counts.astype(np.int32)
        vals = derive_similarity(counts, bm_a.row_nnz[ii], bm_b.row_nnz[jj], bm_a.m_bits, measure)
        keep = vals >= threshold
        return ii[keep].astype(np.int32), jj[keep].astype(np.int32), vals[keep]
