"""Derived pairwise set-operation cardinalities and similarity measures
(port of ``stormtpu/setops.py``).

For pairwise matrices every AND/OR/XOR/difference population count
follows from the intersection counts and the row cardinalities:

    |A ∪ B| = |A| + |B| − |A ∩ B|
    |A ⊕ B| = |A| + |B| − 2·|A ∩ B|
    |A \\ B| = |A| − |A ∩ B|

and so do the similarity coefficients of genotype screens: Jaccard,
Dice–Sørensen, Ochiai/cosine, overlap, the phi coefficient and the LD r²
(phi²). The card computes the one hard matrix (XXᵀ) with whichever kernel
D1 names; the rest is elementwise float64/int64 NumPy on the host, the
JAX package's formulas copied. The pairwise-complete forms (missing data)
add three count matrices of data and mask rows.

Every entry point takes ``device=None`` (the card) or ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stormtpu_torch.api import MatrixLike, _as_bitmatrix, intersect_count_matrix
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.utils import resolve_device

__all__ = [
    "pairwise_cardinality",
    "similarity_matrix",
    "similarity_matrix_complete",
    "pairs_above_complete",
    "column_counts",
    "CARD_OPS",
    "SIM_OPS",
]

CARD_OPS = ("intersect", "union", "xor", "andnot", "nand")
SIM_OPS = ("jaccard", "dice", "cosine", "overlap", "phi", "r2")


def pairwise_cardinality(
    x: MatrixLike,
    op: str = "intersect",
    *,
    strategy: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> np.ndarray:
    """N×N exact pairwise cardinality matrix for a bitwise set operation,
    int64.

    op: "intersect" |A∩B|, "union" |A∪B|, "xor" |A⊕B|,
        "andnot" |A\\B| (row minus column), "nand" M−|A∩B|.
    """
    if op not in CARD_OPS:
        raise ValueError(f"unknown op {op!r}; want one of {CARD_OPS}")
    bm = _as_bitmatrix(x)
    inter = intersect_count_matrix(bm, strategy=strategy, config=config,
                                   device=device).astype(np.int64)
    card = bm.row_nnz.astype(np.int64)
    return derive_cardinality(inter, card[:, None], card[None, :], bm.m_bits, op)


def derive_cardinality(inter, ca, cb, m_bits: int, op: str):
    """Exact set-op cardinality from intersection counts and row
    cardinalities (broadcastable int64 arrays)."""
    if op == "intersect":
        return inter
    if op == "union":
        return ca + cb - inter
    if op == "xor":
        return ca + cb - 2 * inter
    if op == "andnot":
        return ca - inter
    # nand: popcount(NOT(a AND b)) over the M-bit universe
    return np.int64(m_bits) - inter


def similarity_matrix(
    x: MatrixLike,
    measure: str = "jaccard",
    *,
    strategy: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> np.ndarray:
    """N×N float64 similarity from exact integer counts.

    jaccard = ∩/∪ · dice = 2∩/(|A|+|B|) · cosine = ∩/√(|A||B|) · overlap =
    ∩/min(|A|,|B|) · phi = (M·∩ − |A||B|) / √(|A||B|(M−|A|)(M−|B|)) · r2 =
    phi². Pairs whose denominator is 0 (a row empty or, for phi/r2, full)
    give 0.0.
    """
    if measure not in SIM_OPS:
        raise ValueError(f"unknown measure {measure!r}; want one of {SIM_OPS}")
    bm = _as_bitmatrix(x)
    inter = intersect_count_matrix(bm, strategy=strategy, config=config, device=device)
    card = bm.row_nnz
    return derive_similarity(inter, card[:, None], card[None, :], bm.m_bits, measure)


def similarity_matrix_complete(
    data: MatrixLike,
    mask: MatrixLike,
    measure: str = "r2",
    *,
    strategy: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> np.ndarray:
    """N×N float64 similarity over pairwise-complete observations.

    ``data``: indicator bitmaps with missing positions cleared; ``mask``:
    bit set where the position is observed. Per pair the statistic runs
    over the co-observed universe: m_ij = |mask_i ∩ mask_j|, ca_ij =
    |data_i ∩ mask_j|, cb_ij = |mask_i ∩ data_j|, ∩_ij = |data_i ∩ data_j|.
    Requires data ⊆ mask rowwise.
    """
    if measure not in SIM_OPS:
        raise ValueError(f"unknown measure {measure!r}; want one of {SIM_OPS}")
    bm_d, bm_m = _complete_operands(data, mask)
    from stormtpu_torch.api import count_block

    inter = intersect_count_matrix(bm_d, strategy=strategy, config=config, device=device)
    m_pair = intersect_count_matrix(bm_m, strategy=strategy, config=config, device=device)
    dm = count_block(bm_d, bm_m, config=config, device=device)  # |data_i ∩ mask_j|
    return derive_similarity(inter, dm, dm.T, m_pair, measure)


def _complete_operands(data: MatrixLike, mask: MatrixLike):
    """Validation of the pairwise-complete forms: identical shapes, and
    data ⊆ mask rowwise."""
    bm_d = _as_bitmatrix(data)
    bm_m = _as_bitmatrix(mask)
    if bm_d.n != bm_m.n or bm_d.m_bits != bm_m.m_bits:
        raise ValueError(
            f"data and mask must have identical shape; got "
            f"{bm_d.n}×{bm_d.m_bits} vs {bm_m.n}×{bm_m.m_bits}"
        )
    if np.any(bm_d.packed & ~bm_m.packed):
        raise ValueError(
            "data has set bits at unobserved (mask=0) positions; clear "
            "missing positions in data or fix the mask"
        )
    return bm_d, bm_m


def _complete_refine(bm_d, bm_m, ii, jj, measure: str, threshold: float):
    """Exact host re-derivation and float64 refine of pairwise-complete
    screen candidates: the four per-pair counts from the packed rows, then
    :func:`derive_similarity` over the co-observed universe, keeping
    values ≥ threshold."""
    pd, pm = bm_d.packed, bm_m.packed
    blk_h = max(1, (1 << 24) // max(bm_d.n_words, 1))
    inter_h = np.zeros(ii.size, dtype=np.int64)
    ca_h = np.zeros(ii.size, dtype=np.int64)
    cb_h = np.zeros(ii.size, dtype=np.int64)
    m_h = np.zeros(ii.size, dtype=np.int64)
    for o in range(0, ii.size, blk_h):
        s = slice(o, o + blk_h)
        di, dj = pd[ii[s]], pd[jj[s]]
        mi, mj = pm[ii[s]], pm[jj[s]]
        inter_h[s] = np.bitwise_count(di & dj).sum(axis=1, dtype=np.int64)
        ca_h[s] = np.bitwise_count(di & mj).sum(axis=1, dtype=np.int64)
        cb_h[s] = np.bitwise_count(mi & dj).sum(axis=1, dtype=np.int64)
        m_h[s] = np.bitwise_count(mi & mj).sum(axis=1, dtype=np.int64)
    vals = derive_similarity(inter_h, ca_h, cb_h, m_h, measure)
    keep = vals >= threshold
    return ii[keep].astype(np.int32), jj[keep].astype(np.int32), vals[keep]


def pairs_above_complete(
    data: MatrixLike,
    mask: MatrixLike,
    threshold: float,
    *,
    measure: str = "r2",
    block_rows: Optional[int] = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All unordered pairs (i < j) whose pairwise-complete measure is ≥
    ``threshold``: four count blocks a row block on the device (K2-rect
    through ``count_block_auto`` above ``plain_product_max_bits``), screened in float32 with
    the slack of ``query.pairs_above``; the candidates are re-derived
    exactly on the host (float64), so rounding only adds candidates.
    ``measure`` is a similarity ("count" does not depend on the mask: use
    ``pairs_above``)."""
    from stormtpu_torch.kernels import plain_product_max_bits
    from stormtpu_torch.query import (
        _complete_screen_block,
        _expand_word_coords,
        _expand_words,
        _fetch_hit_words,
        _validate_screen,
    )
    from stormtpu_torch.stream import require_device_budget
    from stormtpu_torch.utils import next_pow2, round_up

    if measure not in SIM_OPS:
        raise ValueError(
            f"unknown measure {measure!r}; want one of {SIM_OPS} "
            f"('count' does not depend on the mask — use pairs_above)"
        )
    dev_thresh = _validate_screen(measure, threshold)
    bm_d, bm_m = _complete_operands(data, mask)
    dev = resolve_device(device)
    n, w = bm_d.n, bm_d.n_words
    if n < 2:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float64))
    if block_rows is None:
        bl = min(4096, next_pow2(n))
    else:
        if block_rows < 1 or block_rows & (block_rows - 1):
            raise ValueError("block_rows must be a power of two")
        bl = block_rows
    n_pad = round_up(max(n, 32), max(bl, 32))
    need = 8 * n_pad * w           # two resident packed operands
    need += 20 * bl * n_pad        # 4 int32 count blocks + float32 values
    need += bl * n_pad // 8 * 2    # hit bitmap + its word summary
    if bm_d.m_bits <= plain_product_max_bits(dev):
        # the small-M plain int8 product unpacks both operands 8×
        need += 2 * (n_pad + bl) * bm_d.m_bits
    require_device_budget(
        need,
        f"N={n}: two resident operands (data+mask), four count blocks, "
        f"unpack buffers and the hit bitmap",
        "reduce the bit universe or screen via similarity_matrix_complete "
        "in row chunks",
        device=dev,
    )
    d_dev = bm_d.device_padded(n_pad, device=dev)
    m_dev = bm_m.device_padded(n_pad, device=dev)
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    for r0 in range(0, n_pad, bl):
        if r0 >= n:  # padded tail blocks have no real rows
            break
        hits_d, wsum_d = _complete_screen_block(
            d_dev, m_dev, r0, n, dev_thresh, measure=measure, bl=bl)
        wi_r, wi_w, words = _fetch_hit_words(hits_d, wsum_d, bl)
        if wi_r is None:
            li, lj = _expand_words(words, n)
        else:
            li, lj = _expand_word_coords(wi_r, wi_w, words, n)
        if not li.size:
            continue
        keep = (li + r0) < n
        out_i.append((li[keep] + r0).astype(np.int64))
        out_j.append(lj[keep].astype(np.int64))
    ii = np.concatenate(out_i) if out_i else np.zeros(0, np.int64)
    jj = np.concatenate(out_j) if out_j else np.zeros(0, np.int64)
    if not ii.size:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float64))
    return _complete_refine(bm_d, bm_m, ii, jj, measure, threshold)


def derive_similarity(inter, ca, cb, m_bits, measure: str):
    """float64 similarity from exact integer counts (broadcastable arrays):
    the one home of the similarity formulas. Zero denominators give 0.
    ``m_bits`` may be a scalar or a broadcastable array (the per-pair
    co-observed universe of :func:`similarity_matrix_complete`)."""
    inter = np.asarray(inter).astype(np.float64)
    ca = np.asarray(ca).astype(np.float64)
    cb = np.asarray(cb).astype(np.float64)
    if measure == "jaccard":
        denom = ca + cb - inter
    elif measure == "dice":
        inter = 2.0 * inter
        denom = ca + cb
    elif measure == "cosine":
        denom = np.sqrt(ca * cb)
    elif measure in ("phi", "r2"):
        m = np.asarray(m_bits).astype(np.float64)
        inter = m * inter - ca * cb
        denom = np.sqrt(ca * cb * (m - ca) * (m - cb))
        if measure == "r2":
            inter = inter * inter
            denom = denom * denom
    else:  # overlap
        denom = np.minimum(ca, cb)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0), 0.0)


def derive_similarity_torch(inter, ca, cb, m_bits, measure: str) -> torch.Tensor:
    """:func:`derive_similarity` on tensors, float64 on their device, equal
    to it bit for bit. On a card the formulas run as PyTorch operations in
    the same order: CUDA's double add, multiply, divide and square root
    round to nearest as IEEE 754 says, and each operation is a kernel of
    its own (nothing is contracted), so the bits are NumPy's. PyTorch's CPU
    square root and division are vectorized and can differ in the last
    bit, so CPU tensors go through NumPy. ``m_bits`` is a number or a
    broadcastable tensor."""
    if inter.device.type != "cuda":
        m = m_bits.numpy() if torch.is_tensor(m_bits) else m_bits
        return torch.from_numpy(derive_similarity(inter.numpy(), ca.numpy(), cb.numpy(), m,
                                                  measure))
    inter = inter.to(torch.float64)
    ca = ca.to(torch.float64)
    cb = cb.to(torch.float64)
    if measure == "jaccard":
        denom = ca + cb - inter
    elif measure == "dice":
        inter = 2.0 * inter
        denom = ca + cb
    elif measure == "cosine":
        denom = torch.sqrt(ca * cb)
    elif measure in ("phi", "r2"):
        m = m_bits.to(torch.float64) if torch.is_tensor(m_bits) else float(m_bits)
        inter = m * inter - ca * cb
        denom = torch.sqrt(ca * cb * (m - ca) * (m - cb))
        if measure == "r2":
            inter = inter * inter
            denom = denom * denom
    else:  # overlap
        denom = torch.minimum(ca, cb)
    pos = denom > 0
    return torch.where(pos, inter / torch.where(pos, denom, 1.0), 0.0)


def _column_partial(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-view words [N, C] → int32 [C·32] per-position counts in
    position order (bit b of word c is position 32·c + b): one masked
    shift and row sum a bit, on the words' device."""
    cols = [((words >> b) & 1).sum(dim=0, dtype=torch.int32) for b in range(32)]
    return torch.stack(cols, dim=1).reshape(-1)


def column_counts(
    x: MatrixLike,
    *,
    chunk_words: int = 4096,
    device=None,
) -> np.ndarray:
    """Per-position set-bit counts across rows, int32 [m_bits] — the
    positional popcount (allele counts, the column marginals of an LD
    screen). Word chunks of ``chunk_words`` go to the device and are
    reduced over rows there; exact int32 (counts ≤ N < 2³¹)."""
    dev = resolve_device(device)
    bm = _as_bitmatrix(x)
    w = bm.n_words
    out = np.empty(w * 32, dtype=np.int32)
    for c0 in range(0, w, chunk_words):
        chunk = to_device_words(bm.packed[:, c0 : c0 + chunk_words], dev)
        out[c0 * 32 : (c0 + chunk.shape[1]) * 32] = _column_partial(chunk).cpu().numpy()
    return out[: bm.m_bits]
