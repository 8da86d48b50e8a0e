"""User-facing API of the port (``stormtpu/api.py``'s counterpart): build a
:class:`BitMatrix`, then call :func:`intersect_count_matrix` (all-pairs),
:func:`count_block` (cross counts) or :func:`pair_count` (one pair).

Every entry point takes ``device=None``, which means the CUDA card; it
raises ``RuntimeError`` when there is none, unless the caller passes
``device="cpu"``. Results are host values in the JAX package's layout:
numpy int32 N×N, numpy int32 [Na, Nb], a Python int.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.dispatch import PORTED, STRATEGIES, choose_strategy, dense_strategy
from stormtpu_torch.kernels import xla as kx
from stormtpu_torch.layout import BitMatrix, to_device_words
from stormtpu_torch.utils import resolve_device

__all__ = ["pair_count", "intersect_count_matrix", "count_block"]

MatrixLike = Union[BitMatrix, np.ndarray]

# the ROADMAP.md queue item each unported strategy waits on
_NOT_PORTED = {
    "sparse": "module queue: kernels/sparse.py K3",
    "sparse_outer": "module queue: kernels/sparse.py K4",
}


def _as_bitmatrix(x: MatrixLike) -> BitMatrix:
    if isinstance(x, BitMatrix):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32:
        raise TypeError(
            "raw uint32 arrays are ambiguous; wrap packed words with "
            "BitMatrix.from_packed(packed, m_bits=...)"
        )
    return BitMatrix.from_dense(x)


def pair_count(a: MatrixLike, b: MatrixLike, *, device=None) -> int:
    """Exact |A ∩ B| for two bitmaps (each a 1×M BitMatrix or {0,1} row)."""
    dev = resolve_device(device)
    bm_a = _as_bitmatrix(np.atleast_2d(a) if not isinstance(a, BitMatrix) else a)
    bm_b = _as_bitmatrix(np.atleast_2d(b) if not isinstance(b, BitMatrix) else b)
    if bm_a.n != 1 or bm_b.n != 1:
        raise ValueError(
            f"pair_count takes single bitmaps (got {bm_a.n} and {bm_b.n} "
            f"rows); use intersect_count_matrix / count_block for sets"
        )
    if bm_a.m_bits != bm_b.m_bits:
        raise ValueError("bit-universe mismatch")
    out = kx.pair_count_xla(
        to_device_words(bm_a.packed[0], dev), to_device_words(bm_b.packed[0], dev)
    )
    return int(out)


def intersect_count_matrix(
    x: MatrixLike,
    *,
    strategy: str = "auto",
    config: Optional[EngineConfig] = None,
    device=None,
) -> np.ndarray:
    """Exact N×N pairwise intersection-count matrix, numpy int32.

    ``strategy``: "auto" (D1 dispatch) or one of ``dispatch.STRATEGIES``.
    Explicitly requesting a strategy that is not ported yet (``sparse``,
    ``sparse_outer``) raises ``NotImplementedError``; "auto" never lands on
    one — where D1 names one, the dense choice for the shape runs instead
    (every strategy gives the same exact counts). Where D1 names
    ``"clustered"``, "auto" runs the K5 work list.
    """
    dev = resolve_device(device)
    bm = _as_bitmatrix(x)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    if strategy == "auto":
        strategy = choose_strategy(
            bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev
        )
        if strategy not in PORTED:
            strategy = dense_strategy(bm.n, bm.m_bits, cfg)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    if strategy not in PORTED:
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported to stormtpu_torch yet "
            f"(ROADMAP.md, {_NOT_PORTED[strategy]})"
        )
    from stormtpu_torch.stream import STREAM_NOT_PORTED, require_device_budget

    if strategy == "clustered":
        # K5 pads and caches its own operand and skips empty K-groups per
        # tile pair, which subsumes the global column compaction below. Its
        # device footprint is the padded operand plus the visited count
        # tiles, exact from the plan; a degenerate plan with set bits takes
        # the K2 walk and its N² output.
        from stormtpu_torch.kernels.clustered import (
            build_clustered_plan,
            count_matrix_clustered,
        )

        plan = build_clustered_plan(bm, cfg)
        if bm.n > 2 and (plan is not None or bm.nnz):
            if plan is None:
                need = 4 * bm.n * bm.n + 4 * bm.n * bm.n_words
                what = "the N² count matrix plus operand"
            else:
                need = 4 * plan.n_pad * plan.w_pad + 4 * plan.n_slots * plan.ti * plan.ti
                what = "the K5 operand plus work-list count tiles"
            require_device_budget(need, f"N={bm.n}: {what}", STREAM_NOT_PORTED, device=dev)
        return count_matrix_clustered(bm, config=cfg, plan=plan, device=dev)

    if bm.n > 2:
        # the N² int32 output plus the packed operand, on the device
        require_device_budget(
            4 * bm.n * bm.n + 4 * bm.n * bm.n_words,
            f"N={bm.n}: the N² count matrix plus operand",
            STREAM_NOT_PORTED,
            device=dev,
        )
    packed_np = bm.packed
    if bm.n > 1:
        # Clustered-sparsity compaction: drop all-empty word columns
        # (exact — empty words add nothing to AND counts).
        occupied = packed_np.any(axis=0)
        occ_frac = float(occupied.mean()) if occupied.size else 1.0
        if occ_frac < cfg.compact_occupancy_threshold:
            packed_np = np.ascontiguousarray(packed_np[:, occupied])
            if packed_np.shape[1] == 0:
                return np.zeros((bm.n, bm.n), dtype=np.int32)
    if packed_np is bm.packed:
        packed = bm.device_padded(bm.n, device=dev)
    else:
        packed = to_device_words(packed_np, dev)
    if strategy == "popcount":
        out = kx.count_matrix_popcount_xla(packed).cpu().numpy()
    elif strategy == "mxu":
        out = kx.count_matrix_int8_xla(packed).cpu().numpy()
    elif strategy == "pallas_dense":
        from stormtpu_torch.kernels.dense import count_matrix_pallas_dense

        out = count_matrix_pallas_dense(packed, config=cfg, variant=cfg.k1_variant)
    else:  # pallas_mxu
        from stormtpu_torch.kernels.mxu import count_matrix_pallas_mxu

        out = count_matrix_pallas_mxu(packed, config=cfg, variant=cfg.k2_variant)
    return out[: bm.n, : bm.n]


def count_block(
    a: MatrixLike,
    b: MatrixLike,
    *,
    config: Optional[EngineConfig] = None,
    device=None,
) -> np.ndarray:
    """Exact cross counts numpy int32 [Na, Nb] between two bitmap sets."""
    dev = resolve_device(device)
    bm_a = _as_bitmatrix(a)
    bm_b = _as_bitmatrix(b)
    if bm_a.m_bits != bm_b.m_bits:
        raise ValueError("bit-universe mismatch")
    cfg = config or default_config()
    cfg.validate(bm_a.m_bits)
    from stormtpu_torch.kernels import count_block_auto

    out = count_block_auto(
        bm_a.device_padded(bm_a.n, device=dev),
        bm_b.device_padded(bm_b.n, device=dev),
        config=cfg,
    )
    return out.cpu().numpy()
