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
from stormtpu_torch.dispatch import STRATEGIES, choose_strategy
from stormtpu_torch.kernels import xla as kx
from stormtpu_torch.layout import BitMatrix, to_device_words
from stormtpu_torch.utils import (
    download,
    profiling,
    resolve_device,
    round_up,
    triangular_assembly_bytes,
)

__all__ = ["pair_count", "intersect_count_matrix", "count_block"]

MatrixLike = Union[BitMatrix, np.ndarray]


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


def _walk_bytes(n: int, w: int, tile_shape) -> int:
    """Device bytes of a triangular tile walk over an n × w-word matrix
    with ``tile_shape(n, w) -> (tile_rows, tile_words)``: the padded
    operand, the tile stack and the matrix assembled beside it."""
    ti, wk = tile_shape(n, w)
    nb = round_up(n, ti) // ti
    return 4 * nb * ti * round_up(w, wk) + triangular_assembly_bytes(
        nb * (nb + 1) // 2, ti, nb, n
    )


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

    ``strategy``: "auto" (D1 dispatch) or one of ``dispatch.STRATEGIES``;
    every strategy gives the same exact counts. ``"sparse_outer"`` (K4)
    runs on ``device``: on a card in its CUDA kernels (a build or launch
    failure raises), on the CPU in the C++ host tier. It refuses
    N > 32768 (``ValueError``); on the CPU, where K4's NumPy fallback
    refuses (no C++ tier), the K2 walk runs instead. ``"sparse"`` (K3)
    runs on ``device``.

    Host memory: on the card, the tile-walk strategies (``pallas_mxu``,
    ``pallas_dense``, ``clustered``) return an array that lives in a
    page-locked buffer (``utils.download``). The results a caller holds at
    once take at most ``utils.tiling.PINNED_RESULT_BYTES_MAX`` (2 GiB) of
    page-locked memory, further ones are ordinary pageable arrays, and a
    released buffer stays page-locked in PyTorch's host cache for reuse.
    """
    with profiling.span("stpu.api.intersect_count_matrix"):
        dev = resolve_device(device)
        bm = _as_bitmatrix(x)
        cfg = config or default_config()
        cfg.validate(bm.m_bits)
        if strategy == "auto":
            with profiling.span("stpu.dispatch.route"):
                strategy = choose_strategy(
                    bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev
                )
            profiling.count(f"dispatch.{strategy}")
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
        from stormtpu_torch.stream import require_device_budget

        stream_hint = (
            "use stormtpu_torch.stream.stream_count_matrix (resumable stripes; "
            "kernel='auto' keeps the clustered skip), or the "
            "stormtpu_torch.stream_query reduced queries"
        )

        if strategy == "sparse_outer":
            # no compaction scan and no upload of the packed words
            from stormtpu_torch.kernels.sparse import check_k4_rows, count_matrix_sparse_outer

            # an explicit request must see K4's refusal, not a multi-GB dense
            # matrix in its place
            check_k4_rows(bm.n)
            if dev.type == "cuda":
                if bm.n > 2:
                    # on the card together: the N² int32 output and the sorted
                    # keys with their transients (about 32 bytes a nonzero)
                    require_device_budget(
                        4 * bm.n * bm.n + 32 * bm.nnz,
                        f"N={bm.n}: K4's N² count matrix and its sorted keys", stream_hint,
                        device=dev)
                return count_matrix_sparse_outer(bm, config=cfg, device=dev)
            try:
                return count_matrix_sparse_outer(bm, config=cfg, device=dev)
            except ValueError:
                # the NumPy fallback's capacity refusals (no C++ tier): every
                # strategy is exact, so the K2 walk takes over
                strategy = "pallas_mxu"

        if strategy == "clustered":
            # K5 pads and caches its own operand and skips empty K-groups per
            # tile pair, which subsumes the global column compaction below. Its
            # device footprint is the padded operand, the visited count tiles
            # and the matrix assembled beside them, exact from the plan; a
            # degenerate plan with set bits takes the K2 walk.
            from stormtpu_torch.kernels.clustered import (
                build_clustered_plan,
                count_matrix_clustered,
            )
            from stormtpu_torch.kernels.mxu import k2_tile_shape

            plan = build_clustered_plan(bm, cfg)
            if bm.n > 2 and (plan is not None or bm.nnz):
                if plan is None:
                    need = _walk_bytes(bm.n, bm.n_words, lambda n, w: k2_tile_shape(cfg, n, w))
                    what = "the operand, the K2 count tiles and the N² count matrix"
                else:
                    need = 4 * plan.n_pad * plan.w_pad + triangular_assembly_bytes(
                        plan.n_slots, plan.ti, plan.nb, bm.n
                    )
                    what = "the K5 operand, the work-list count tiles and the N² count matrix"
                require_device_budget(need, f"N={bm.n}: {what}", stream_hint, device=dev)
            return count_matrix_clustered(bm, config=cfg, plan=plan, device=dev)

        if strategy == "sparse":
            from stormtpu_torch.kernels.sparse import K3_BYTES_PER_LOOKUP, count_matrix_sparse

            if bm.n > 2:
                # on the device together: the position lists, the N² int32
                # output and at least one row's block of lookups
                l_pad = round_up(max(int(bm.row_nnz.max()), 1), 128)
                need = 4 * bm.n * l_pad + 4 * bm.n * bm.n + K3_BYTES_PER_LOOKUP * bm.n * l_pad
                require_device_budget(
                    need, f"N={bm.n}: the K3 position lists, the N² count matrix and "
                    "one row block of lookups", stream_hint, device=dev)
            return count_matrix_sparse(bm, config=cfg, device=dev)

        if bm.n > 2:
            # on the device together: the packed operand and the N² int32
            # output, and on the tile walks the tile stack it is assembled from
            if strategy == "pallas_mxu":
                from stormtpu_torch.kernels.mxu import k2_tile_shape

                need = _walk_bytes(bm.n, bm.n_words, lambda n, w: k2_tile_shape(cfg, n, w))
                what = "the operand, the K2 count tiles and the N² count matrix"
            elif strategy == "pallas_dense":
                from stormtpu_torch.kernels.dense import k1_tile_shape

                need = _walk_bytes(bm.n, bm.n_words, lambda n, w: k1_tile_shape(cfg, n, w))
                what = "the operand, the K1 count tiles and the N² count matrix"
            else:
                need = 4 * bm.n * bm.n + 4 * bm.n * bm.n_words
                what = "the N² count matrix plus operand"
            require_device_budget(need, f"N={bm.n}: {what}", stream_hint, device=dev)
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
    """Exact cross counts numpy int32 [Na, Nb] between two bitmap sets.
    On the card the result is downloaded into page-locked memory, as the
    tile-walk results are (``utils.download``)."""
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
    return download(out)
