"""Compute kernels of the port.

- ``xla``       — plain-torch paths (AND + popcount; int8 product of the
  unpacked operands) for small shapes and the CPU.
- ``mxu``       — K2: the tensor cores' binary product (AND + popcount)
  of the packed words (``csrc/k2_mxu.cu``), triangular and rectangular.
- ``clustered`` — K5: the block-clustered work list (planner, dispatch
  statistic, the host-side check and schedule, and a CUDA kernel on K2's
  tile body in ``csrc/k2_mxu.cu``).
- ``dense``     — K1 (AND + popcount tiles, on the same tile body:
  ``csrc/tile_body.cuh``) and K0 (row-wise pair stream, CUDA cores), in
  ``csrc/k1_dense.cu``.
- ``sparse``    — K3 (sorted-list intersections by ``torch.searchsorted``
  on the caller's device) and K4 (the inverted index: on a card its
  emission and mirror kernels, ``csrc/k4_sparse.cu``; on the CPU the C++
  tier ``stormtpu_torch.native``).
- ``screen``    — the streamed screen's compaction of a count stripe's hits
  into a bounded buffer (``csrc/stripe_screen.cu``).
"""

from __future__ import annotations

import torch

# The JAX package's routing constant: on the CPU, which no tuning cache
# names, D1, the streamed walks and the block kernels send M up to this many
# bits to the plain int8 product, so that both packages route alike there.
# An untuned card takes its own crossover below instead.
STATIC_MXU_XLA_MAX_BITS = 1 << 17
# The card's own ceiling for the plain int8 product (``xla.count_block_int8_xla``,
# which unpacks its operands 8x): the largest M at which it still beat the K2
# rectangle at 4096 x 4096 rows, timed by ``chip_smoke.py`` phase 29 at
# M = 2^13 ... 2^17 bits, or 0 where K2 won at every M. On an NVIDIA H100 80GB
# HBM3 at 700.00 W K2 won at every M, by 12x at 2^13 bits (0.071 against
# 0.853 ms) to 20x at 2^17 (0.614 against 12.38 ms; PERF.md §6). So on the card
# ``count_block_auto`` always takes K2, and a tuned winner "mxu" becomes
# "pallas_mxu".
MXU_XLA_MAX_BITS = 0

from stormtpu_torch import native  # noqa: E402
from stormtpu_torch.kernels import clustered, dense, mxu, screen, sparse  # noqa: E402
from stormtpu_torch.kernels.clustered import (  # noqa: E402
    ClusteredPlan,
    build_clustered_plan,
    count_matrix_clustered,
    count_tiles_worklist,
)
from stormtpu_torch.kernels.dense import (  # noqa: E402
    count_matrix_pallas_dense,
    count_tiles_pallas_dense,
    pair_count_stream_pallas,
)

__all__ = [
    "MXU_XLA_MAX_BITS",
    "STATIC_MXU_XLA_MAX_BITS",
    "ClusteredPlan",
    "build_clustered_plan",
    "count_block_auto",
    "count_matrix_clustered",
    "count_matrix_pallas_dense",
    "count_tiles_pallas_dense",
    "count_tiles_worklist",
    "launch_counts",
    "pair_count_stream_pallas",
    "plain_product_max_bits",
    "reset_launches",
]

_COUNTED = (mxu, clustered, dense, sparse, screen, native)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset, by kernel:
    on the card ``k2_tri``, ``k2_rect``, ``k2_topk``, ``k2_hist``, ``k5``,
    ``k1``, ``k0``, ``k3`` (a block of rows), ``k4`` (K4's emission
    kernel), ``k4_mirror`` and ``stripe_screen`` (the streamed screen's
    compaction); on the host ``k4_host`` (a run of the C++ K4, the CPU's
    route)."""
    out = {k: v for m in _COUNTED if m is not native for k, v in m.LAUNCHES.items()}
    out["k4_host"] = native.LAUNCHES["k4"]
    return out


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for m in _COUNTED:
        m.reset_launches()


def plain_product_max_bits(device=None) -> int:
    """The largest M at which the block kernels take the plain int8
    product on ``device`` (``None``: the card): ``MXU_XLA_MAX_BITS`` on a
    card, the JAX package's constant on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    return MXU_XLA_MAX_BITS if dev.type == "cuda" else STATIC_MXU_XLA_MAX_BITS


def count_block_auto(
    a_packed: torch.Tensor, b_packed: torch.Tensor, config=None
) -> torch.Tensor:
    """Rectangular cross counts int32 [Na, Nb] on the operands' device:
    the plain int8 product at small M, the K2 rectangle above
    :func:`plain_product_max_bits`."""
    from stormtpu_torch.kernels import xla as kx

    if a_packed.shape[1] * 32 <= plain_product_max_bits(a_packed.device):
        return kx.count_block_int8_xla(a_packed, b_packed)
    from stormtpu_torch.kernels.mxu import count_block_pallas_mxu

    return count_block_pallas_mxu(a_packed, b_packed, config=config)
