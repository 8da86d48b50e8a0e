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
  on the caller's device) and K4 (the inverted index, on the host in the
  C++ tier ``stormtpu_torch.native``).
"""

from __future__ import annotations

import torch

# Above this many bits, materializing the 8× unpacked int8 operand (the
# ``mxu`` strategy) is memory-hostile; use the K2 kernel. The JAX
# package's routing constant, kept so both packages route alike.
MXU_XLA_MAX_BITS = 1 << 17

from stormtpu_torch import native  # noqa: E402
from stormtpu_torch.kernels import clustered, dense, mxu, sparse  # noqa: E402
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
    "ClusteredPlan",
    "build_clustered_plan",
    "count_block_auto",
    "count_matrix_clustered",
    "count_matrix_pallas_dense",
    "count_tiles_pallas_dense",
    "count_tiles_worklist",
    "launch_counts",
    "pair_count_stream_pallas",
    "reset_launches",
]

_COUNTED = (mxu, clustered, dense, sparse, native)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset, by kernel:
    on the card ``k2_tri``, ``k2_rect``, ``k5``, ``k1``, ``k0`` and ``k3``
    (a block of rows), on the host ``k4`` (a run of the C++ K4)."""
    return {k: v for m in _COUNTED for k, v in m.LAUNCHES.items()}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for m in _COUNTED:
        m.reset_launches()


def count_block_auto(
    a_packed: torch.Tensor, b_packed: torch.Tensor, config=None
) -> torch.Tensor:
    """Rectangular cross counts int32 [Na, Nb] on the operands' device:
    the plain int8 product at small M, the K2 rectangle above
    ``MXU_XLA_MAX_BITS``."""
    from stormtpu_torch.kernels import xla as kx

    if a_packed.shape[1] * 32 <= MXU_XLA_MAX_BITS:
        return kx.count_block_int8_xla(a_packed, b_packed)
    from stormtpu_torch.kernels.mxu import count_block_pallas_mxu

    return count_block_pallas_mxu(a_packed, b_packed, config=config)
