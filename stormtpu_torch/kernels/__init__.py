"""Compute kernels of the port.

- ``xla``       — plain-torch paths (AND + popcount; int8 product of the
  unpacked operands) for small shapes and the CPU.
- ``mxu``       — K2: int8 tensor-core product with the bit unpack fused
  into the CUDA kernel (``csrc/k2_mxu.cu``), triangular and rectangular.
- ``clustered`` — the dispatch statistic of the block-clustered regime.
"""

from __future__ import annotations

import torch

# Above this many bits, materializing the 8× unpacked int8 operand (the
# ``mxu`` strategy) is memory-hostile; use the K2 kernel. The JAX
# package's routing constant, kept so both packages route alike.
MXU_XLA_MAX_BITS = 1 << 17

__all__ = ["MXU_XLA_MAX_BITS", "count_block_auto"]


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
