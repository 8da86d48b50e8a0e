"""Engine configuration (PyTorch/CUDA port).

The same frozen knobs as ``stormtpu.config.EngineConfig``, field for
field, so that a configuration built for the JAX package can be handed to
the port unchanged (``layout.from_reference``). The tile defaults are the
JAX package's padding geometry: they fix the tile shapes the port's
kernels are handed (and so the layout of ``count_tiles_pallas_mxu``'s
output), and they are not tuned for the H100.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

WORD_BITS = 32      # packed word width: bit p lives in word p >> 5, bit p & 31


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen knobs for kernels, dispatch, and distribution.

    All sizes in elements unless noted. Every field of the JAX package's
    ``EngineConfig`` is kept, including those the port does not read yet
    (K3, mesh), so the two configurations round-trip.
    """

    # --- K1 tiles (AND + popcount: the ``pallas_dense`` strategy) ---
    k1_tile_rows: int = 128
    k1_tile_words: int = 2048
    k1_variant: str = "chunk"

    # --- K2 int8 XXᵀ kernel tiles ---
    k2_tile_rows: int = 256        # rows per output tile side
    k2_tile_words: int = 256       # packed words per K step → 8192 int8 K
    # the JAX package's two Pallas bodies; accepted for parity, no effect
    # on the port's results or on its CUDA kernel
    k2_variant: str = "planes"

    # --- D1 dispatch thresholds ---
    sparse_density_threshold: float = 0.001
    mxu_min_rows: int = 64         # tiny-N problems stay on the popcount path

    # --- K3 sparse path (not ported yet) ---
    k3_pair_block: int = 512

    # --- clustered-sparsity word compaction ---
    # Before dense all-pairs, drop word columns empty in EVERY row when
    # the occupied fraction is below this (exact: empty words contribute
    # nothing to AND counts).
    compact_occupancy_threshold: float = 0.9

    # --- K5 block-clustered dispatch statistic ---
    clustered_work_fraction_threshold: float = 0.5

    # --- distribution (not ported yet) ---
    mesh_axis: str = "rows"

    # --- safety ---
    # Counts are exact in int32 for M < 2^31; assert at config time.
    max_bits: int = 2**31 - 1

    def validate(self, m_bits: int) -> None:
        if m_bits > self.max_bits:
            raise ValueError(
                f"M={m_bits} bits exceeds exact-int32 accumulator range "
                f"({self.max_bits}); counts would not be exact."
            )


_DEFAULT: Optional[EngineConfig] = None


def default_config() -> EngineConfig:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = EngineConfig()
    return _DEFAULT
