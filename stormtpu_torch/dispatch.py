"""D1 — density/shape-adaptive strategy dispatch (port of
``stormtpu/dispatch.py``).

A pure host decision over (N, M, density, device) that names a strategy.
It must be semantics-free: every strategy returns the identical exact
count matrix. The strategy names are the JAX package's.

Differences from the JAX package, all temporary (ROADMAP.md):

- no measured tuning table and no K4 cost fit is consulted — the port has
  measured neither on its card yet;
- on CUDA, the density < ``sparse_density_threshold`` branch falls
  through to the dense choice until K3/K4 are ported (on the CPU it
  returns ``"sparse"``, as the JAX package does off the TPU).

The block-clustered choice (``"clustered"``, K5) is made as the JAX
package makes it, and runs: ``"auto"`` takes it on the card and on the
CPU. ``"pallas_dense"`` (K1) runs when asked for; D1 never picks it.
"""

from __future__ import annotations

from typing import Optional

import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels import MXU_XLA_MAX_BITS

__all__ = ["choose_strategy", "dense_strategy", "STRATEGIES", "PORTED"]

STRATEGIES = (
    "popcount", "mxu", "pallas_dense", "pallas_mxu", "sparse",
    "sparse_outer", "clustered",
)

# strategies the port can run; the rest name their ROADMAP item
PORTED = ("popcount", "mxu", "pallas_dense", "pallas_mxu", "clustered")


def dense_strategy(n: int, m_bits: int, config: Optional[EngineConfig] = None) -> str:
    """The dense choice by shape alone: ``popcount`` below an int8-tile of
    rows, the plain int8 product up to ``MXU_XLA_MAX_BITS``, else K2."""
    cfg = config or default_config()
    if n < cfg.mxu_min_rows:
        return "popcount"
    return "mxu" if m_bits <= MXU_XLA_MAX_BITS else "pallas_mxu"


def choose_strategy(
    n: int,
    m_bits: int,
    density: float,
    config: Optional[EngineConfig] = None,
    *,
    bm=None,
    device=None,
) -> str:
    """Pick the all-pairs strategy for an N×M bit matrix on ``device``
    (``None`` means the card; the device need not be present — this only
    names a strategy).

    ``bm``: the BitMatrix itself, when available — enables the
    block-summary co-occupancy statistic that names block-clustered
    inputs ``"clustered"``. Scalar-only calls never choose it.
    """
    cfg = config or default_config()
    cfg.validate(m_bits)
    on_cpu = torch.device("cuda" if device is None else device).type == "cpu"
    if density < cfg.sparse_density_threshold and n >= 2 and on_cpu:
        return "sparse"
    winner = dense_strategy(n, m_bits, cfg)
    if bm is not None and winner in ("mxu", "pallas_mxu"):
        from stormtpu_torch.kernels.clustered import clustered_work_fraction

        wf = clustered_work_fraction(bm, cfg)
        if wf is not None and wf < cfg.clustered_work_fraction_threshold:
            return "clustered"
    return winner
