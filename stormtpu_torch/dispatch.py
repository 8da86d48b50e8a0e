"""D1 — density/shape-adaptive strategy dispatch (port of
``stormtpu/dispatch.py``).

A pure host decision over (N, M, density, device) that names a strategy.
It must be semantics-free: every strategy returns the identical exact
count matrix. The strategy names are the JAX package's.

Below ``sparse_density_threshold`` D1 names ``"sparse"`` (K3) on the CPU,
as the JAX package does off the TPU. On the card it weighs K4, which runs
there in its CUDA kernels (a build or launch failure raises), against the
dense K2 walk (:func:`k4_estimates`: both charged with their N² download,
K2 with its host work on the operand), and names ``"sparse_outer"`` when
K4 is cheaper, N ≤ 32768 and the C++ host tier is built (its extraction
serves a matrix without a COO cache; the NumPy one unpacks it).

The dense choice (:func:`dense_strategy`) is the measured winner of the
nearest tuned bucket where a tuning cache names the device
(``tuning.measured_dense_winner``), else the untuned rule: the plain int8
product up to ``kernels.plain_product_max_bits(device)`` — the card's own
crossover on a card, the JAX package's static constant on the CPU. The
K4 constants are the port's own: the cache's refit for the card, else
``tuning.K4_DEFAULTS`` (measured on an H100, K4's kernels and its host).

The block-clustered choice (``"clustered"``, K5) is made as the JAX
package makes it. ``"pallas_dense"`` (K1) runs when asked for; D1 never
picks it.
"""

from __future__ import annotations

from typing import Optional

import torch

from stormtpu_torch import native
from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels import plain_product_max_bits

__all__ = ["choose_strategy", "dense_strategy", "k4_estimates", "STRATEGIES"]

# every one of them runs in the port
STRATEGIES = (
    "popcount", "mxu", "pallas_dense", "pallas_mxu", "sparse",
    "sparse_outer", "clustered",
)


def dense_strategy(n: int, m_bits: int, config: Optional[EngineConfig] = None,
                   device=None) -> str:
    """The dense choice: ``popcount`` below an int8-tile of rows; else the
    measured winner of the tuned bucket nearest (n, m_bits) on ``device``
    (``None``: the card), where ``"mxu"`` above
    ``kernels.plain_product_max_bits`` becomes ``"pallas_mxu"``; untuned,
    the plain int8 product up to ``kernels.plain_product_max_bits(device)``
    and K2 above: on a card K2 at every M (the card's own crossover), on
    the CPU the JAX package's static rule."""
    from stormtpu_torch.tuning import measured_dense_winner

    cfg = config or default_config()
    if n < cfg.mxu_min_rows:
        return "popcount"
    winner = measured_dense_winner(n, m_bits, device)
    if winner is None:
        return "mxu" if m_bits <= plain_product_max_bits(device) else "pallas_mxu"
    if winner == "mxu" and m_bits > plain_product_max_bits(device):
        # the plain product unpacks 8x operands: K2 reads the packed words
        return "pallas_mxu"
    return winner


def k4_estimates(n: int, m_bits: int, density: float, device=None) -> tuple[float, float]:
    """Seconds D1 expects of (K4, the K2 walk) on ``device`` (``None``: the
    card) for an N×M matrix at ``density``, like for like: K4 sorts nnz
    keys, emits about nnz·N·density pairs, and zeroes, mirrors and
    downloads its N² matrix (``c_n2_s_per_elem``); K2 does N²·M at the
    measured rate plus the warm call's fixed cost, the same N² download,
    and its host work on the N·W packed words (the compaction scan and the
    upload)."""
    from stormtpu_torch.tuning import k4_constants

    fit = k4_constants(device)
    nnz = n * m_bits * density
    est_k4 = (fit["c_sort_s_per_nnz"] * nnz + fit["c_n2_s_per_elem"] * n * n
              + fit["c_emit_s_per_emission"] * nnz * n * density)
    est_k2 = (n * n * m_bits / fit["k2_int8_ops_per_s"] + fit["dispatch_floor_s"]
              + fit["c_download_s_per_elem"] * n * n
              + fit["c_k2_host_s_per_word"] * n * -(-m_bits // 32))
    return est_k4, est_k2


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
    if density < cfg.sparse_density_threshold and n >= 2:
        if on_cpu:
            return "sparse"
        from stormtpu_torch.kernels.sparse import K4_MAX_N

        if n <= K4_MAX_N and native.have_native():
            est_k4, est_k2 = k4_estimates(n, m_bits, density, device)
            if est_k4 < est_k2:
                return "sparse_outer"
    winner = dense_strategy(n, m_bits, cfg, device)
    if bm is not None and winner in ("mxu", "pallas_mxu"):
        from stormtpu_torch.kernels.clustered import clustered_work_fraction

        wf = clustered_work_fraction(bm, cfg)
        if wf is not None and wf < cfg.clustered_work_fraction_threshold:
            return "clustered"
    return winner
