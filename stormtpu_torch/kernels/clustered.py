"""The D1 half of K5's planner (port of ``stormtpu/kernels/clustered.py``
``_block_occupancy`` and ``clustered_work_fraction``): the pure-NumPy
co-occupancy statistic that tells dispatch an input is block-clustered.
The K5 work-list kernel itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stormtpu_torch.config import WORD_BITS, EngineConfig, default_config
from stormtpu_torch.kernels.mxu import k2_tile_shape
from stormtpu_torch.utils import round_up

__all__ = ["clustered_work_fraction"]


def _block_occupancy(bm, cfg: EngineConfig):
    """Per-tile-block K-group occupancy bool [nb, ng] (+ tile geometry),
    cached on the BitMatrix. None when ng < 2 (a single K-group: the
    summary cannot skip anything)."""
    n, w = bm.n, bm.n_words
    if n == 0 or w == 0:
        return None
    ti, wk = k2_tile_shape(cfg, n, w)
    ng = -(-w // wk)
    if ng < 2:
        return None
    cache = bm.__dict__.setdefault("_occ_cache", {})
    key = (ti, wk)
    hit = cache.get(key)
    if hit is None:
        n_pad = round_up(n, ti)
        nb = n_pad // ti
        occ_rows = bm.block_summary(block_bits=wk * WORD_BITS).astype(bool)
        occ = np.zeros((nb * ti, ng), dtype=bool)
        occ[:n] = occ_rows
        occ = occ.reshape(nb, ti, ng).any(axis=1)  # [nb, ng]
        hit = (occ, ti, wk, n_pad, nb, ng)
        cache[key] = hit
    return hit


def clustered_work_fraction(
    bm, config: Optional[EngineConfig] = None
) -> Optional[float]:
    """Fraction of (upper-triangular tile pair, K-group) cells whose
    summaries co-occupy — K5's work relative to the full K2 walk. None
    where the skip is inapplicable (single K-group)."""
    cfg = config or default_config()
    geo = _block_occupancy(bm, cfg)
    if geo is None:
        return None
    occ, ti, wk, n_pad, nb, ng = geo
    ibs_t, jbs_t = np.triu_indices(nb)
    co = occ[ibs_t] & occ[jbs_t]
    return float(co.sum()) / float(ibs_t.size * ng)
