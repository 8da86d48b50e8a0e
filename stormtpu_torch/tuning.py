"""The port's K4 cost model (``stormtpu/tuning.py``'s ``K4_DEFAULTS`` and
``k4_constants`` only; the tuner itself is not ported).

D1 (``dispatch.choose_strategy``) and the streamed walk's per-stripe choice
(``stream._SparseStripePlan``) weigh K4 on the host against the dense K2
walk on the card with these constants. The choice never changes a count.
The values were measured on the card's host and the card by
``python3 scripts/torch_k4_constants.py`` (NVIDIA H100 80GB HBM3, 700 W;
PERF.md §6), never read from the JAX package's TPU snapshot:

- ``c_sort_s_per_nnz``: the sort-based unique (``kernels.sparse.unique_int64``)
  of random int64 keys, a key;
- ``c_n2_s_per_elem``: K4's N² int32 buffer at n = 10,000 (allocated and
  mirrored), an entry;
- ``c_emit_s_per_emission``: an end-to-end K4 run at 10,000 × 2²⁰ bits,
  density 1e-3, its remainder after the sort and N² terms over its
  emissions;
- ``k2_int8_ops_per_s``: n²·M over the K2 triangular kernel's time at
  BASELINE config 3 (10,000 × 1,048,576 bits), by CUDA events;
- ``dispatch_floor_s``: the wall time of a warm ``pallas_mxu`` call whose
  kernel does almost nothing (256 × 2²⁰ bits);
- ``h2d_bytes_per_s``: one superblock slice (4096 × 32,768 words) through
  the streamed walk's ``_SliceBuffer`` (the copy into its pinned buffer
  and the upload).
"""

from __future__ import annotations

__all__ = ["K4_DEFAULTS", "k4_constants"]

K4_DEFAULTS = {
    "c_sort_s_per_nnz": 2.53e-8,
    "c_n2_s_per_elem": 2.36e-9,
    "c_emit_s_per_emission": 1.37e-8,
    "k2_int8_ops_per_s": 6.56e15,
    "dispatch_floor_s": 0.0072,
    "h2d_bytes_per_s": 7.60e9,
}


def k4_constants() -> dict:
    """The K4 cost-model constants (a copy: callers may not change them)."""
    return dict(K4_DEFAULTS)
