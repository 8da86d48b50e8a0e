"""The yardstick of the kernels: the work a cell's output needs, counted
from its shapes, and the published peaks of one NVIDIA H100 SXM5 it is
held to.

- ``PEAK_B1_OPS``: the b1 AND+popcount rate of the tensor cores, 8 × the
  published dense int8 rate of 1,979 TOP/s (a b1 ``wgmma`` takes eight
  times the K of an s8 one in the same issue slot): 1.583e16 bit-op/s.
  ``tc_rate.cu`` measured 1.55–1.57e16 on the card at 700 W.
- ``PEAK_HBM_BYTES``: 3.35e12 B/s, the published HBM3 bandwidth.

Both assume the full 700 W power limit; the run prints the card's
``power.limit`` beside them.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1.979e15
PEAK_B1_OPS = 8 * PEAK_INT8_OPS
PEAK_HBM_BYTES = 3.35e12
PEAKS = {"b1_ops_per_s": PEAK_B1_OPS, "hbm_bytes_per_s": PEAK_HBM_BYTES,
         "source": "NVIDIA H100 SXM5 data sheet: int8 1,979 TOP/s dense (b1 = 8x), HBM3 3.35 TB/s"}


def allpairs(n: int) -> int:
    """Unordered pairs i < j of an N-row panel: what an all-pairs output needs."""
    return n * (n - 1) // 2


def pair_ops(pairs: int, m_bits: int) -> float:
    """Bit operations of ``pairs`` exact counts over M bits: an AND and an
    add a bit, 2·pairs·M."""
    return 2.0 * pairs * m_bits


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    its operations at the b1 rate and its bytes at the HBM rate."""
    return max(ops / PEAK_B1_OPS, nbytes / PEAK_HBM_BYTES)


def dense_allpairs_work(n: int, m_bits: int, out_bytes: int) -> tuple[float, float]:
    """(ops, bytes) of one pass over an N-row panel's unordered pairs: the
    packed panel read once, the output written once."""
    return pair_ops(allpairs(n), m_bits), n * (m_bits // 8) + out_bytes


def dense_cross_work(na: int, nb: int, m_bits: int, out_bytes: int) -> tuple[float, float]:
    """(ops, bytes) of Na × Nb exact counts: both panels read once, the
    output written once."""
    return pair_ops(na * nb, m_bits), (na + nb) * (m_bits // 8) + out_bytes


def sparse_matrix_work(n: int, positions: int) -> tuple[float, float]:
    """(ops, bytes) of an exact N×N matrix from ``positions`` set bits: the
    positions read once (a 4-byte row and a 4-byte column each) and the
    int32 matrix written once. The product of co-occurring positions is a
    few million adds, counted as no operations: bytes bound it."""
    return 0.0, 8 * positions + 4 * n * n
