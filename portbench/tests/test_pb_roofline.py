"""The work and roofline arithmetic against hand counts."""

import math

from portbench import roofline


def test_peaks():
    assert math.isclose(roofline.PEAK_B1_OPS, 1.5832e16, rel_tol=1e-4)
    assert roofline.PEAK_HBM_BYTES == 3.35e12


def test_topk16_stream_job():
    """100,000 rows of 2^20 bits: 4,999,950,000 pairs, 2·pairs·M =
    1.0486e16 bit-ops, 0.662 s at the b1 rate; the 13.1 GB panel and the
    12.8 MB answer 3.9 ms at the HBM rate: operations bound it."""
    n, m = 100_000, 1 << 20
    assert roofline.allpairs(n) == 4_999_950_000
    ops, nbytes = roofline.dense_allpairs_work(n, m, 8 * n * 16)
    assert math.isclose(ops, 1.0486e16, rel_tol=1e-4)
    assert nbytes == 13_107_200_000 + 12_800_000
    assert math.isclose(roofline.least_seconds(ops, nbytes), 0.6624, rel_tol=1e-3)
    assert ops / roofline.PEAK_B1_OPS > nbytes / roofline.PEAK_HBM_BYTES


def test_lookup64_request():
    """64 queries against 100,000 rows: 1.342e13 ops (0.85 ms) against
    13.1 GB of bytes (3.92 ms): memory bounds it."""
    ops, nbytes = roofline.dense_cross_work(64, 100_000, 1 << 20, 8 * 64 * 16)
    assert math.isclose(ops, 2 * 64 * 100_000 * 2**20)
    assert math.isclose(ops / roofline.PEAK_B1_OPS, 8.48e-4, rel_tol=1e-2)
    assert math.isclose(roofline.least_seconds(ops, nbytes), 3.915e-3, rel_tol=1e-3)
    assert ops / roofline.PEAK_B1_OPS < nbytes / roofline.PEAK_HBM_BYTES


def test_sparse_matrix_request():
    """10,000 rows from 1,048,576 positions: 8.4 MB in, 400 MB out,
    0.1219 ms at the HBM rate."""
    ops, nbytes = roofline.sparse_matrix_work(10_000, 1_048_576)
    assert ops == 0.0
    assert nbytes == 8 * 1_048_576 + 4 * 10_000**2
    assert math.isclose(roofline.least_seconds(ops, nbytes), 1.219e-4, rel_tol=1e-3)
