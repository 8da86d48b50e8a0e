"""The seeded inputs repeat exactly, and the screen's threshold is the
binomial tail it claims to be."""

import math

import numpy as np
import pytest
import torch

from portbench import generate

BIG = 2**33 + 12345  # seeds run past 32 bits


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_word_panels_repeat_and_chunks_remake_them(seed):
    a = generate.words_panel_host(seed, "panel", 700, 2048, "cpu", rows=256)
    b = generate.words_panel_host(seed, "panel", 700, 2048, "cpu", rows=256)
    assert np.array_equal(a, b)
    again = generate.words_chunk(seed, "panel", 2, 700 - 512, 2048, "cpu")
    assert np.array_equal(a[512:].view(np.int32), again.numpy())
    other = generate.words_panel_host(seed + 1, "panel", 700, 2048, "cpu", rows=256)
    assert not np.array_equal(a, other)
    assert abs(np.bitwise_count(a).mean() / 32 - 0.5) < 0.01


def test_position_panels_repeat_and_differ_by_index():
    a = generate.positions_panel(BIG, "positions", 0, 300, 1 << 20, 1e-4, "cpu")
    b = generate.positions_panel(BIG, "positions", 0, 300, 1 << 20, 1e-4, "cpu")
    c = generate.positions_panel(BIG, "positions", 1, 300, 1 << 20, 1e-4, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert a[0].size == generate.position_count(300, 1 << 20, 1e-4) == 31457
    assert a[0].max() < 300 and a[1].max() < (1 << 20)


def test_pick_repeats_and_is_distinct():
    x = generate.pick(BIG, "check_rows", 100_000, 256)
    assert np.array_equal(x, generate.pick(BIG, "check_rows", 100_000, 256))
    assert np.unique(x).size == 256 and x.max() < 100_000
    assert not np.array_equal(x, generate.pick(BIG + 1, "check_rows", 100_000, 256))


def _tail(trials, p, t):
    lp, lq = math.log(p), math.log1p(-p)
    return sum(math.exp(math.lgamma(trials + 1) - math.lgamma(x + 1)
                        - math.lgamma(trials - x + 1) + x * lp + (trials - x) * lq)
               for x in range(t, trials + 1))


def test_screen_threshold_of_config_4():
    """t for Binomial(2^20, 1/4) at a 1e-6 tail: about mean + 4.75 sd, and
    the least count whose tail holds no more than 1e-6."""
    m = 1 << 20
    t = generate.binomial_upper_threshold(m, 0.25, 1e-6)
    mean, sd = m / 4, math.sqrt(m * 3 / 16)
    assert abs((t - mean) / sd - 4.753) < 0.05  # the normal quantile of 1e-6
    assert 264_200 < t < 264_300
    small = 4096
    ts = generate.binomial_upper_threshold(small, 0.25, 1e-3)
    assert _tail(small, 0.25, ts) <= 1e-3 < _tail(small, 0.25, ts - 1)


def test_pairs_a_job_expect_about_5000_hits():
    m = 1 << 20
    t = generate.binomial_upper_threshold(m, 0.25, 1e-6)
    pairs = 100_000 * 99_999 // 2
    sd = math.sqrt(m * 3 / 16)
    # the normal tail at the threshold's continuity-corrected z
    z = (t - 0.5 - m / 4) / sd
    expect = pairs * 0.5 * math.erfc(z / math.sqrt(2))
    assert 3_500 < expect <= 5_000 * 1.05
