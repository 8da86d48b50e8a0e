"""The port's LD clumping (``stormtpu_torch.clump``) against the JAX
package's on the CPU: ``clump_from_pairs`` on shared seeded pair lists
(duplicates, both orientations, self pairs, ties in ``stat``) and
``clump`` end to end over the r² screen of a panel with pairs in strong
LD. The grouping is deterministic, so leaders and assignment order are
compared exactly."""

import numpy as np
import pytest

import stormtpu
import stormtpu_torch as st


def _ld_panel(n, m, seed):
    """Odd rows copy the row before them with a tenth of the bits redrawn."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m)) < 0.3).astype(np.uint8)
    redraw = rng.random((n // 2, m)) < 0.1
    dense[1::2][: n // 2] = np.where(redraw, rng.random((n // 2, m)) < 0.3,
                                     dense[0::2][: n // 2])
    return dense


def _same(got, want):
    assert np.array_equal(got.leader, want.leader)
    assert np.array_equal(got.leaders, want.leaders)
    assert got.n_clumps == want.n_clumps
    assert np.array_equal(got.sizes(), want.sizes())
    for lead in want.leaders[:5]:
        assert np.array_equal(got.members(lead), want.members(lead))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clump_from_pairs_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    ii, jj = rng.integers(0, n, 600), rng.integers(0, n, 600)
    ii = np.r_[ii, jj[:50], 3, 3]  # reversed duplicates and a self pair
    jj = np.r_[jj, ii[:50], 3, 3]
    stat = rng.integers(0, 20, n).astype(np.float64)  # many ties
    got = st.clump_from_pairs(ii, jj, stat)
    _same(got, stormtpu.clump_from_pairs(ii, jj, stat))
    assert got.leader.dtype == got.leaders.dtype == np.int64
    assert np.all(got.leader[got.leaders] == got.leaders)


def test_clump_from_pairs_without_pairs_and_validation():
    got = st.clump_from_pairs([], [], [3.0, 1.0, 2.0])
    assert got.leaders.tolist() == [0, 2, 1] and got.leader.tolist() == [0, 1, 2]
    for fn in (st.clump_from_pairs, stormtpu.clump_from_pairs):
        with pytest.raises(ValueError, match="out of range"):
            fn([0], [5], [1.0, 2.0])
        with pytest.raises(ValueError, match="equal length"):
            fn([0, 1], [1], [1.0, 2.0])
        with pytest.raises(ValueError, match="entries for n"):
            fn([0], [1], [1.0, 2.0], n=3)


@pytest.mark.parametrize("measure,threshold", [("r2", 0.5), ("jaccard", 0.6)])
def test_clump_equals_jax(measure, threshold):
    dense = _ld_panel(120, 800, seed=3)
    stat = np.random.default_rng(4).random(120)
    got = st.clump(dense, stat, threshold, measure=measure, device="cpu")
    want = stormtpu.clump(dense, stat, threshold, measure=measure)
    _same(got, want)
    assert 1 < got.n_clumps < 120


def test_clump_refuses_a_stat_of_the_wrong_length():
    dense = _ld_panel(10, 64, seed=5)
    with pytest.raises(ValueError, match="one entry per row"):
        st.clump(dense, np.zeros(9), 0.5, device="cpu")
