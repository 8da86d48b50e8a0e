"""The plain reference against independent NumPy counts, and the
comparisons against hand-made answers."""

import numpy as np
import pytest
import torch

from portbench import generate
from portbench.reference import compare, counts, forms


def _panel(n=90, m=2048, seed=3):
    return generate.words_panel_host(seed, "panel", n, m, "cpu", rows=64)


def _numpy_counts(w, rows):
    return np.stack([np.bitwise_count(w[r] & w).sum(axis=1, dtype=np.int64) for r in rows])


@pytest.mark.parametrize("block_rows", [7, 1024])
def test_row_counts_exact(block_rows):
    w = _panel()
    rows = np.array([0, 5, 89])
    t = torch.from_numpy(w.view(np.int32))
    got = counts.row_counts(t[rows], [(0, t[:50]), (50, t[50:])], w.shape[0],
                            block_rows=block_rows)
    assert np.array_equal(got, _numpy_counts(w, rows))


def test_bfloat16_control_rounds_counts():
    w = _panel(m=8192)
    t = torch.from_numpy(w.view(np.int32))
    exact = counts.row_counts(t[:4], [(0, t)], w.shape[0])
    low = counts.row_counts(t[:4], [(0, t)], w.shape[0], "bfloat16")
    assert (low != exact).mean() > 0.5  # counts near 2048 lose their low bits


def test_pair_counts():
    w = _panel()
    i, j = np.array([1, 2, 3, 80]), np.array([4, 2, 70, 0])
    want = [int(np.bitwise_count(w[a] & w[b]).sum()) for a, b in zip(i, j)]
    assert counts.pair_counts(w, i, j, block=3).tolist() == want


def test_sparse_matrix_equals_dense_product():
    rows, pos = generate.positions_panel(9, "positions", 0, 120, 5000, 0.01, "cpu")
    dense = np.zeros((120, 5000), dtype=np.int64)
    dense[rows, pos] = 1
    got = counts.sparse_matrix(rows, pos, 120, "cpu").numpy()
    assert np.array_equal(got, dense @ dense.T)


def test_topk_comparison():
    c = np.array([[9, 5, 5, 3, 1], [2, 9, 4, 4, 4]], dtype=np.int64)
    rows = np.array([0, 1])
    v, i = forms.topk_of(c, rows, 2, self_pairs=False)
    assert compare.topk_rows_wrong(c, rows, v, i, 2, self_pairs=False) == 0
    # equal counts may come in either order
    assert compare.topk_rows_wrong(c, rows, np.array([[5, 5], [4, 4]]),
                                   np.array([[2, 1], [4, 2]]), 2, self_pairs=False) == 0
    # a wrong count, a partner whose count is not the one given, a repeat, the row itself
    for vv, ii in (([[5, 4], [4, 4]], [[1, 3], [2, 3]]),
                   ([[5, 5], [4, 4]], [[1, 3], [2, 3]]),
                   ([[5, 5], [4, 4]], [[1, 1], [2, 3]]),
                   ([[9, 5], [4, 4]], [[0, 1], [2, 3]])):
        assert compare.topk_rows_wrong(c, rows, np.array(vv), np.array(ii), 2,
                                       self_pairs=False) == 1


def test_screen_comparison():
    n, t = 6, 5
    full = np.array([[0, 5, 1, 7, 0, 0], [5, 0, 0, 0, 6, 0], [1, 0, 0, 0, 0, 5],
                     [7, 0, 0, 0, 0, 0], [0, 6, 0, 0, 0, 0], [0, 0, 5, 0, 0, 0]])
    hits = (np.array([0, 0, 1, 2]), np.array([1, 3, 4, 5]), np.array([5, 7, 6, 5]))
    ref = full[hits[0], hits[1]]
    rows = np.array([0, 4])
    assert compare.screen_wrong(hits, t, n, ref, rows, full[rows]) == (0, 0)
    missing = tuple(h[1:] for h in hits)  # (0, 1) touches row 0
    assert compare.screen_wrong(missing, t, n, ref[1:], rows, full[rows]) == (0, 1)
    bad = (hits[0], hits[1], hits[2] + np.array([0, 0, 0, 1]))
    assert compare.screen_wrong(bad, t, n, ref, rows, full[rows]) == (1, 0)
    dup = tuple(np.r_[h, h[:1]] for h in hits)
    assert compare.screen_wrong(dup, t, n, np.r_[ref, ref[:1]], rows, full[rows])[0] == 1
    got = forms.screen_hits(full[rows], rows, n, t)
    assert [x.tolist() for x in got] == [[0, 0, 1], [1, 3, 4], [5, 7, 6]]


def test_entries_wrong():
    a = np.arange(12).reshape(3, 4)
    b = a.copy()
    b[1, 2] += 1
    assert compare.entries_wrong(a, a) == 0
    assert compare.entries_wrong(b, a) == 1
    assert compare.entries_wrong(a[:2], a) == 12
