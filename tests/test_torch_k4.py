"""K4's kernel forms (``stormtpu_torch.kernels.sparse.k4_emit`` /
``k4_mirror``, CUDA kernels in ``csrc/k4_sparse.cu``) through their plain
PyTorch versions on the CPU, against the JAX package's K4 on shared seeded
inputs: the single-shot matrix (``count_matrix_sparse_outer``, the card's
route ``_k4_matrix`` run on CPU tensors) and the streamed walk's stripes
(``_SparseStripePlan.stripe_counts``), the emission counts the kernel's
prefix holds, the wrappers' refusals, and D1's choice at config 3's two
versions under the card's constants. Counts are integers: every
comparison is exact (tolerance 0). The kernels themselves run in
``tests/test_torch_cuda.py`` (marker ``cuda``)."""

import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.kernels.sparse as jsp
import stormtpu.stream as js
import stormtpu_torch as st
import stormtpu_torch.kernels.sparse as tsp
import stormtpu_torch.stream as ts
from stormtpu_torch.oracle import oracle_count_matrix

CPU = torch.device("cpu")


def _positions(name):
    """(row ids, positions, n, m_bits): test_torch_sparse's cases and the
    ones this kernel adds. Every case with positions repeats some of them
    (packing ORs duplicates, so counts must de-duplicate)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "uniform":
        n, m, k = 70, 3000, 900
        rows, pos = rng.integers(0, n, k), rng.integers(0, m, k)
    elif name == "empty_rows":
        n, m = 40, 2048
        rows, pos = rng.choice(np.arange(0, n, 3), 300), rng.integers(0, m, 300)
    elif name == "one_row":
        n, m = 1, 500
        rows, pos = np.zeros(40, np.int64), rng.integers(0, m, 40)
    elif name == "two_rows":
        n, m = 2, 777
        rows, pos = rng.integers(0, n, 120), rng.integers(0, m, 120)
    elif name == "full_column":
        n, m = 50, 1500
        rows = np.r_[np.arange(n), rng.integers(0, n, 200)]
        pos = np.r_[np.full(n, 5), rng.integers(0, m, 200)]
    elif name == "all_empty":
        n, m = 9, 300
        rows = pos = np.zeros(0, np.int64)
    elif name == "every_row_one_column":
        # one column in every row and nothing else: the most contention
        n, m = 257, 64
        rows, pos = np.arange(n), np.full(n, 17)
    elif name.startswith("n"):
        n, m = int(name[1:]), 4096
        k = 6 * n + 10
        rows, pos = rng.integers(0, n, k), rng.integers(0, m // 8, k)
    else:
        raise KeyError(name)
    rows, pos = np.asarray(rows, np.int64), np.asarray(pos, np.int64)
    if rows.size:
        rows, pos = np.r_[rows, rows[::5]], np.r_[pos, pos[::5]]
    return rows, pos, n, m


SINGLE = ("uniform", "empty_rows", "one_row", "two_rows", "full_column", "all_empty",
          "every_row_one_column", "n2", "n3", "n33", "n257")


def _single_shot_plain(bt):
    """What the card computes, on CPU tensors (each kernel's plain version)."""
    if bt.n < 2:
        return tsp.count_matrix_sparse_outer(bt, device="cpu")
    return tsp._k4_matrix(bt, CPU).numpy()


@pytest.mark.parametrize("packed", (False, True), ids=("coo", "packed"))
@pytest.mark.parametrize("name", SINGLE)
def test_single_shot_plain_forms_equal_jax(name, packed):
    rows, pos, n, m = _positions(name)
    bj = stormtpu.BitMatrix.from_positions(rows, pos, n, m)
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    if packed:  # no COO cache: the positions come from the packed words
        bt = st.BitMatrix.from_packed(bt.packed, m)
        assert bt.coo is None
    got = _single_shot_plain(bt)
    want = jsp.count_matrix_sparse_outer(bj)
    assert got.dtype == want.dtype == np.int32 and got.shape == (n, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bt.packed))


def test_emission_and_mirror_forms_on_a_hand_made_list():
    # columns 0 (rows 1, 4, 6), 3 (rows 0, 6) and 9 (row 2 alone)
    rows = torch.tensor([1, 4, 6, 0, 6, 2], dtype=torch.int32)
    off = torch.tensor([0, 3], dtype=torch.int64)
    lens = torch.tensor([3, 2], dtype=torch.int64)
    diag = torch.tensor([1, 1, 1, 0, 1, 0, 2], dtype=torch.int32)
    got = tsp.k4_square(rows, off, lens, 7, diag)
    want = np.zeros((7, 7), np.int32)
    for a, b in ((1, 4), (1, 6), (4, 6), (0, 6)):
        want[a, b] = want[b, a] = 1
    want[np.arange(7), np.arange(7)] = diag.numpy()
    assert np.array_equal(got.numpy(), want)
    # the rectangle form: every (x, y) of a shared column's two runs
    rect = tsp.k4_rect(torch.tensor([0, 2, 1], dtype=torch.int32),
                       torch.tensor([0, 2], dtype=torch.int64),
                       torch.tensor([2, 1], dtype=torch.int64),
                       torch.tensor([3, 0, 1], dtype=torch.int32),
                       torch.tensor([0, 1], dtype=torch.int64),
                       torch.tensor([1, 2], dtype=torch.int64), 3, 4)
    want = np.zeros((3, 4), np.int32)
    want[0, 3] = want[2, 3] = want[1, 0] = want[1, 1] = 1
    assert np.array_equal(rect.numpy(), want)


def test_plain_emission_crosses_its_chunks(monkeypatch):
    """The plain version works in chunks of ``K4_PLAIN_CHUNK`` emissions
    (2²⁶ on the card): a small chunk cuts runs and rows anywhere."""
    rows, pos, n, m = _positions("full_column")
    bt = st.BitMatrix.from_positions(rows, pos, n, m)
    want = oracle_count_matrix(bt.packed)
    for chunk in (1, 7, 64):
        monkeypatch.setattr(tsp, "K4_PLAIN_CHUNK", chunk)
        assert np.array_equal(tsp._k4_matrix(bt, CPU).numpy(), want)


def _panel():
    """Three superblocks of 32 rows, the last ragged (86 rows), a denser
    corner in the first: both forms see runs of every length."""
    rng = np.random.default_rng(87)
    n, m = 86, 4096
    dense = (rng.random((n, m)) < 0.004).astype(np.uint8)
    dense[:20, :256] |= (rng.random((20, 256)) < 0.3).astype(np.uint8)
    dense[:, 7] = 1  # a column in every row
    bj = stormtpu.BitMatrix.from_dense(dense)
    return bj, st.BitMatrix.from_packed(bj.packed, m)


def test_stripe_plain_forms_equal_jax():
    bj, bt = _panel()
    sb, n_super = 32, 3
    got = ts._SparseStripePlan(bt, sb, n_super, device="cpu")
    want = js._SparseStripePlan(bj, sb, n_super)
    for i in range(n_super):
        for j in range(i, n_super):
            stripe = got._stripe_counts_k4(i, j)
            assert stripe.dtype == torch.int32 and stripe.shape == (sb, sb)
            ref = want.stripe_counts(i, j)
            assert np.array_equal(stripe.numpy(), ref)
            host = got.stripe_counts(i, j)  # the host C++ stripe
            assert host.dtype == torch.int32 and np.array_equal(host.numpy(), ref)
            # the walk's nonzeros are np.nonzero's, from either stripe
            li, lj = np.nonzero(ref)
            for s in (stripe, host):
                for a, b in zip(ts._stripe_nonzeros(s), (li, lj, ref[li, lj])):
                    assert np.array_equal(a, b)


def test_emission_counts_equal_the_plans():
    _, bt = _panel()
    plan = ts._SparseStripePlan(bt, 32, 3, device="cpu")
    for i in range(3):
        for j in range(i, 3):
            _, p, _, q = plan._segments(i, j)
            if i == j:
                tri = tsp._emission_prefix(torch.from_numpy(p * (p - 1) // 2))
                assert int(tri[-1]) == (plan.emissions_square(i, j) - int(p.sum())) // 2
                assert int(tri[-1]) == plan.emissions(i, j) - int(p.sum())
            else:
                flat = tsp._emission_prefix(torch.from_numpy(p * q))
                assert int(flat[-1]) == plan.emissions_square(i, j) == plan.emissions(i, j)


def _operands():
    rows = torch.tensor([0, 1, 2], dtype=torch.int32)
    seg = torch.tensor([0], dtype=torch.int64)
    lens = torch.tensor([3], dtype=torch.int64)
    prefix = torch.tensor([0, 3], dtype=torch.int64)
    return [rows, rows, seg, lens, seg, lens, prefix, torch.zeros((3, 3), dtype=torch.int32)]


@pytest.mark.parametrize("bad,match", [
    ((0, torch.zeros(3, dtype=torch.int64)), "rows_a must be"),
    ((3, torch.zeros(1, dtype=torch.int32)), "len_a must be"),
    ((6, torch.zeros((2, 1), dtype=torch.int64)), "prefix must be"),
    ((2, torch.zeros(2, dtype=torch.int64)), "off_a has 2 segments"),
    ((7, torch.zeros(9, dtype=torch.int32)), "out must be"),
    ((7, torch.zeros((3, 3), dtype=torch.int64)), "out must be"),
    ((7, torch.zeros((3, 6), dtype=torch.int32)[:, ::2]), "out must be"),
    ((1, torch.zeros(3, dtype=torch.int32, device="meta")), "rows_b lies on"),
])
def test_emission_wrapper_refuses(bad, match):
    ops = _operands()
    ops[bad[0]] = bad[1]
    with pytest.raises(ValueError, match=match):
        tsp.k4_emit(*ops, triangle=True)


@pytest.mark.parametrize("out,diag,match", [
    (torch.zeros((3, 4), dtype=torch.int32), None, "square int32"),
    (torch.zeros((3, 3), dtype=torch.int64), None, "square int32"),
    (torch.zeros((3, 3), dtype=torch.int32), torch.zeros(3, dtype=torch.int64), "diag must"),
    (torch.zeros((3, 3), dtype=torch.int32), torch.zeros(4, dtype=torch.int32), "diag must"),
    (torch.zeros((3, 3), dtype=torch.int32), torch.zeros(3, dtype=torch.int32, device="meta"),
     "diag lies on"),
])
def test_mirror_wrapper_refuses(out, diag, match):
    with pytest.raises(ValueError, match=match):
        tsp.k4_mirror(out, diag)


def test_cpu_tensors_are_no_card_launch():
    tsp.reset_launches()
    ops = _operands()
    tsp.k4_emit(*ops, triangle=True)
    tsp.k4_mirror(ops[-1], torch.tensor([1, 1, 1], dtype=torch.int32))
    assert np.array_equal(ops[-1].numpy(), np.ones((3, 3), np.int32))
    assert tsp.LAUNCHES == {"k3": 0, "k4": 0, "k4_mirror": 0}


# The card's K4 constants as tuning.K4_DEFAULTS holds them (measured by
# scripts/torch_k4_constants.py on an NVIDIA H100 80GB HBM3; PERF.md §6).
CARD_CONSTANTS = dict(
    c_sort_s_per_nnz=3.42e-9, c_n2_s_per_elem=7.96e-11, c_stripe_n2_s_per_elem=1.46e-11,
    c_emit_s_per_emission=7.07e-11,
    c_emit_host_s_per_emission=1.55e-8, c_download_s_per_elem=7.84e-11,
    c_k2_host_s_per_word=1.44e-9, k2_int8_ops_per_s=6.56e15, dispatch_floor_s=0.00995,
    h2d_bytes_per_s=6.50e9, c_k2_stripe_s_per_op=3.48e-16, c_k4_stripe_s=6.23e-4,
    c_k4_gather_s_per_elem=2.13e-11, c_k4_gather_s_per_position=1.66e-10)


def test_d1_names_k4_at_config_3_b_and_k2_at_a(tmp_path, monkeypatch):
    """D1 needs no card: it only names a strategy. BASELINE.json config 3:
    10,000 × 2²⁰ bits; version B at density 1e-4, version A at 0.5%."""
    from stormtpu_torch import native, tuning
    from stormtpu_torch.dispatch import choose_strategy

    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "absent.json"))
    for k, v in CARD_CONSTANTS.items():
        monkeypatch.setitem(tuning.K4_DEFAULTS, k, v)
    assert set(CARD_CONSTANTS) == set(tuning.K4_DEFAULTS)
    assert native.have_native(), native.native_build_error()
    assert choose_strategy(10_000, 1 << 20, 1e-4, device="cuda") == "sparse_outer"
    assert choose_strategy(10_000, 1 << 20, 0.005, device="cuda") == "pallas_mxu"
