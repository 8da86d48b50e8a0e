"""The streamed queries' density order on LD panels: rows of rare and
common variants (carrier counts of the neutral spectrum, nested carriers
in blocks of 32 rows; ``tests/reference_ld.py``), where ``kernel="auto"``
orders the rows by count and answers the rare rows' stripes with K4.

Held to the plain reference of ``reference_ld.py`` (exact counts, each
pair's r² ≥ 0.8 decided in integers): the r² screen's hit list exactly
and its values to a relative 1e-12 (the program's float64 r² squares a
square root, the reference divides the squared difference by the product:
they round apart by an ulp or two); the same with the dense walk forced;
the r² top-k with and without the order; a shuffled panel; a uniform
panel that takes no order.

The panels are 2,048 × 16,384 bits in superblocks of 256 rows (the CPU's
plain K2 stripe takes about 0.3 s there). At that size the card's own
constants price every K2 stripe below K4's fixed cost, so a CPU tuning
cache prices both sides as the card does at config 4's size: K4 takes the
stripes of few emissions."""

import json

import numpy as np
import pytest

import stormtpu_torch as st
import stormtpu_torch.stream_query as tsq
from reference_ld import ld_panel, pair_counts, r2_decide, r2_hits
from stormtpu_torch import tuning as ttuning
from stormtpu_torch.utils import profiling

N, M, SB, SEED = 2048, 16384, 256, 7
FIELDS = dict(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=8)
# the CPU's prices: a K2 stripe 1.07 ms at 256² × 16,384 bits, K4's 0.1 ms
# and 10 ns an emission
CPU_PRICES = {"c_k2_stripe_s_per_op": 1e-12, "c_k4_stripe_s": 1e-4,
              "c_emit_s_per_emission": 1e-8, "c_k4_gather_s_per_elem": 1e-10,
              "c_k4_gather_s_per_position": 1e-8}
R2_RELATIVE = 1e-12


@pytest.fixture(scope="module")
def priced(tmp_path_factory):
    cache = tmp_path_factory.mktemp("tuning") / "tuning.json"
    cache.write_text(json.dumps({"device": "cpu", "k4_cost_model": CPU_PRICES}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ttuning.CACHE_ENV, str(cache))
        yield


@pytest.fixture(scope="module")
def panel():
    packed = ld_panel(SEED, N, M)
    bm = st.BitMatrix.from_packed(packed, M)
    counts = pair_counts(packed)
    return bm, counts, r2_hits(counts, bm.row_nnz, M)


def _screen(bm, kernel="auto"):
    with profiling.record() as rec:
        got = tsq.stream_pairs_above(bm, 0.8, measure="r2", superblock_rows=SB, kernel=kernel,
                                     config=st.EngineConfig(**FIELDS), device="cpu")
    return got, rec


def _topk(bm, kernel="auto", k=4):
    with profiling.record() as rec:
        got = tsq.stream_topk_neighbors(bm, k, measure="r2", superblock_rows=SB, kernel=kernel,
                                        config=st.EngineConfig(**FIELDS), device="cpu")
    return got, rec


def _order_spans(rec):
    return [s for s in rec.spans if s.name == "stpu.stream.order"]


@pytest.fixture(scope="module")
def ordered(priced, panel):
    return _screen(panel[0])


def _assert_screen(got, want):
    ii, jj, vv = got
    wi, wj, wr = want
    assert ii.dtype == np.int32 and jj.dtype == np.int32 and vv.dtype == np.float64
    assert np.array_equal(ii, wi) and np.array_equal(jj, wj)
    assert np.all(np.abs(vv - wr) <= R2_RELATIVE * wr)


def test_ordered_screen_gives_the_reference_hits(panel, ordered):
    bm, _, want = panel
    got, rec = ordered
    assert want[0].size > 100
    _assert_screen(got, want)
    assert len(_order_spans(rec)) == 1


def test_the_order_engages_on_the_spectrum_panel(panel, ordered):
    bm, _, _ = panel
    _, rec = ordered
    c = rec.counters
    n_super = -(-N // SB)
    assert 0 < c["routes.k4"] < c["stripes"] == n_super * (n_super + 1) // 2
    assert c["routes.k4"] + c["routes.xla_int8"] == c["stripes"]
    assert c["k4_emissions"] > 0
    (span,) = _order_spans(rec)
    rows, held, positions = span.ids
    assert rows == N and 0 < held < n_super
    # the plan holds the set bits of its held superblocks, the rarest rows
    rare = np.sort(bm.row_nnz)[: held * SB]
    assert positions == c["order_positions"] == rare.sum() < bm.nnz // 10


def test_forced_dense_walk_gives_the_reference_hits(priced, panel):
    bm, _, want = panel
    got, rec = _screen(bm, kernel="xla_int8")
    _assert_screen(got, want)
    assert not _order_spans(rec) and "routes.k4" not in rec.counters


def test_shuffled_rows_give_the_same_answer(priced, panel):
    bm, _, (wi, wj, wr) = panel
    perm = np.random.default_rng(3).permutation(N)
    shuffled = st.BitMatrix.from_packed(bm.packed[perm], M)
    (ii, jj, vv), rec = _screen(shuffled)
    assert rec.counters["routes.k4"] > 0
    a, b = perm[ii], perm[jj]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    order = np.lexsort((hi, lo))
    _assert_screen((lo[order].astype(np.int32), hi[order].astype(np.int32), vv[order]),
                   (wi, wj, wr))


def test_ordered_topk_equals_the_dense_walk(priced, panel):
    bm, counts, _ = panel
    (vals, idx), rec = _topk(bm)
    (dvals, didx), drec = _topk(bm, kernel="xla_int8")
    assert rec.counters["routes.k4"] > 0 and len(_order_spans(rec)) == 1
    assert not _order_spans(drec)
    assert vals.dtype == np.float64 and vals.shape == (N, 4)
    # the same values; partners may differ among ties, each valid
    assert np.array_equal(vals, dvals)
    rows = np.repeat(np.arange(N), 4)
    for got in (idx, didx):
        flat = got.ravel().astype(np.int64)
        _, r2 = r2_decide(counts[rows, flat], bm.row_nnz[rows], bm.row_nnz[flat], M)
        assert np.all(np.abs(r2 - vals.ravel()) <= R2_RELATIVE * np.maximum(r2, 1e-300))
        assert np.all(flat != rows)
        srt = np.sort(got, axis=1)
        assert not np.any(srt[:, 1:] == srt[:, :-1])


def test_a_uniform_panel_takes_no_order(priced):
    rng = np.random.default_rng(11)
    packed = rng.integers(0, 2**32, (600, M // 32), dtype=np.uint64).astype(np.uint32)
    bm = st.BitMatrix.from_packed(packed, M)
    got, rec = _screen(bm)
    assert not _order_spans(rec)
    assert not any(k.startswith(("routes.", "order_", "k4_")) for k in rec.counters)
    want = r2_hits(pair_counts(packed), bm.row_nnz, M)
    _assert_screen(got, want)


def test_the_ordered_operand_holds_the_rows_in_order():
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 2**32, (70, 9), dtype=np.uint64).astype(np.uint32)
    bm = st.BitMatrix.from_packed(packed, 9 * 32)
    perm = rng.permutation(70)
    xp = bm.device_ordered2d(perm, 96, 16, device="cpu")
    assert xp.shape == (96, 16)
    assert np.array_equal(xp[:70, :9].numpy().view(np.uint32), packed[perm])
    assert not xp[70:].any() and not xp[:, 9:].any()
    assert bm.device_ordered2d(perm, 96, 16, device="cpu") is xp
    assert bm.device_ordered2d(perm[::-1].copy(), 96, 16, device="cpu") is not xp
