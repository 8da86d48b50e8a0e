"""The port's K5 path (``stormtpu_torch.kernels.clustered``) against the
JAX package's on the CPU: the planner's arrays, the work-list kernel (the
JAX side in Pallas interpret mode), the clustered matrix, and the entry
point with ``strategy="clustered"`` / ``"auto"``. Inputs are shared numpy
arrays; every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.kernels.clustered as jc
import stormtpu_torch as st
import stormtpu_torch.kernels.clustered as tc
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.oracle import oracle_count_matrix
from stormtpu_torch.utils import triangular_assembly_bytes

from conftest import DENSITY_SWEEP

# small tiles so CPU shapes cross tile and K-group boundaries cheaply
# (k2_tile_shape forces 128 words per K-group when W > k2_tile_words)
CFG = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
JCFG = JaxConfig(k2_tile_rows=32, k2_tile_words=128)


def _block_diagonal(n, m, n_blocks, density, seed):
    """Row block b occupies only bit stripe b (the LD-panel shape: every
    word column is occupied by some row, so global compaction is a no-op)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, m), np.uint8)
    rows = np.linspace(0, n, n_blocks + 1).astype(int)
    cols = np.linspace(0, m, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        r0, r1, c0, c1 = rows[b], rows[b + 1], cols[b], cols[b + 1]
        dense[r0:r1, c0:c1] = rng.random((r1 - r0, c1 - c0)) < density
    return dense


def _uniform(n, m, density, seed):
    return (np.random.default_rng(seed).random((n, m)) < density).astype(np.uint8)


def _pair(dense):
    bj = stormtpu.BitMatrix.from_dense(dense)
    return bj, st.BitMatrix.from_packed(bj.packed, dense.shape[1])


PLAN_INPUTS = {
    "block_diagonal": lambda: _block_diagonal(128, 16384, 4, 0.3, seed=1),
    "ragged": lambda: _block_diagonal(97, 12345, 3, 0.4, seed=2),
    "empty": lambda: np.zeros((40, 16384), np.uint8),
    "single_group": lambda: _uniform(40, 2048, 0.3, seed=3),
    **{f"density_{d}": (lambda d=d: _uniform(96, 16000, d, seed=4))
       for d in DENSITY_SWEEP},
}


@pytest.mark.parametrize("name", sorted(PLAN_INPUTS))
def test_build_clustered_plan_equals_jax(name):
    bj, bt = _pair(PLAN_INPUTS[name]())
    want = jc.build_clustered_plan(bj, JCFG)
    got = tc.build_clustered_plan(bt, CFG)
    assert tc.clustered_work_fraction(bt, CFG) == jc.clustered_work_fraction(bj, JCFG)
    if want is None:
        assert got is None
        return
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), field.name
        else:
            assert g == w, field.name


def _plan_inputs(dense, cfg=CFG, jcfg=JCFG):
    bj, bt = _pair(dense)
    plan = tc.build_clustered_plan(bt, cfg)
    xp = np.zeros((plan.n_pad, plan.w_pad), np.uint32)
    xp[: bt.n, : bt.n_words] = bt.packed
    work = (plan.ibs_w, plan.jbs_w, plan.gsel_w, plan.slots_w, plan.first_w)
    return plan, xp, work


@pytest.mark.parametrize("variant", ("concat", "planes"))
def test_count_tiles_worklist_equals_jax_interpret(variant):
    # ragged N and M; P < 8 so the plan has pad slots and tail pad items,
    # and the block stripes span several K-groups per slot
    plan, xp, work = _plan_inputs(_block_diagonal(70, 13000, 2, 0.35, seed=5))
    assert plan.n_slots > plan.slot_ibs.size
    assert plan.ibs_w.size > plan.n_work + plan.n_slots - plan.slot_ibs.size
    assert np.bincount(plan.slots_w[: plan.n_work]).max() > 1
    kw = dict(n_slots=plan.n_slots, tile_rows=plan.ti, tile_words=plan.wk)
    want = jc.count_tiles_worklist(
        jnp.asarray(xp), *map(jnp.asarray, work), interpret=True, variant=variant, **kw
    )
    got = tc.count_tiles_worklist(
        to_device_words(xp, "cpu"), *map(torch.from_numpy, work), variant=variant, **kw
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ("block_diagonal", "ragged", "empty", "single_group"))
def test_count_matrix_clustered_equals_jax(name):
    bj, bt = _pair(PLAN_INPUTS[name]())
    got = tc.count_matrix_clustered(bt, config=CFG, device="cpu")
    want = jc.count_matrix_clustered(bj, config=JCFG, interpret=True)
    assert got.dtype == np.int32 and got.shape == (bt.n, bt.n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bj.packed))


@pytest.mark.parametrize("strategy", ("clustered", "auto"))
def test_intersect_count_matrix_ld_panel_equals_jax(strategy):
    bj, bt = _pair(_block_diagonal(96, 16384, 3, 0.3, seed=6))
    assert st.dispatch.choose_strategy(
        bt.n, bt.m_bits, bt.density, CFG, bm=bt, device="cpu") == "clustered"
    got = st.intersect_count_matrix(bt, strategy=strategy, config=CFG, device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy=strategy, config=JCFG)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bj.packed))


def test_worklist_wrapper_refuses_bad_lists():
    plan, xp, work = _plan_inputs(_block_diagonal(100, 9000, 2, 0.35, seed=7))
    packed = to_device_words(xp, "cpu")
    kw = dict(n_slots=plan.n_slots, tile_rows=plan.ti, tile_words=plan.wk)

    def call(**swap):
        arrays = dict(zip(("ibs", "jbs", "gsel", "slots", "first"), work))
        arrays.update(swap)
        return tc.count_tiles_worklist(
            packed, *(torch.from_numpy(np.asarray(a, np.int32)) for a in arrays.values()), **kw)

    call()  # the plan as built is accepted
    with pytest.raises(ValueError, match="ascending"):
        call(slots=plan.slots_w[::-1].copy())
    bad_first = plan.first_w.copy()
    bad_first[1] ^= 1
    with pytest.raises(ValueError, match="first"):
        call(first=bad_first)
    with pytest.raises(ValueError, match="gsel"):
        call(gsel=np.full_like(plan.gsel_w, plan.ng + 1))
    with pytest.raises(ValueError, match="ibs"):
        call(ibs=np.full_like(plan.ibs_w, plan.nb))
    with pytest.raises(ValueError):
        tc.count_tiles_worklist(packed, *map(torch.from_numpy, work), variant="rows", **kw)


BAD_LISTS = {
    "unsorted": lambda plan, k: dict(
        slots_w=np.concatenate([plan.slots_w[:k][::-1], plan.slots_w[k:]])),
    "first": lambda plan, k: dict(
        first_w=np.concatenate([[0], plan.first_w[1:]]).astype(np.int32)),
    "gsel": lambda plan, k: dict(gsel_w=np.full_like(plan.gsel_w, plan.ng + 1)),
    "ibs": lambda plan, k: dict(ibs_w=np.full_like(plan.ibs_w, plan.nb)),
}


@pytest.mark.parametrize("bad", sorted(BAD_LISTS))
def test_bad_worklist_raises_on_both_routes_into_the_wrapper(bad):
    """A malformed list is refused where it is checked: by the wrapper for
    bare tensors, at plan time for the path's checked work list."""
    plan, xp, _ = _plan_inputs(_block_diagonal(100, 9000, 2, 0.35, seed=7))
    k = plan.n_work
    broken = dataclasses.replace(plan, **BAD_LISTS[bad](plan, k))
    with pytest.raises(ValueError):
        tc.device_worklist(broken, "cpu")
    arrays = [torch.from_numpy(np.ascontiguousarray(a[:k])) for a in (
        broken.ibs_w, broken.jbs_w, broken.gsel_w, broken.slots_w, broken.first_w)]
    with pytest.raises(ValueError):
        tc.count_tiles_worklist(to_device_words(xp, "cpu"), *arrays,
                                n_slots=plan.slot_ibs.size, tile_rows=plan.ti,
                                tile_words=plan.wk)


@pytest.mark.parametrize("name", ("block_diagonal", "ragged"))
def test_plan_time_slot_starts_equal_the_read_back_route(name, monkeypatch):
    _, bt = _pair(PLAN_INPUTS[name]())
    plan = tc.build_clustered_plan(bt, CFG)
    work = tc.device_worklist(plan, "cpu")
    geometry = dict(n_slots=plan.slot_ibs.size, nb=plan.nb, ng=plan.ng + 1)
    want = tc._slot_starts(*work, **geometry)
    assert work.starts.dtype == np.int32 and np.array_equal(work.starts, want)
    assert len(work.tensors) == 5 and all(
        np.array_equal(t.numpy(), a[: plan.n_work]) for t, a in zip(
            work, (plan.ibs_w, plan.jbs_w, plan.gsel_w, plan.slots_w, plan.first_w)))
    # the checked route never reads the list back
    packed = tc.device_operand(bt, plan, "cpu")
    kw = dict(n_slots=plan.slot_ibs.size, tile_rows=plan.ti, tile_words=plan.wk)
    bare = tc.count_tiles_worklist(packed, *work, **kw)

    def no_read_back(*a, **k):
        raise AssertionError("the checked route read the work list back")

    monkeypatch.setattr(tc, "_slot_starts", no_read_back)
    got = tc.count_tiles_worklist(packed, *work, checked=work, **kw)
    assert torch.equal(got, bare)
    assert np.array_equal(tc.count_matrix_clustered(bt, config=CFG, device="cpu"),
                          oracle_count_matrix(bt.packed))


def test_checked_worklist_vouches_only_for_what_was_checked():
    _, bt = _pair(PLAN_INPUTS["block_diagonal"]())
    plan = tc.build_clustered_plan(bt, CFG)
    work = tc.device_worklist(plan, "cpu")
    packed = tc.device_operand(bt, plan, "cpu")
    kw = dict(n_slots=plan.slot_ibs.size, tile_rows=plan.ti, tile_words=plan.wk)
    with pytest.raises(ValueError, match="other work-list tensors"):
        tc.count_tiles_worklist(packed, *(t.clone() for t in work), checked=work, **kw)
    with pytest.raises(ValueError, match="n_slots"):
        tc.count_tiles_worklist(packed, *work, checked=work, **{**kw, "n_slots": kw["n_slots"] + 1})
    with pytest.raises(ValueError, match="K-groups"):
        tc.count_tiles_worklist(packed[:, : -plan.wk].contiguous(), *work, checked=work, **kw)
    work.tensors[3].add_(0)  # an in-place write, whatever it wrote
    with pytest.raises(ValueError, match="written to"):
        tc.count_tiles_worklist(packed, *work, checked=work, **kw)


@pytest.mark.parametrize("n_sub", (1, 2, 4))
@pytest.mark.parametrize("lengths", [(3, 0, 7, 1, 7, 2), (1,), (0, 0), (5, 5, 5)])
def test_schedule_units_cover_every_sub_tile_once_longest_first(lengths, n_sub):
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    units = tc.schedule_units(starts, n_sub)
    assert units.dtype == np.int32 and units.shape == (len(lengths) * n_sub, 4)
    assert units.flags.c_contiguous
    # every (slot, sub-tile) once, with its slot's items
    seen = sorted((int(u[2]), int(u[3])) for u in units)
    assert seen == [(s, b) for s in range(len(lengths)) for b in range(n_sub)]
    for first, items, slot, _ in units:
        assert first == starts[slot] and items == lengths[slot]
    assert np.all(np.diff(units[:, 1]) <= 0)             # longest first
    per_slot = units[::n_sub, 2]
    assert all(np.all(np.diff(per_slot[units[::n_sub, 1] == n]) > 0)   # ties in slot order
               for n in set(lengths))
    assert np.array_equal(np.repeat(per_slot, n_sub), units[:, 2])     # sub-tiles together


def test_longest_first_order_leaves_the_plain_result_unchanged():
    """The schedule is a permutation of the slots; run as a work list in
    that order (slots renumbered, so that they ascend) it gives the same
    tiles, permuted."""
    plan, xp, _ = _plan_inputs(_block_diagonal(70, 13000, 2, 0.35, seed=5))  # 1 to 4 items a slot
    k, p = plan.n_work, plan.slot_ibs.size
    work = [a[:k] for a in (plan.ibs_w, plan.jbs_w, plan.gsel_w, plan.slots_w, plan.first_w)]
    starts = tc.check_worklist(*work, n_slots=p, nb=plan.nb, ng=plan.ng + 1)
    order = tc.schedule_units(starts, 1)[:, 2]
    assert np.array_equal(np.sort(order), np.arange(p)) and not np.array_equal(order, np.arange(p))
    items = np.concatenate([np.arange(starts[s], starts[s + 1]) for s in order])
    rank = np.empty(p, np.int32)
    rank[order] = np.arange(p, dtype=np.int32)
    permuted = [a[items] for a in work[:3]] + [rank[work[3][items]], work[4][items]]
    packed = to_device_words(xp, "cpu")
    kw = dict(n_slots=p, tile_rows=plan.ti, tile_words=plan.wk)
    want = tc.count_tiles_worklist_plain(packed, *map(torch.from_numpy, work), **kw)
    got = tc.count_tiles_worklist_plain(
        packed, *(torch.from_numpy(np.ascontiguousarray(a)) for a in permuted), **kw)
    assert torch.equal(got, want[torch.from_numpy(order.astype(np.int64))])
    # and the wrapper takes the permuted list as a valid one
    assert torch.equal(tc.count_tiles_worklist(
        packed, *(torch.from_numpy(np.ascontiguousarray(a)) for a in permuted), **kw), got)


def test_unvisited_slot_is_zero_and_plain_launches_nothing():
    plan, xp, work = _plan_inputs(_block_diagonal(100, 9000, 2, 0.35, seed=8))
    tc.reset_launches()
    got = tc.count_tiles_worklist(
        to_device_words(xp, "cpu"), *map(torch.from_numpy, work),
        n_slots=plan.n_slots + 2, tile_rows=plan.ti, tile_words=plan.wk)
    assert not got[plan.n_slots:].any()
    assert tc.LAUNCHES == {"k5": 0}


def test_clustered_budget_guard_uses_the_plan(monkeypatch):
    _, bt = _pair(_block_diagonal(96, 12800, 4, 0.35, seed=9))
    plan = tc.build_clustered_plan(bt, CFG)
    # the padded operand, the count tiles, the matrix assembled beside them
    # and the mirror's two temporaries of the tiles' size
    need = 4 * plan.n_pad * plan.w_pad + triangular_assembly_bytes(
        plan.n_slots, plan.ti, plan.nb, bt.n)
    assert need == 4 * (plan.n_pad * plan.w_pad + 3 * plan.n_slots * plan.ti**2 + 96 * 96)
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(need - 1))
    with pytest.raises(ValueError, match="K5 operand"):
        st.intersect_count_matrix(bt, strategy="clustered", config=CFG, device="cpu")
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(need))
    got = st.intersect_count_matrix(bt, strategy="clustered", config=CFG, device="cpu")
    assert np.array_equal(got, oracle_count_matrix(bt.packed))
