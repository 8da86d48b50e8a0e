"""``stormtpu_torch.parallel`` against ``stormtpu.parallel`` on the CPU: the
meshes, the all-pairs walk (the triangular ring, the bits axis in its
square, K2-tile and K5 forms, the 2-D grid), column counts, set operations
and similarity matrices, and the sharded K5 planner.

The port runs in one spawned group of 8 gloo ranks for the whole file
(``torch_parallel_cases.run_allpairs``: every case on every mesh it names,
1-D meshes of 1, 2, 3, 4, 5 and 8 ranks and grids of 2×2 and 4×2); each
case is one test here, rank 0's result held to the JAX package's function
on the same input on its forced 8-device CPU mesh — on the grid of the same
shape for the 2-D cases, on 8 devices for the 1-D ones (the JAX package's
results do not depend on the mesh: its own tests hold each to the oracle).
Counts are compared exactly; float64 similarities must be equal too.
"""

import functools

import numpy as np
import pytest

import torch_parallel_cases as cases
from stormtpu.kernels.clustered import (
    build_sharded_clustered_plan as jax_plan,
    pack_sharded_clustered_operand as jax_pack,
)
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu.oracle import oracle_count_matrix
from stormtpu import parallel as jp
from stormtpu_torch.kernels import clustered as tcl
from stormtpu_torch.parallel.dryrun import run_group

#: the spawned group's bound: it is killed and the tests fail past it
GROUP_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def ranks():
    return run_group(cases.WORLD, "gloo", "cpu", cases.run_allpairs, timeout=GROUP_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _data():
    return cases.data()


def _jbm(name):
    packed, m = _data()[name]
    return JaxBitMatrix.from_packed(packed, m)


def _jax_mesh(shape: str):
    if shape.startswith("g"):
        a, b = map(int, shape[1:].split("x"))
        return jp.make_grid_mesh(a, b)
    return jp.make_row_mesh(8)


def _count(name, **kw):
    return lambda mesh: jp.distributed_count_matrix(_data()[name][0], mesh=mesh, **kw)


JAX = {
    "rows_dense": _count("dense30"),
    "rows_ragged": _count("ragged"),
    "rows_eye": _count("eye"),
    "rows_sparse": _count("sparse_dense"),
    "block_fn": lambda mesh: (_count("dense30")(mesh),) * 2,
    "bits_square": _count("ragged", shard_axis="bits"),
    "bits_tri": _count("bits_tri", shard_axis="bits"),
    "bits_k5": _count("bits_k5", shard_axis="bits"),
    "columns": lambda mesh: jp.distributed_column_counts(_jbm("columns"), mesh=mesh,
                                                         chunk_words=8),
    "cardinality": lambda mesh: jp.distributed_pairwise_cardinality(_jbm("setops"), "xor",
                                                                    mesh=mesh),
    "similarity": lambda mesh: jp.distributed_similarity_matrix(_jbm("setops"), "cosine",
                                                                mesh=mesh),
    "grid_union": lambda mesh: jp.distributed_pairwise_cardinality(_jbm("grid_setops"), "union",
                                                                   mesh=mesh),
    "grid_jaccard": lambda mesh: jp.distributed_similarity_matrix(_jbm("grid_setops"), "jaccard",
                                                                  mesh=mesh),
}


@functools.lru_cache(maxsize=None)
def jax_result(case: str, shape: str):
    return JAX[case](_jax_mesh(shape if shape.startswith("g") else "r8"))


def _equal(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _equal(g, w, what)
        return
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


PAIRS = [(case, shape) for case, (_, shapes) in cases.ALLPAIRS.items() for shape in shapes]


@pytest.mark.parametrize("case,shape", PAIRS, ids=[f"{c}-{s}" for c, s in PAIRS])
def test_case_equals_jax(ranks, case, shape):
    got = ranks[0][(case, shape)]
    want = jax_result(case, shape)
    _equal(got, want, f"{case} on {shape}")
    if case.startswith(("rows", "bits")):
        np.testing.assert_array_equal(got, oracle_count_matrix(_data()[
            {"rows_dense": "dense30", "rows_ragged": "ragged", "rows_eye": "eye",
             "rows_sparse": "sparse_dense", "bits_square": "ragged", "bits_tri": "bits_tri",
             "bits_k5": "bits_k5"}[case]][0]))


def test_every_rank_of_a_mesh_returns_the_whole_result_and_the_others_none(ranks):
    members = {"r1": 1, "r2": 2, "r3": 3, "r4": 4, "r5": 5, "r8": 8, "g2x2": 4, "g4x2": 8}
    for case, shape in PAIRS:
        have = [rk for rk in range(cases.WORLD) if (case, shape) in ranks[rk]]
        assert have == list(range(members[shape])), (case, shape)
        for rk in have[1:]:
            _equal(ranks[rk][(case, shape)], ranks[0][(case, shape)], f"{case} {shape} rank {rk}")


def test_parallel_exports_the_jax_names():
    import stormtpu_torch.parallel as tp

    assert tp.__all__ == jp.__all__ and len(tp.__all__) == 15
    assert all(callable(getattr(tp, name)) for name in tp.__all__)


def test_meshes_refuse_as_jax(ranks):
    errs = ranks[0][("errors", "world")]
    for key, call in (
        ("mesh9", lambda: jp.make_row_mesh(9)),
        ("grid3x3", lambda: jp.make_grid_mesh(3, 3)),
        ("grid0", lambda: jp.make_grid_mesh(0, 2)),
        ("shard_axis", lambda: jp.distributed_count_matrix(
            np.zeros((8, 8), np.uint32), mesh=jp.make_row_mesh(8), shard_axis="cols")),
    ):
        with pytest.raises(ValueError) as e:
            call()
        assert errs[key] == str(e.value), key
    assert all(ranks[rk][("errors", "world")] == errs for rk in range(cases.WORLD))


def test_meshes_named_by_their_ranks(ranks):
    """``devices=`` (a sequence of ranks, in mesh order): every member gets
    the mesh in that order and the whole exact result; the others None."""
    packed = _data()["ragged"][0]
    c = oracle_count_matrix(_data()["topk_sparse"][0]).astype(np.int64)
    n = c.shape[0]
    for key, (shape, members) in cases.DEVICE_MESHES.items():
        members = members[: shape] if isinstance(shape, int) else members
        have = [rk for rk in range(cases.WORLD) if ("devices", key) in ranks[rk]]
        assert have == sorted(members), key
        for rk in have:
            order, counts, (vals, idx) = ranks[rk][("devices", key)]
            assert order == members, key
            np.testing.assert_array_equal(counts, oracle_count_matrix(packed))
            cm = c.copy()
            np.fill_diagonal(cm, -1)
            np.testing.assert_array_equal(vals, -np.sort(-cm, axis=1)[:, :8])
            assert np.array_equal(c[np.arange(n)[:, None], idx], vals), key
            assert all(len(set(idx[r].tolist())) == 8 and r not in idx[r] for r in range(n))


def test_devices_refused_as_jax(ranks):
    import jax

    errs = ranks[0][("devices", "errors")]
    devs = jax.devices()
    for key, call in (("row_short", lambda: jp.make_row_mesh(4, devices=devs[:2])),
                      ("grid_short", lambda: jp.make_grid_mesh(2, 2, devices=devs[:3]))):
        with pytest.raises(ValueError) as e:
            call()
        assert errs[key] == str(e.value), key
    # JAX takes any device objects; the port takes ranks of its group
    assert "ranks of the group" in errs["not_a_rank"]
    assert "distinct" in errs["repeated"]
    assert all(ranks[rk][("devices", "errors")] == errs for rk in range(cases.WORLD))


# ------------------------------------------------------- the sharded K5 plan
def _block_diagonal(n, m_bits, blocks, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, m_bits), dtype=np.uint8)
    for b in range(blocks):
        r = slice(b * n // blocks, (b + 1) * n // blocks)
        c = slice(b * m_bits // blocks, (b + 1) * m_bits // blocks)
        dense[r, c] = rng.random((dense[r, c].shape)) < 0.3
    from stormtpu_torch.layout import pack_bits

    return pack_bits(dense), m_bits


PLAN_INPUTS = {"quarter": lambda: _data()["bits_k5"],
               "blocks": lambda: _block_diagonal(70, 8 * 128 * 32 * 3, 3, seed=7)}


@pytest.mark.parametrize("name", sorted(PLAN_INPUTS))
@pytest.mark.parametrize("r", cases.ROWS)
def test_sharded_plan_equals_jax_and_its_shards_sum_to_the_counts(name, r):
    import torch

    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.utils import assemble_triangular_torch

    packed, m = PLAN_INPUTS[name]()
    want = jax_plan(JaxBitMatrix.from_packed(packed, m), r)
    bm = BitMatrix.from_packed(packed, m)
    got = tcl.build_sharded_clustered_plan(bm, r)
    assert (got is None) == (want is None)
    if want is None:
        return
    for field in ("ti", "wk", "n_pad", "w_pad", "nb", "gpd", "r", "n_slots", "work_fraction"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("slot_ibs", "slot_jbs", "ibs_w", "jbs_w", "gsel_w", "slots_w", "first_w"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    xp = tcl.pack_sharded_clustered_operand(bm, got)
    np.testing.assert_array_equal(xp, jax_pack(JaxBitMatrix.from_packed(packed, m), want))
    # each rank's list passes the host check (its fillers included), and the
    # ranks' tiles sum to the exact counts
    per = (got.gpd + 1) * got.wk
    total = None
    for d in range(r):
        work = tcl.device_worklist(got, "cpu", shard=d)
        x = torch.from_numpy(np.ascontiguousarray(xp[:, d * per : (d + 1) * per]).view(np.int32))
        tiles = tcl.count_tiles_worklist(x, *work, n_slots=got.n_slots, tile_rows=got.ti,
                                         tile_words=got.wk, checked=work)
        total = tiles if total is None else total + tiles
    c = assemble_triangular_torch(total[: got.slot_ibs.size], got.slot_ibs, got.slot_jbs,
                                  got.nb, bm.n).numpy()
    np.testing.assert_array_equal(c, oracle_count_matrix(packed))


def test_sharded_worklist_needs_its_shard():
    from stormtpu_torch.layout import BitMatrix

    packed, m = _data()["bits_k5"]
    plan = tcl.build_sharded_clustered_plan(BitMatrix.from_packed(packed, m), 2)
    with pytest.raises(ValueError, match="shard="):
        tcl.device_worklist(plan, "cpu")
