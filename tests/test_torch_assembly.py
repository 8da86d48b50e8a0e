"""The port's assembly of the N×N count matrix on the tiles' device
(``stormtpu_torch.utils.assemble_triangular_torch``) against the numpy
assembly it replaces on the all-pairs paths and against the JAX package's
matrices (K2 and K5 in Pallas interpret mode), and the device-budget guard
that now reckons the tile stack and the matrix together. Inputs are shared
numpy arrays; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.kernels.clustered as jc
import stormtpu.kernels.mxu as jm
import stormtpu_torch as st
import stormtpu_torch.kernels.clustered as tc
import stormtpu_torch.kernels.mxu as tm
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch import api
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.kernels.dense import k1_tile_shape
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.oracle import oracle_count_matrix
from stormtpu_torch.utils import tiling
from stormtpu_torch.utils import (
    assemble_triangular,
    assemble_triangular_torch,
    round_up,
    triangular_assembly_bytes,
    triangular_tile_ids,
)


def _words(n, w, density, seed):
    bits = np.random.default_rng(seed).random((n, w * 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def _block_diagonal(n, m, n_blocks, density, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, m), np.uint8)
    rows = np.linspace(0, n, n_blocks + 1).astype(int)
    cols = np.linspace(0, m, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        r0, r1, c0, c1 = rows[b], rows[b + 1], cols[b], cols[b + 1]
        dense[r0:r1, c0:c1] = rng.random((r1 - r0, c1 - c0)) < density
    return dense


def _k2_case(n, w, ti):
    """K2's tiles of an n × w-word matrix at tile rows ti (the port's plain
    kernel), and the JAX package's matrix of the same words."""
    cfg = EngineConfig(k2_tile_rows=ti, k2_tile_words=128)
    jcfg = JaxConfig(k2_tile_rows=ti, k2_tile_words=128)
    words = _words(n, w, 0.4, seed=n + ti)
    tr, wk = tm.k2_tile_shape(cfg, n, w)
    xp = np.zeros((round_up(n, tr), round_up(w, wk)), np.uint32)
    xp[:n, :w] = words
    nb = xp.shape[0] // tr
    ibs, jbs = triangular_tile_ids(nb)
    tiles = tm.count_tiles_pallas_mxu(
        to_device_words(xp, "cpu"), torch.from_numpy(ibs), torch.from_numpy(jbs),
        tile_rows=tr, tile_words=wk)
    want = jm.count_matrix_pallas_mxu(jnp.asarray(words), config=jcfg, interpret=True)
    return tiles, ibs, jbs, nb, n, np.asarray(want), nb * (nb + 1) // 2


def _k5_case():
    """K5's visited tiles of a block-diagonal matrix whose plan skips tile
    pairs, and the JAX package's clustered matrix."""
    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
    jcfg = JaxConfig(k2_tile_rows=32, k2_tile_words=128)
    dense = _block_diagonal(150, 20000, 4, 0.3, seed=11)
    bj = stormtpu.BitMatrix.from_dense(dense)
    bt = st.BitMatrix.from_packed(bj.packed, dense.shape[1])
    plan = tc.build_clustered_plan(bt, cfg)
    tiles = tc.count_tiles_worklist(
        tc.device_operand(bt, plan, "cpu"), *tc.device_worklist(plan, "cpu"),
        n_slots=plan.slot_ibs.size, tile_rows=plan.ti, tile_words=plan.wk)
    want = jc.count_matrix_clustered(bj, config=jcfg, interpret=True)
    return tiles, plan.slot_ibs, plan.slot_jbs, plan.nb, bt.n, np.asarray(want), \
        plan.nb * (plan.nb + 1) // 2


def _empty_case():
    tiles = torch.zeros((0, 32, 32), dtype=torch.int32)
    none = np.zeros(0, np.int32)
    return tiles, none, none, 3, 70, np.zeros((70, 70), np.int32), 6


CASES = {
    "nb1": lambda: _k2_case(20, 40, 32),
    "nb2": lambda: _k2_case(64, 40, 32),
    "nb5": lambda: _k2_case(160, 24, 32),
    "ragged_n": lambda: _k2_case(137, 33, 32),
    "ti160": lambda: _k2_case(300, 20, 160),
    "ti160_one_block": lambda: _k2_case(150, 20, 160),
    "k5_skipped_pairs": _k5_case,
    "empty_tile_list": _empty_case,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_assemble_triangular_torch_equals_numpy_and_jax(name):
    tiles, ibs, jbs, nb, n, want, n_pairs = CASES[name]()
    if name == "k5_skipped_pairs":
        assert 0 < tiles.shape[0] < n_pairs  # some tile pairs never reached the kernel
    else:
        assert tiles.shape[0] in (0, n_pairs)
    got = assemble_triangular_torch(tiles, ibs, jbs, nb, n)
    assert got.dtype == torch.int32 and got.device == tiles.device
    assert got.shape == (n, n)
    assert np.array_equal(got.numpy(), assemble_triangular(tiles.numpy(), ibs, jbs, nb, n))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("chunk_tiles", (1, 4, 256))
def test_assemble_triangular_torch_any_order_any_subset(monkeypatch, seed, chunk_tiles):
    """Random tiles (diagonal ones symmetric, as exact counts are) of a
    random subset of the tile pairs in a random order: entry for entry the
    numpy assembly, whatever the mirror's chunking."""
    rng = np.random.default_rng(seed)
    nb, ti = int(rng.integers(1, 7)), int(rng.choice((8, 32)))
    ibs, jbs = triangular_tile_ids(nb)
    keep = rng.permutation(ibs.size)[: int(rng.integers(0, ibs.size + 1))]
    ibs, jbs = ibs[keep], jbs[keep]
    tiles = rng.integers(0, 1 << 30, size=(keep.size, ti, ti)).astype(np.int32)
    for t in np.flatnonzero(ibs == jbs):
        tiles[t] = np.triu(tiles[t]) + np.triu(tiles[t], 1).T
    n = int(rng.integers(max(1, (nb - 1) * ti + 1), nb * ti + 1))
    monkeypatch.setattr(tiling, "MIRROR_CHUNK_TILES", chunk_tiles)
    got = assemble_triangular_torch(torch.from_numpy(tiles), ibs, jbs, nb, n)
    assert np.array_equal(got.numpy(), assemble_triangular(tiles, ibs, jbs, nb, n))


def test_assemble_triangular_torch_refuses_bad_input():
    tiles = torch.zeros((2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        assemble_triangular_torch(tiles, [0], [0], 2, 16)
    with pytest.raises(ValueError):
        assemble_triangular_torch(torch.zeros((1, 8, 16), dtype=torch.int32), [0], [0], 1, 8)


def test_triangular_assembly_bytes():
    # 3 tiles of 32 × 32, a 64 × 64 matrix and the mirror's two temporaries
    # of one chunk (here all 3 tiles), all int32
    assert triangular_assembly_bytes(3, 32, 2, 64) == 4 * (3 * 32 * 32 + 64 * 64 + 2 * 3 * 32 * 32)
    # a ragged n also pays the contiguous [:n, :n] copy made for the download
    assert triangular_assembly_bytes(3, 32, 2, 50) == 4 * (
        3 * 32 * 32 + 64 * 64 + 2 * 3 * 32 * 32 + 50 * 50)
    # a chunk is at most MIRROR_CHUNK_TILES tiles
    t = 10 * tiling.MIRROR_CHUNK_TILES
    assert triangular_assembly_bytes(t, 8, 100, 800) == 4 * (
        t * 64 + 800 * 800 + 2 * tiling.MIRROR_CHUNK_TILES * 64)


@pytest.mark.parametrize("strategy,tile_shape", [
    ("pallas_mxu", tm.k2_tile_shape), ("pallas_dense", k1_tile_shape)])
def test_budget_guard_counts_tiles_and_matrix(monkeypatch, strategy, tile_shape):
    """The tile walks hold the operand, the tile stack and the assembled
    matrix on the device together; a budget one byte short refuses."""
    cfg = EngineConfig(k2_tile_rows=32, k1_tile_rows=32)
    words = _words(70, 9, 0.5, seed=3)
    bm = st.BitMatrix.from_packed(words, 9 * 32)
    ti, wk = tile_shape(cfg, 70, 9)
    nb = round_up(70, ti) // ti
    t = nb * (nb + 1) // 2
    need = 4 * nb * ti * round_up(9, wk) + 4 * (
        t * ti * ti + (nb * ti) ** 2 + 2 * t * ti * ti + 70 * 70)
    assert need == api._walk_bytes(70, 9, lambda n, w: tile_shape(cfg, n, w))
    assert need > 4 * 70 * 70 + 4 * 70 * 9  # more than the matrix plus operand alone
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(need - 1))
    with pytest.raises(ValueError, match="count tiles and the N² count matrix"):
        st.intersect_count_matrix(bm, strategy=strategy, config=cfg, device="cpu")
    monkeypatch.setenv("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES", str(need))
    got = st.intersect_count_matrix(bm, strategy=strategy, config=cfg, device="cpu")
    assert np.array_equal(got, oracle_count_matrix(words))


@pytest.mark.parametrize("strategy", ("pallas_mxu", "pallas_dense", "clustered"))
def test_all_pairs_paths_equal_jax_after_device_assembly(strategy):
    """The three tile-walk strategies, now assembled with torch, still give
    the JAX package's matrix on a ragged block-diagonal input."""
    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128, k1_tile_rows=32)
    jcfg = JaxConfig(k2_tile_rows=32, k2_tile_words=128, k1_tile_rows=32)
    dense = _block_diagonal(101, 9000, 3, 0.3, seed=5)
    bj = stormtpu.BitMatrix.from_dense(dense)
    bt = st.BitMatrix.from_packed(bj.packed, dense.shape[1])
    got = st.intersect_count_matrix(bt, strategy=strategy, config=cfg, device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy=strategy, config=jcfg)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bj.packed))
