"""The port's K1 and K0 (``stormtpu_torch.kernels.dense``) against the
JAX package's on the CPU, the JAX side in Pallas interpret mode. Inputs
are shared numpy arrays; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormtpu
import stormtpu.kernels.dense as jd
import stormtpu_torch as st
import stormtpu_torch.kernels.dense as td
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.oracle import oracle_count_matrix
from stormtpu_torch.utils import round_up, triangular_tile_ids


def _words(n, w, density, seed):
    rng = np.random.default_rng(seed)
    if density >= 1.0:
        return np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    bits = rng.random((n, w * 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def _t(words):
    return to_device_words(words, "cpu")


@pytest.mark.parametrize("variant", ("rows", "chunk"))
@pytest.mark.parametrize("n,ti", [(16, 16), (37, 40), (50, 24)])
def test_k1_tiles_equal_jax_interpret(n, ti, variant):
    # TI = 40 and 24 are multiples of 8 but not of 32
    wk = 256
    xp = np.zeros((round_up(n, ti), 512), np.uint32)
    xp[:n, :300] = _words(n, 300, 0.4, seed=n)
    ibs, jbs = triangular_tile_ids(xp.shape[0] // ti)
    want = jd.count_tiles_pallas_dense(
        jnp.asarray(xp), jnp.asarray(ibs), jnp.asarray(jbs),
        tile_rows=ti, tile_words=wk, interpret=True, variant=variant,
    )
    got = td.count_tiles_pallas_dense(
        _t(xp), torch.from_numpy(ibs), torch.from_numpy(jbs),
        tile_rows=ti, tile_words=wk, variant=variant,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def _tile_list(nb, order, seed):
    """A tile list over nb row blocks: the whole triangle i-major, that
    list shuffled (neighbours then rarely share a row block), or with its
    tail cut to an odd length."""
    ibs, jbs = triangular_tile_ids(nb)
    if order == "shuffled":
        perm = np.random.default_rng(seed).permutation(ibs.size)
        ibs, jbs = ibs[perm], jbs[perm]
    elif order == "odd":
        keep = ibs.size - 1 if ibs.size % 2 == 0 else ibs.size - 2
        ibs, jbs = ibs[:keep], jbs[:keep]
    return np.ascontiguousarray(ibs), np.ascontiguousarray(jbs)


@pytest.mark.parametrize("order", ("i-major", "shuffled", "odd"))
@pytest.mark.parametrize("ti", (8, 40, 136))
def test_k1_tile_rows_and_tile_lists_equal_jax_interpret(ti, order):
    # the tile rows the CUDA kernel treats apart: part of a block's half
    # (8, 40) and two sub-tile rows (136); any tile list is taken
    nb, wk = 3, 128
    xp = np.zeros((nb * ti, wk), np.uint32)
    xp[: nb * ti - 3, :100] = _words(nb * ti - 3, 100, 0.4, seed=ti)
    ibs, jbs = _tile_list(nb, order, seed=ti)
    want = jd.count_tiles_pallas_dense(
        jnp.asarray(xp), jnp.asarray(ibs), jnp.asarray(jbs),
        tile_rows=ti, tile_words=wk, interpret=True, variant="rows",
    )
    got = td.count_tiles_pallas_dense(
        _t(xp), torch.from_numpy(ibs), torch.from_numpy(jbs), tile_rows=ti, tile_words=wk,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def _brute_force_units(ibs):
    """Walk the list once: a tile leads, and takes the next tile along when
    that one has the same row block."""
    leads, t = [], 0
    while t < len(ibs):
        leads.append(t)
        t += 2 if t + 1 < len(ibs) and ibs[t + 1] == ibs[t] else 1
    return leads + [-1] * (len(ibs) - len(leads))


@pytest.mark.parametrize("blocks", (1, 2, 5))
@pytest.mark.parametrize("n", (0, 1, 2, 5, 37, 200))
@pytest.mark.parametrize("order", ("sorted", "random"))
def test_pair_units_equal_a_brute_force_pairing(n, blocks, order):
    ibs = np.random.default_rng(n + blocks).integers(0, blocks, n).astype(np.int32)
    if order == "sorted":
        ibs = np.sort(ibs)
    units = td.pair_units(torch.from_numpy(ibs))
    assert units.dtype == torch.int32 and units.shape == (n,) and units.is_contiguous()
    assert units.tolist() == _brute_force_units(ibs.tolist())


def test_pair_units_of_the_triangle_fill_every_block_but_one_a_row():
    nb = 9
    ibs, _ = triangular_tile_ids(nb)
    units = td.pair_units(torch.from_numpy(ibs)).numpy()
    leads = units[units >= 0]
    paired = np.array([t + 1 < ibs.size and ibs[t + 1] == ibs[t] for t in leads])
    # row block i has nb - i tiles: one runs alone where that is odd
    assert (~paired).sum() == sum((nb - i) % 2 for i in range(nb))
    covered = np.concatenate([leads, leads[paired] + 1])
    assert np.array_equal(np.sort(covered), np.arange(ibs.size))


@pytest.mark.parametrize("n,w,density,cfg", [
    (1, 5, 0.5, EngineConfig()),
    (24, 22, 1.0, EngineConfig()),
    (37, 300, 0.01, EngineConfig(k1_tile_rows=16, k1_tile_words=128)),
    (37, 260, 0.5, EngineConfig(k1_tile_rows=8, k1_tile_words=128)),
])
def test_count_matrix_pallas_dense_equals_jax(n, w, density, cfg):
    jcfg = JaxConfig(k1_tile_rows=cfg.k1_tile_rows, k1_tile_words=cfg.k1_tile_words)
    words = _words(n, w, density, seed=w)
    got = td.count_matrix_pallas_dense(_t(words), config=cfg)
    want = jd.count_matrix_pallas_dense(jnp.asarray(words), config=jcfg, interpret=True)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(words))


def test_k1_tile_shape_grid_equals_jax_geometry():
    for rows, words in ((128, 2048), (8, 128), (40, 300)):
        cfg = EngineConfig(k1_tile_rows=rows, k1_tile_words=words)
        for n in (1, 7, 8, 9, 130, 1000):
            for w in (1, 100, 128, 129, 300, 2048, 2049, 5000):
                ti, wk = td.k1_tile_shape(cfg, n, w)
                # dense.py:272-277 of the JAX package
                assert ti == min(rows, round_up(max(n, 8), 8))
                assert wk == (round_up(max(w, 128), 128) if w <= words
                              else round_up(words, 128))


@pytest.mark.parametrize("salt", (0, 0xDEADBEEF))
@pytest.mark.parametrize("r,w", [(5, 7), (130, 200), (37, 1300)])
def test_pair_count_stream_equals_jax_interpret(r, w, salt):
    rng = np.random.default_rng(r + w)
    a = rng.integers(0, 2**32, (r, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, (r, w), dtype=np.uint32)
    a[r // 2] = 0  # an empty row
    want = jd.pair_count_stream_pallas(
        jnp.asarray(a), jnp.asarray(b), salt=np.uint32(salt),
        block_rows=64, block_words=128, interpret=True,
    )
    got = td.pair_count_stream_pallas(_t(a), _t(b), salt=salt, block_rows=64,
                                      block_words=128)
    assert got.dtype == torch.int32 and got.shape == (r,)
    assert np.array_equal(got.numpy(), np.asarray(want))
    oracle = np.bitwise_count((a ^ np.uint32(salt)) & b).sum(axis=1, dtype=np.int64)
    assert np.array_equal(got.numpy().astype(np.int64), oracle)


@pytest.mark.parametrize("n,m", [(40, 900), (70, (1 << 17) + 33)])
def test_intersect_count_matrix_pallas_dense_equals_jax(n, m):
    rng = np.random.default_rng(n)
    dense = (rng.random((n, m)) < 0.2).astype(np.uint8)
    bj = stormtpu.BitMatrix.from_dense(dense)
    bt = st.BitMatrix.from_packed(bj.packed, m)
    got = st.intersect_count_matrix(bt, strategy="pallas_dense", device="cpu")
    want = stormtpu.intersect_count_matrix(bj, strategy="pallas_dense")
    assert got.dtype == np.int32 and got.shape == (n, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_count_matrix(bj.packed))


def test_dense_wrappers_refuse_bad_input():
    xp = _t(np.zeros((64, 16), np.uint32))
    ids = torch.zeros(1, dtype=torch.int32)
    for kw in (dict(tile_rows=12, tile_words=8), dict(tile_rows=16, tile_words=6),
               dict(tile_rows=48, tile_words=8), dict(tile_rows=16, tile_words=8,
                                                      variant="planes")):
        with pytest.raises(ValueError):
            td.count_tiles_pallas_dense(xp, ids, ids, **kw)
    with pytest.raises(ValueError):
        td.count_tiles_pallas_dense(xp, ids + 4, ids, tile_rows=16, tile_words=8)
    with pytest.raises(ValueError):
        td.pair_count_stream_pallas(xp, xp[:5])
    for salt in (-1, 1 << 32):
        with pytest.raises(ValueError):
            td.pair_count_stream_pallas(xp, xp, salt=salt)


def test_plain_forms_do_not_count_launches():
    td.reset_launches()
    words = _words(40, 20, 0.5, seed=9)
    td.count_matrix_pallas_dense(_t(words))
    td.pair_count_stream_pallas(_t(words), _t(words), salt=3)
    assert td.LAUNCHES == {"k1": 0, "k0": 0}
