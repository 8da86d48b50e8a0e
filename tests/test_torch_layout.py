"""The port's host layer (``stormtpu_torch.layout``, ``utils.tiling``,
``config``) against the JAX package's, byte for byte, on shared numpy
inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import stormtpu.layout as jl
import stormtpu.utils.tiling as jt
import stormtpu_torch.layout as tl
import stormtpu_torch.utils.tiling as tt
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu_torch.config import EngineConfig

from conftest import DENSITY_SWEEP

RAGGED_M = (1, 31, 33, 1001, 4096 + 7)


def _dense(n, m, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, m)) < density).astype(np.uint8)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("density", DENSITY_SWEEP)
@pytest.mark.parametrize("m", RAGGED_M)
def test_pack_unpack_and_stats_identical(m, density):
    dense = _dense(23, m, density, seed=m)
    _same(tl.pack_bits(dense), jl.pack_bits(dense))
    packed = jl.pack_bits(dense)
    _same(tl.unpack_bits(packed, m), jl.unpack_bits(packed, m))
    bj = jl.BitMatrix.from_packed(packed, m)
    bt = tl.BitMatrix.from_packed(packed, m)
    _same(bt.row_nnz, bj.row_nnz)
    assert bt.density == bj.density and bt.nnz == bj.nnz
    for block_bits in (32, 64, 65536):
        _same(bt.block_summary(block_bits), bj.block_summary(block_bits))
    for x, y in zip(bt.positions_csr(), bj.positions_csr()):
        _same(x, y)


@pytest.mark.parametrize("m", RAGGED_M)
def test_pack_positions_and_builders_identical(m):
    rng = np.random.default_rng(m + 1)
    n = 11
    rows = rng.integers(0, n, 200)
    pos = rng.integers(0, m, 200)  # duplicates included: OR is idempotent
    _same(tl.pack_positions(rows, pos, n, m), jl.pack_positions(rows, pos, n, m))
    bt = tl.BitMatrix.from_positions(rows, pos, n, m)
    bj = jl.BitMatrix.from_positions(rows, pos, n, m)
    _same(bt.packed, bj.packed)
    lists = [rng.integers(0, m, k) for k in (0, 1, 5, 9)]
    _same(tl.BitMatrix.from_position_lists(lists, m).packed,
          jl.BitMatrix.from_position_lists(lists, m).packed)
    builders = (tl.BitMatrixBuilder(m), jl.BitMatrixBuilder(m))
    for b in builders:
        b.add_row(lists[2])
        b.add_row()
        b.add(1, lists[3])
    _same(builders[0].finalize().packed, builders[1].finalize().packed)


def test_padding_helpers_identical():
    packed = jl.pack_bits(_dense(5, 100, 0.5, seed=3))
    for mult in (1, 4, 8, 32):
        _same(tl.pad_rows(packed, mult), jl.pad_rows(packed, mult))
        _same(tl.pad_words(packed, mult), jl.pad_words(packed, mult))
    for m in RAGGED_M:
        assert tl.words_for_bits(m) == jl.words_for_bits(m)


def test_layout_refusals_match():
    packed = np.array([[1 << 31]], dtype=np.uint32)
    for mod in (tl, jl):
        with pytest.raises(ValueError):
            mod.BitMatrix.from_packed(packed, 5)  # bit beyond m_bits
        with pytest.raises(ValueError):
            mod.BitMatrix.from_packed(packed, 65)  # word count mismatch
        with pytest.raises(ValueError):
            mod.pack_positions([0], [10], 1, 10)
        with pytest.raises(ValueError):
            mod.BitMatrixBuilder(0)


def test_tiling_helpers_identical():
    for x in list(range(0, 300)) + [1023, 1024, 1025, 1 << 20]:
        assert tt.round_up(x, 32) == jt.round_up(x, 32)
        assert tt.next_pow2(x) == jt.next_pow2(x)
        assert tt.quantize_bucket(x) == jt.quantize_bucket(x)
        assert tt.quantize_bucket(x, 3) == jt.quantize_bucket(x, 3)
    rng = np.random.default_rng(4)
    for nb in (1, 2, 5):
        ibs, jbs = tt.triangular_tile_ids(nb)
        ibj, jbj = jt.triangular_tile_ids(nb)
        _same(ibs, ibj)
        _same(jbs, jbj)
        tiles = rng.integers(0, 100, (ibs.size, 8, 8)).astype(np.int32)
        for n in (nb * 8, nb * 8 - 3):
            _same(tt.assemble_triangular(tiles, ibs, jbs, nb, n),
                  jt.assemble_triangular(tiles, ibs, jbs, nb, n))


def test_from_reference_round_trips():
    dense = _dense(9, 77, 0.4, seed=5)
    bj = jl.BitMatrix.from_dense(dense)
    jcfg = JaxConfig(k2_tile_rows=32, k2_tile_words=128, k2_variant="concat")
    bt, cfg = tl.from_reference(bj.packed, bj.m_bits, dataclasses.asdict(jcfg))
    _same(bt.packed, bj.packed)
    _same(bt.row_nnz, bj.row_nnz)
    assert (bt.n, bt.m_bits) == (bj.n, bj.m_bits)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert isinstance(cfg, EngineConfig)
    _same(tl.unpack_bits(bt.packed, bt.m_bits), dense)
    _, default = tl.from_reference(bj.packed, bj.m_bits)
    assert dataclasses.asdict(default) == dataclasses.asdict(JaxConfig())
    with pytest.raises(TypeError):
        tl.from_reference(bj.packed, bj.m_bits, {"no_such_field": 1})


def test_device_words_are_int32_bit_views():
    packed = np.array([[0xFFFFFFFF, 0x80000000, 1, 0]], dtype=np.uint32)
    bt = tl.BitMatrix.from_packed(packed, 128)
    t = bt.device_padded(3, device="cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (3, 4)
    _same(t.numpy().view(np.uint32)[:1], packed)
    assert not t[1:].any()
    assert bt.device_padded(3, device="cpu") is t  # cached per (n_pad, device)
    with pytest.raises(ValueError):
        bt.device_padded(0, device="cpu")
    bt.clear_device_cache()
    assert bt.device_padded(3, device="cpu") is not t
