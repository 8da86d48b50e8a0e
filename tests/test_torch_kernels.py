"""The port's kernel modules on the CPU — the K2 wrappers (which take
their plain versions for CPU tensors) and the plain-torch ``xla`` forms —
against the JAX package's, with K2 in Pallas interpret mode. Inputs are
shared numpy arrays; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormtpu.kernels.mxu as jm
import stormtpu.kernels.xla as jx
import stormtpu_torch.kernels.mxu as tm
import stormtpu_torch.kernels.xla as tx
from stormtpu.config import EngineConfig as JaxConfig
from stormtpu.kernels.clustered import clustered_work_fraction as jax_wf
from stormtpu.layout import BitMatrix as JaxBitMatrix
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.kernels.clustered import clustered_work_fraction
from stormtpu_torch.layout import BitMatrix, to_device_words
from stormtpu_torch.oracle import oracle_count_block, oracle_count_matrix
from stormtpu_torch.utils import profiling, round_up, triangular_tile_ids

from conftest import DENSITY_SWEEP


def _words(n, w, density, seed):
    rng = np.random.default_rng(seed)
    if density >= 1.0:
        return np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    bits = rng.random((n, w * 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def _t(words):
    return to_device_words(words, "cpu")


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(port.astype(np.int64), ref.astype(np.int64))


@pytest.mark.parametrize("variant", ("concat", "planes"))
@pytest.mark.parametrize("n,w", [(70, 600), (33, 256)])
def test_k2_tri_plain_equals_jax_interpret(n, w, variant):
    ti, wk = 32, 256
    words = _words(n, w, 0.5, seed=n)
    xp = np.zeros((round_up(n, ti), round_up(w, wk)), np.uint32)
    xp[:n, :w] = words
    ibs, jbs = triangular_tile_ids(xp.shape[0] // ti)
    want = jm.count_tiles_pallas_mxu(
        jnp.asarray(xp), jnp.asarray(ibs), jnp.asarray(jbs),
        tile_rows=ti, tile_words=wk, interpret=True, variant=variant,
    )
    got = tm.count_tiles_pallas_mxu(
        _t(xp), torch.from_numpy(ibs), torch.from_numpy(jbs),
        tile_rows=ti, tile_words=wk, variant=variant,
    )
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("variant", ("concat", "planes"))
def test_k2_rect_plain_equals_jax_interpret(variant):
    ti, wk = 32, 256
    a = np.zeros((64, 512), np.uint32)
    b = np.zeros((96, 512), np.uint32)
    a[:50, :300] = _words(50, 300, 0.3, seed=1)
    b[:70, :300] = _words(70, 300, 0.7, seed=2)
    want = jm._count_block_padded(
        jnp.asarray(a), jnp.asarray(b), tile_rows=ti, tile_words=wk,
        interpret=True, variant=variant,
    )
    got = tm._count_block_padded(_t(a), _t(b), tile_rows=ti, tile_words=wk,
                                 variant=variant)
    _eq(got, want)


@pytest.mark.parametrize("n,w,cfg", [
    (1, 5, EngineConfig()), (37, 300, EngineConfig()),
    (70, 600, EngineConfig(k2_tile_rows=32)),
    (45, 1000, EngineConfig(k2_tile_rows=64, k2_tile_words=128)),
])
def test_k2_tile_walks_equal_jax(n, w, cfg):
    jcfg = JaxConfig(k2_tile_rows=cfg.k2_tile_rows, k2_tile_words=cfg.k2_tile_words)
    words = _words(n, w, 0.4, seed=w)
    assert tm.k2_tile_shape(cfg, n, w) == jm.k2_tile_shape(jcfg, n, w)
    got = tm.count_matrix_pallas_mxu(_t(words), config=cfg)
    want = jm.count_matrix_pallas_mxu(jnp.asarray(words), config=jcfg, interpret=True)
    assert got.dtype == np.int32
    _eq(got, want)
    _eq(got, oracle_count_matrix(words))
    other = _words(n + 3, w, 0.6, seed=w + 1)
    got = tm.count_block_pallas_mxu(_t(words), _t(other), config=cfg)
    want = jm.count_block_pallas_mxu(words, other, config=jcfg, interpret=True)
    _eq(got, want)


def test_k2_tile_shape_grid_equal():
    for rows, words in ((32, 256), (256, 256), (64, 100), (128, 512)):
        cfg = EngineConfig(k2_tile_rows=rows, k2_tile_words=words)
        jcfg = JaxConfig(k2_tile_rows=rows, k2_tile_words=words)
        for n in (1, 31, 33, 255, 257, 1000):
            for w in (1, 7, 8, 100, 256, 257, 5000):
                assert tm.k2_tile_shape(cfg, n, w) == jm.k2_tile_shape(jcfg, n, w)


@pytest.mark.parametrize("density", DENSITY_SWEEP)
def test_xla_forms_equal_jax(density):
    a = _words(13, 40, density, seed=3)
    b = _words(21, 40, density, seed=4)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    assert int(tx.pair_count_xla(ta[0], tb[0])) == int(jx.pair_count_xla(ja[0], jb[0]))
    _eq(tx.pair_count_batch_xla(ta, tb[:13]), jx.pair_count_batch_xla(ja, jb[:13]))
    _eq(tx.count_block_popcount_xla(ta, tb), jx.count_block_popcount_xla(ja, jb))
    _eq(tx.count_block_popcount_xla(ta, tb, tile_rows=5),
        jx.count_block_popcount_xla(ja, jb, tile_rows=5))
    _eq(tx.count_matrix_popcount_xla(ta), jx.count_matrix_popcount_xla(ja))
    _eq(tx.unpack_to_int8(ta), jx.unpack_to_int8(ja))
    _eq(tx.count_block_int8_xla(ta, tb), jx.count_block_int8_xla(ja, jb))
    _eq(tx.count_matrix_int8_xla(ta), jx.count_matrix_int8_xla(ja))
    _eq(tx.count_block_int8_xla(ta, tb), oracle_count_block(a, b))


def test_popcount32_edge_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555,
                      0xAAAAAAAA, 0xF0F0F0F0, 0x00FF00FF], dtype=np.uint32)
    got = tx.popcount32(_t(words[None]))[0].numpy()
    assert got.tolist() == [bin(int(x)).count("1") for x in words]


def test_kernel_wrappers_refuse_bad_geometry():
    xp = _t(np.zeros((64, 16), np.uint32))
    ids = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tm.count_tiles_pallas_mxu(xp, ids, ids, tile_rows=48, tile_words=8)
    with pytest.raises(ValueError):
        tm.count_tiles_pallas_mxu(xp, ids, ids, tile_rows=32, tile_words=12)
    with pytest.raises(ValueError):
        tm.count_tiles_pallas_mxu(xp, ids, ids, tile_rows=32, tile_words=8,
                                  variant="rows")
    with pytest.raises(ValueError):
        tm.count_tiles_pallas_mxu(xp, ids + 2, ids, tile_rows=32, tile_words=8)
    with pytest.raises(ValueError):
        tm.count_tiles_pallas_mxu(xp, ids, ids - 1, tile_rows=32, tile_words=8)
    with pytest.raises(ValueError):
        tm._count_block_padded(xp, _t(np.zeros((64, 24), np.uint32)),
                               tile_rows=32, tile_words=8, variant="planes")


def test_plain_forms_do_not_count_launches():
    tm.reset_launches()
    words = _words(40, 20, 0.5, seed=9)
    tm.count_matrix_pallas_mxu(_t(words))
    tm.count_block_pallas_mxu(_t(words), _t(words))
    xp = torch.zeros((64, 24), dtype=torch.int32)
    xp[:40, :20] = _t(words)
    ids = torch.tensor([0, 0, 1], dtype=torch.int32), torch.tensor([0, 1, 1], dtype=torch.int32)
    tm.count_tiles_topk(xp, *ids, tile_rows=32, tile_words=8, k=4, n_real=40)
    tm.count_tiles_hist(xp, *ids, tile_rows=32, tile_words=8, n_real=40, bin_width=8, n_bins=16)
    assert tm.LAUNCHES == {"k2_tri": 0, "k2_rect": 0, "k2_topk": 0, "k2_hist": 0}


def _rect_operand(kind, words):
    """``words`` (uint32 [n, w]) as int32 laid out as ``kind`` says."""
    x = _t(words)
    n, w = x.shape
    if kind == "whole":
        return x.clone()
    if kind == "rows":  # rows 4.. of a larger matrix: contiguous, at 16·w bytes in
        big = torch.zeros((n + 5, w), dtype=torch.int32)
        big[4 : 4 + n] = x
        return big[4 : 4 + n]
    if kind == "row1":  # from row 1: contiguous, 4·w bytes in
        big = torch.zeros((n + 1, w), dtype=torch.int32)
        big[1:] = x
        return big[1:]
    if kind == "columns":  # the first w words of wider rows: not contiguous
        big = torch.zeros((n, w + 4), dtype=torch.int32)
        big[:, :w] = x
        return big[:, :w]
    if kind == "offset":  # contiguous, 4 bytes past an aligned address
        flat = torch.zeros(n * w + 1, dtype=torch.int32)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(n, w)
    if kind == "int64":  # the same words, not int32
        return x.to(torch.int64)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,w,as_is,words", [
    ("whole", 36, True, 36),
    ("whole", 8196, True, 8196),
    ("rows", 4, True, 4),
    ("row1", 36, True, 36),         # 144 bytes in: still aligned
    ("whole", 10, False, 12),       # the words alone padded, to a multiple of 4
    ("rows", 1, False, 4),
    ("rows", 10, False, 12),
    ("row1", 10, False, 12),        # 40 bytes in
    ("columns", 36, False, 36),     # copied, the words already a multiple of 4
    ("columns", 10, False, 12),
    ("offset", 36, False, 36),
    ("int64", 36, False, 36),
])
def test_rect_operand_follows_the_operands_layout(kind, w, as_is, words):
    """K2-rect's card route takes a contiguous, 16-byte aligned int32
    operand with W % 4 == 0 as it is; any other is copied to int32
    [n, round_up(W, 4)], its words zero-padded and its rows never."""
    src = _words(7, w, 0.5, seed=w)
    x = _rect_operand(kind, src)
    with profiling.record() as rec:
        got = tm.rect_operand(x)
    assert (got is x) == as_is
    assert got.dtype == torch.int32 and got.is_contiguous() and got.shape == (7, words)
    assert got.data_ptr() % 16 == 0
    want = np.zeros((7, words), np.uint32)
    want[:, :w] = src
    _eq(got.view(torch.int32), want.view(np.int32))
    pads = sum(s.name == "stpu.kernels.pad" for s in rec.spans)
    assert rec.counters.get("pad_bytes", 0) == (0 if as_is else 4 * 7 * words)
    assert pads == (0 if as_is else 1)


@pytest.mark.parametrize("na,nb,w,kind_a,kind_b", [
    (1, 1, 4, "whole", "whole"),
    (64, 255, 36, "whole", "whole"),
    (65, 257, 10, "whole", "whole"),
    (3, 2, 1, "whole", "whole"),
    (65, 257, 36, "columns", "whole"),
    (7, 9, 36, "whole", "offset"),
])
def test_rect_card_route_pads_words_only(monkeypatch, na, nb, w, kind_a, kind_b):
    """The card route's Python side, its launch replaced by the plain
    product: true rows, an operand copied only when it cannot go in as it
    is and then its words padded to a multiple of 4, an output pitch of
    round_up(Nb, 4) whose spare columns are never returned, and its
    counters."""
    launched = []

    def launch(name, a, b, out):
        assert a.is_contiguous() and b.is_contiguous() and out.is_contiguous()
        launched.append((a.shape, b.shape, out.shape))
        out.fill_(-1)
        out[:, : b.shape[0]] = tm.count_block_plain(a, b, tile_words=a.shape[1])

    monkeypatch.setattr(tm, "_rect_launch", launch)
    a, b = _words(na, w, 0.5, seed=na), _words(nb, w, 0.5, seed=nb + 1)
    ta, tb = _rect_operand(kind_a, a), _rect_operand(kind_b, b)
    words = round_up(w, 4)
    with profiling.record() as rec:
        got = tm._count_block_card(ta, tb)
    assert launched == [((na, words), (nb, words), (na, round_up(nb, 4)))]
    assert got.shape == (na, nb) and got.stride() == (round_up(nb, 4), 1)
    _eq(got, oracle_count_block(a, b))
    copied = [n for n, kind in ((na, kind_a), (nb, kind_b)) if words != w or kind != "whole"]
    assert rec.counters["pad_bytes"] == 4 * words * sum(copied)
    assert sum(s.name == "stpu.kernels.pad" for s in rec.spans) == len(copied)
    assert rec.counters.get("rect_unpadded", 0) == (0 if copied else 1)


def test_rect_card_route_counts_rows_of_no_words_without_a_launch(monkeypatch):
    """Rows of no words (M = 0) count 0 on the card route, with no launch:
    the kernel takes no zero-word operand."""
    def launch(*_):
        raise AssertionError("launched")

    monkeypatch.setattr(tm, "_rect_launch", launch)
    got = tm._count_block_card(torch.zeros((3, 0), dtype=torch.int32),
                               torch.zeros((5, 0), dtype=torch.int32))
    assert got.shape == (3, 5) and not bool(got.any())


@pytest.mark.parametrize("na,cluster", [
    (1, 1), (64, 1), (128, 1),      # one sub-tile row of A: blocks alone
    (129, 2), (200, 2), (256, 2),   # two: a cluster of two shares each B tile
    (384, 1),                       # three: blocks alone, side by side
    (512, 2),
])
def test_rect_shape_rule_picks_the_body_by_na(monkeypatch, na, cluster):
    """K2-rect's shape rule depends on Na alone, and the wrapper hands the
    library what it says: ``k2_rect_tma_launch`` at every Na, with the
    rule's cluster; ``rect_shared_b`` counts the launches in clusters of
    two."""
    assert tm.rect_cluster(na) == cluster
    calls = []
    monkeypatch.setattr(tm, "_launch",
                        lambda source, entry, device, *args: calls.append((source, entry, args)))
    a, b = torch.zeros((na, 8), dtype=torch.int32), torch.zeros((5, 8), dtype=torch.int32)
    out = torch.zeros((na, 8), dtype=torch.int32)
    tm.reset_launches()
    with profiling.record() as rec:
        tm._rect_launch("rule", a, b, out)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), na, 5, 8, 8, cluster)
    assert calls == [("k2_mxu", "k2_rect_tma_launch", args)]
    assert tm.LAUNCHES["k2_rect"] == 1
    assert rec.counters.get("rect_shared_b", 0) == (1 if cluster == 2 else 0)


def _strided(x):
    return torch.zeros((x.shape[0], x.shape[1] + 4), dtype=torch.int32)[:, : x.shape[1]]


def _offset(x):
    return torch.zeros(x.numel() + 1, dtype=torch.int32)[1:].view(x.shape)


def _rows(n):
    """n rows of 8 zero words as a view of one row: no memory of its own."""
    return torch.zeros(8, dtype=torch.int32).expand(n, 8)


@pytest.mark.parametrize("case,error,match", [
    ("na_past_grid", ValueError, "grid limit"),
    ("na_at_grid", ValueError, "operand must be contiguous"),  # past the grid check
    ("nb_past_rows", ValueError, "grid limit"),
    ("blocks_past_grid", ValueError, "grid limit"),
    ("words_10", ValueError, "multiples of 4"),
    ("words_differ", ValueError, "multiples of 4"),
    ("int64", TypeError, "int32"),
    ("strided_a", ValueError, "operand must be contiguous"),
    ("offset_b", ValueError, "aligned"),
    ("odd_pitch", ValueError, "ldo even"),
])
def test_rect_launch_refuses_what_the_kernel_does_not_take(monkeypatch, case, error, match):
    """The K2-rect wrapper raises before any launch on what
    ``k2_rect_tma_launch`` refuses: a row coordinate of A or B past int32
    (Na + 128, Nb + 256 ≥ 2³¹), ceil(Na / 128) · ceil(Nb / 256) blocks past
    int32, rows whose words are not a multiple of 4 (``rect_operand``'s
    copy pads them; bare operands are refused), unequal words, an operand
    that is not contiguous, 16-byte aligned int32, and an output pitch that
    is odd."""
    def launch(*_):
        raise AssertionError("launched")

    monkeypatch.setattr(tm, "_launch", launch)
    a, b = torch.zeros((3, 8), dtype=torch.int32), torch.zeros((5, 8), dtype=torch.int32)
    limit = (1 << 31) - tm.RECT_BLOCK_ROWS  # the first Na refused
    out = None
    a, b = {
        "na_past_grid": (_rows(limit), b),
        "na_at_grid": (_rows(limit - 1), b),
        "nb_past_rows": (a, _rows((1 << 31) - 256)),
        # 65,535 sub-tile rows of A x 32,769 B tiles: 2^31 + 65,535 blocks
        "blocks_past_grid": (_rows(65535 * 128), _rows(32769 * 256)),
        "words_10": (torch.zeros((3, 10), dtype=torch.int32),
                     torch.zeros((5, 10), dtype=torch.int32)),
        "words_differ": (a, b[:, :4].contiguous()),
        "int64": (a.to(torch.int64), b),
        "strided_a": (_strided(a), b),
        "offset_b": (a, _offset(b)),
        "odd_pitch": (a, b),
    }[case]
    if case == "odd_pitch":
        out = torch.zeros((3, 7), dtype=torch.int32)
    elif a.shape[0] < 8:  # a contiguous output: only the operand checks can refuse
        out = torch.zeros((a.shape[0], 8), dtype=torch.int32)
    else:  # an output at these Na would hold gigabytes: a view of one row
        out = _rows(a.shape[0])
    tm.reset_launches()
    with pytest.raises(error, match=match):
        tm._rect_launch("refuse", a, b, out)
    assert tm.LAUNCHES["k2_rect"] == 0


def test_tile_padded_form_takes_cpu_operands_only():
    """``_count_block_padded`` is the plain version's padded form: it
    refuses operands on any other device, and names the card route."""
    x = torch.zeros((64, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="count_block_pallas_mxu"):
        tm._count_block_padded(x, x, tile_rows=32, tile_words=8, variant="planes")


@pytest.mark.parametrize("kind", ("whole", "columns"))
def test_cpu_operands_take_the_tile_padded_form(kind):
    """On the CPU every operand, laid out as it may be, is padded to the
    K2 tile for the plain version; the card route's counter stays 0."""
    a, b = _words(40, 36, 0.5, seed=1), _words(70, 36, 0.5, seed=2)
    ad = _rect_operand(kind, a)
    ti, wk = tm.k2_tile_shape(EngineConfig(), 70, 36)
    with profiling.record() as rec:
        got = tm.count_block_pallas_mxu(ad, _t(b))
    _eq(got, oracle_count_block(a, b))
    assert rec.counters["pad_bytes"] == 4 * round_up(36, wk) * (round_up(40, ti) + round_up(70, ti))
    assert "rect_unpadded" not in rec.counters


@pytest.mark.parametrize("clustered", (False, True))
def test_clustered_work_fraction_equal(clustered):
    rng = np.random.default_rng(7)
    n, m = 96, 64 * 32 * 8
    dense = (rng.random((n, m)) < 0.3).astype(np.uint8)
    if clustered:  # block-diagonal: each row block occupies its own K-groups
        mask = np.zeros_like(dense)
        for blk in range(3):
            mask[blk * 32:(blk + 1) * 32, blk * 4096:(blk + 1) * 4096] = 1
        dense &= mask
    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
    jcfg = JaxConfig(k2_tile_rows=32, k2_tile_words=128)
    jb = JaxBitMatrix.from_dense(dense)
    assert clustered_work_fraction(BitMatrix.from_packed(jb.packed, m), cfg) == \
        jax_wf(jb, jcfg)
