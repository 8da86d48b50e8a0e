"""The port's CUDA kernels (K2 with its top-k and histogram epilogues, K5,
K1, K0, K4's emission and mirror) against their plain PyTorch versions,
on the card.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip. On the
card run them without the JAX package's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Counts are integers, so every comparison is exact equality.
"""

import functools

import numpy as np
import pytest
import torch

from stormtpu_torch import BitMatrix, intersect_count_matrix, count_block
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.kernels import clustered, dense, launch_counts, mxu, reset_launches
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.utils import profiling
from stormtpu_torch.oracle import oracle_count_block, oracle_count_matrix
from stormtpu_torch.utils import (
    assemble_triangular,
    assemble_triangular_torch,
    round_up,
    triangular_tile_ids,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _static_routing(tmp_path, monkeypatch):
    """Pin an absent tuning cache: the card then routes by the untuned rule
    (K2 at every M: ``kernels.plain_product_max_bits`` is 0 on a card).
    The tests of the tuned routing below write their own cache."""
    from stormtpu_torch import tuning

    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "untuned.json"))


def _words(n, w, density, seed):
    rng = np.random.default_rng(seed)
    if density >= 1.0:
        return np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    bits = rng.random((n, w * 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


@pytest.mark.parametrize("density", (0.001, 0.5, 1.0))
@pytest.mark.parametrize("n,w,ti,wk", [
    (37, 33, 64, 40), (300, 300, 256, 256), (70, 129, 32, 128), (129, 16, 160, 8),
])
def test_k2_tri_kernel_equals_plain(cuda, n, w, ti, wk, density):
    packed = _words(n, w, density, seed=n + w)
    n_pad, w_pad = round_up(n, ti), round_up(w, wk)
    xp = np.zeros((n_pad, w_pad), np.uint32)
    xp[:n, :w] = packed
    ibs, jbs = triangular_tile_ids(n_pad // ti)
    args = (to_device_words(xp, cuda), torch.from_numpy(ibs).to(cuda),
            torch.from_numpy(jbs).to(cuda))
    got = mxu.count_tiles_pallas_mxu(*args, tile_rows=ti, tile_words=wk)
    want = mxu.count_tiles_plain(*args, tile_rows=ti, tile_words=wk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("density", (0.001, 0.5, 1.0))
@pytest.mark.parametrize("na,nb,w,ti,wk", [
    (37, 300, 33, 64, 40), (256, 384, 300, 128, 256), (32, 32, 8, 32, 8),
])
def test_k2_rect_kernel_equals_plain(cuda, na, nb, w, ti, wk, density):
    a = _words(na, w, density, seed=na)
    b = _words(nb, w, density, seed=nb + 1)
    w_pad = round_up(w, wk)
    ap = np.zeros((round_up(na, ti), w_pad), np.uint32)
    bp = np.zeros((round_up(nb, ti), w_pad), np.uint32)
    ap[:na, :w] = a
    bp[:nb, :w] = b
    ta, tb = to_device_words(ap, cuda), to_device_words(bp, cuda)
    got = mxu.count_block_pallas_mxu(ta, tb)
    want = mxu.count_block_plain(ta, tb, tile_words=wk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy()[:na, :nb], oracle_count_block(a, b))


@functools.lru_cache(maxsize=None)
def _ragged_operands(w):
    """The largest A and B of the ragged grid at w words (uniform random
    words) and their exact counts: each case takes leading rows of both."""
    rng = np.random.default_rng(w)
    a = rng.integers(0, 1 << 32, (max(RAGGED_NA), w), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (max(RAGGED_NB), w), dtype=np.uint32)
    return a, b, oracle_count_block(a, b)


RAGGED_NA = (1, 63, 64, 65, 129, 300)
RAGGED_NB = (1, 2, 255, 257, 1001)


@pytest.mark.parametrize("w", (4, 36, 8196, 10))
@pytest.mark.parametrize("nb", RAGGED_NB)
@pytest.mark.parametrize("na", RAGGED_NA)
def test_k2_rect_takes_ragged_operands_as_they_are(cuda, na, nb, w):
    """K2-rect's card route at true Na and Nb: nothing padded when
    W % 4 == 0 (no pad span, ``pad_bytes`` 0, every launch counted by
    ``rect_unpadded``), only the words otherwise (W = 10)."""
    a, b, full = _ragged_operands(w)
    a, b, want = a[:na], b[:nb], full[:na, :nb]
    ad, bd = to_device_words(a, cuda), to_device_words(b, cuda)
    mxu.reset_launches()
    with profiling.record() as rec:
        got = mxu.count_block_pallas_mxu(ad, bd)
    assert got.shape == (na, nb)
    assert np.array_equal(got.cpu().numpy(), want)
    as_is = w % 4 == 0
    pads = sum(s.name == "stpu.kernels.pad" for s in rec.spans)
    assert mxu.LAUNCHES["k2_rect"] == 1
    if as_is:
        assert rec.counters["pad_bytes"] == 0 and pads == 0
        assert rec.counters["rect_unpadded"] == mxu.LAUNCHES["k2_rect"]
    else:
        assert rec.counters["pad_bytes"] == 4 * (na + nb) * round_up(w, 4) and pads == 2
        assert "rect_unpadded" not in rec.counters


@pytest.mark.parametrize("kind", ("columns", "offset"))
def test_k2_rect_copies_the_words_of_what_it_cannot_take(cuda, kind):
    """A card operand that is not contiguous, or not 16-byte aligned, is
    copied with its words alone (its rows kept): the same counts, one pad
    of that operand's bytes, no ``rect_unpadded``."""
    a, b, _ = _ragged_operands(36)
    a, b = a[:65], b[:257, :32]
    ad, bd = to_device_words(a, cuda)[:, :32], to_device_words(b, cuda)
    if kind == "offset":
        buf = torch.zeros(ad.numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = ad.reshape(-1)
        ad = buf[1:].view(ad.shape)
    want = oracle_count_block(a[:, :32], b)
    mxu.reset_launches()
    with profiling.record() as rec:
        got = mxu.count_block_pallas_mxu(ad, bd)
    assert np.array_equal(got.cpu().numpy(), want)
    assert mxu.LAUNCHES["k2_rect"] == 1
    assert rec.counters["pad_bytes"] == 4 * 65 * 32
    assert sum(s.name == "stpu.kernels.pad" for s in rec.spans) == 1
    assert "rect_unpadded" not in rec.counters


RECT_TMA_NA = (3, 127, 128, 129, 200, 256, 384, 512)
RECT_TMA_NB = (1, 255, 257, 4099)


@functools.lru_cache(maxsize=None)
def _tma_rect_case(w):
    """A [512, w] and B [4099, w] on the card as row views of larger
    matrices (rows 3.. and 5..: the ring's ``x_local[b0:b0 + 256]``), and
    their counts by the plain version: each case takes leading rows."""
    rng = np.random.default_rng(w + 20)
    dev = torch.device("cuda")
    na, nb = max(RECT_TMA_NA), max(RECT_TMA_NB)
    a = to_device_words(rng.integers(0, 1 << 32, (na + 5, w), dtype=np.uint32), dev)[3 : 3 + na]
    b = to_device_words(rng.integers(0, 1 << 32, (nb + 7, w), dtype=np.uint32), dev)[5 : 5 + nb]
    return a, b, mxu.count_block_plain(a, b, tile_words=min(w, 1024))


@pytest.mark.parametrize("w", (4, 36, 8192))
@pytest.mark.parametrize("nb", RECT_TMA_NB)
@pytest.mark.parametrize("na", RECT_TMA_NA)
def test_k2_rect_tma_body_equals_plain_at_ragged_shapes(cuda, na, nb, w):
    """K2-rect at one sub-tile row of A (the lookups' shape) and past it
    (clusters of two at an even sub-tile row count, else of one) equals
    the plain version exactly at ragged Na, Nb and W, on views at row
    offsets taken as they are; at an even count the TMA body in clusters
    of one gives the same counts."""
    a, b, want = _tma_rect_case(w)
    a, b, want = a[:na], b[:nb], want[:na, :nb]
    mxu.reset_launches()
    with profiling.record() as rec:
        got = mxu.count_block_pallas_mxu(a, b)
    assert torch.equal(got, want)
    assert mxu.LAUNCHES["k2_rect"] == 1 and rec.counters["rect_unpadded"] == 1
    cluster = mxu.rect_cluster(na)
    assert rec.counters.get("rect_shared_b", 0) == (1 if cluster == 2 else 0)
    if cluster == 2:
        from stormtpu_torch.kernels._build import library

        alone = torch.empty((na, round_up(nb, mxu.RECT_WORD_ALIGN)), dtype=torch.int32,
                            device=cuda)
        assert library("k2_mxu").k2_rect_tma_launch(
            a.data_ptr(), b.data_ptr(), alone.data_ptr(), na, nb, w, alone.shape[1], 1,
            torch.cuda.current_stream().cuda_stream) == 0
        assert torch.equal(alone[:, :nb], want)


def test_rect_shared_b_counts_each_paired_launch(cuda):
    """One ``rect_shared_b`` a K2-rect launch in clusters of two, none for
    clusters of one (one and three sub-tile rows)."""
    a, b, want = _tma_rect_case(36)
    mxu.reset_launches()
    with profiling.record() as rec:
        for na in (64, 129, 256, 384, 512, 128):
            assert torch.equal(mxu.count_block_pallas_mxu(a[:na], b[:257]), want[:na, :257])
    assert mxu.LAUNCHES["k2_rect"] == rec.counters["rect_unpadded"] == 6
    assert rec.counters["rect_shared_b"] == 3


def test_k2_rect_tma_launcher_refuses_what_it_does_not_take(cuda):
    """``k2_rect_tma_launch`` returns cudaErrorInvalidValue (1), launching
    nothing, for a cluster the shape cannot pair (two over three sub-tile
    rows; 0; 3), a row of 6 words, a base 4 bytes off, an odd output pitch
    and a pitch with no spare column for an odd Nb; the library's block
    rows are the shape rule's."""
    from stormtpu_torch.kernels._build import library

    lib = library("k2_mxu")
    assert lib.k2_block_rows() == mxu.RECT_BLOCK_ROWS
    x = torch.zeros((384, 8), dtype=torch.int32, device=cuda)
    out = torch.full((384, 8), -7, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    p, o = x.data_ptr(), out.data_ptr()
    for args in ((p, p, o, 384, 8, 8, 8, 2), (p, p, o, 256, 8, 8, 8, 0),
                 (p, p, o, 256, 8, 8, 8, 3), (p, p, o, 256, 8, 6, 8, 2),
                 (p + 4, p, o, 256, 8, 8, 8, 2), (p, p + 4, o, 256, 8, 8, 8, 2),
                 (p, p, o, 256, 7, 8, 7, 2), (p, p, o, 256, 7, 8, 6, 2)):
        assert lib.k2_rect_tma_launch(*args, stream) == 1, args
    torch.cuda.synchronize()
    assert bool((out == -7).all())


def test_entry_points_on_card_launch_the_kernels(cuda):
    rng = np.random.default_rng(5)
    m = (1 << 17) + 77
    dense = (rng.random((70, m)) < 0.3).astype(np.uint8)
    bm = BitMatrix.from_dense(dense)
    cfg = EngineConfig(k2_tile_rows=32)
    mxu.reset_launches()
    got = intersect_count_matrix(bm, config=cfg)
    assert np.array_equal(got, oracle_count_matrix(bm.packed))
    blk = count_block(bm, BitMatrix.from_dense(dense[:9]), config=cfg)
    assert np.array_equal(blk, oracle_count_block(bm.packed, bm.packed[:9]))
    assert mxu.LAUNCHES["k2_tri"] == 1 and mxu.LAUNCHES["k2_rect"] == 1


@pytest.mark.parametrize("strategy", ("popcount", "mxu", "pallas_mxu"))
def test_strategies_on_card_equal_oracle(cuda, strategy):
    rng = np.random.default_rng(6)
    bm = BitMatrix.from_dense((rng.random((45, 2000)) < 0.4).astype(np.uint8))
    got = intersect_count_matrix(bm, strategy=strategy)
    assert np.array_equal(got, oracle_count_matrix(bm.packed))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    xp = torch.zeros((64, 16), dtype=torch.int32, device=cuda)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        mxu.count_tiles_pallas_mxu(xp.float(), ids, ids, tile_rows=32, tile_words=8)
    with pytest.raises(ValueError):
        mxu.count_tiles_pallas_mxu(xp, ids.cpu(), ids, tile_rows=32, tile_words=8)
    with pytest.raises(ValueError):
        mxu.count_tiles_pallas_mxu(xp, ids, ids, tile_rows=48, tile_words=8)


def _block_diagonal(n, m, n_blocks, density, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, m), np.uint8)
    rows = np.linspace(0, n, n_blocks + 1).astype(int)
    cols = np.linspace(0, m, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        d[rows[b]:rows[b + 1], cols[b]:cols[b + 1]] = (
            rng.random((rows[b + 1] - rows[b], cols[b + 1] - cols[b])) < density)
    return BitMatrix.from_dense(d)


@pytest.mark.parametrize("n,m,blocks,cfg", [
    (70, 13000, 2, EngineConfig(k2_tile_rows=32, k2_tile_words=128)),
    (301, 100_003, 6, EngineConfig(k2_tile_rows=160, k2_tile_words=128)),
    (1000, 300_007, 5, EngineConfig()),
])
def test_k5_kernel_equals_plain(cuda, n, m, blocks, cfg):
    bm = _block_diagonal(n, m, blocks, 0.3, seed=n)
    plan = clustered.build_clustered_plan(bm, cfg)
    xp = np.zeros((plan.n_pad, plan.w_pad), np.uint32)
    xp[:n, : bm.n_words] = bm.packed
    args = [to_device_words(xp, cuda)] + [
        torch.from_numpy(a).to(cuda)
        for a in (plan.ibs_w, plan.jbs_w, plan.gsel_w, plan.slots_w, plan.first_w)]
    kw = dict(n_slots=plan.n_slots, tile_rows=plan.ti, tile_words=plan.wk)
    got = clustered.count_tiles_worklist(*args, **kw)
    want = clustered.count_tiles_worklist_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("density", (0.001, 0.5, 1.0))
@pytest.mark.parametrize("n,w,ti,wk", [(37, 300, 40, 128), (130, 513, 128, 4), (9, 64, 8, 64)])
def test_k1_kernel_equals_plain(cuda, n, w, ti, wk, density):
    packed = _words(n, w, density, seed=n + w)
    xp = np.zeros((round_up(n, ti), round_up(w, wk)), np.uint32)
    xp[:n, :w] = packed
    ibs, jbs = triangular_tile_ids(xp.shape[0] // ti)
    args = (to_device_words(xp, cuda), torch.from_numpy(ibs).to(cuda),
            torch.from_numpy(jbs).to(cuda))
    got = dense.count_tiles_pallas_dense(*args, tile_rows=ti, tile_words=wk)
    want = dense.count_tiles_dense_plain(*args, tile_rows=ti, tile_words=wk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _k1_tile_list(nb, order, seed):
    """A K1 tile list over nb row blocks: the whole triangle i-major (every
    run of equal ibs but one is cut into pairs), that list shuffled (most
    tiles then run alone), or with its last tile dropped (odd length)."""
    ibs, jbs = triangular_tile_ids(nb)
    if order == "shuffled":
        perm = np.random.default_rng(seed).permutation(ibs.size)
        ibs, jbs = ibs[perm], jbs[perm]
    elif order == "odd":
        keep = ibs.size - 1 if ibs.size % 2 == 0 else ibs.size - 2
        ibs, jbs = ibs[:keep], jbs[:keep]
        assert ibs.size % 2 == 1
    return np.ascontiguousarray(ibs), np.ascontiguousarray(jbs)


@pytest.mark.parametrize("order", ("i-major", "shuffled", "odd"))
@pytest.mark.parametrize("ti", (8, 40, 128, 136))
def test_k1_kernel_tile_sizes_and_tile_lists_equal_plain(cuda, ti, order):
    """K1 pairs tiles that share their A rows. TI = 8 and 40 fill part of a
    block's half, 128 all of it, 136 takes two sub-tile rows (the second 8
    rows tall); a shuffled list leaves most tiles without a partner."""
    nb, w, wk = 5, 72, 24
    xp = np.zeros((nb * ti, w), np.uint32)
    xp[: nb * ti - 3, :70] = _words(nb * ti - 3, 70, 0.5, seed=ti)
    ibs, jbs = _k1_tile_list(nb, order, seed=ti)
    args = (to_device_words(xp, cuda), torch.from_numpy(ibs).to(cuda),
            torch.from_numpy(jbs).to(cuda))
    got = dense.count_tiles_pallas_dense(*args, tile_rows=ti, tile_words=wk)
    want = dense.count_tiles_dense_plain(*args, tile_rows=ti, tile_words=wk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    units = dense.pair_units(args[1])
    leads = units[units >= 0].cpu().numpy()
    assert np.array_equal(leads, _brute_force_leads(ibs))


def _brute_force_leads(ibs):
    leads, t = [], 0
    while t < len(ibs):
        leads.append(t)
        t += 2 if t + 1 < len(ibs) and ibs[t + 1] == ibs[t] else 1
    return np.asarray(leads, dtype=np.int32)


def test_k1_all_ones_at_the_int32_edge(cuda):
    m = 1 << 27
    ones = torch.full((128, m // 32), -1, dtype=torch.int32, device=cuda)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = dense.count_tiles_pallas_dense(ones, ids, ids, tile_rows=128, tile_words=2048)
    assert bool((got == m).all())


def test_k1_build_has_no_spills(cuda):
    from stormtpu_torch.kernels._build import kernel_resources

    used = kernel_resources("k1_dense")
    assert any("k1_pair_kernel" in sym for sym in used)
    assert all(v["spill_bytes"] == 0 for v in used.values())


def test_k5_checked_worklist_launches_without_a_read_back(cuda, monkeypatch):
    cfg = EngineConfig(k2_tile_rows=160, k2_tile_words=128)
    bm = _block_diagonal(301, 100_003, 6, 0.3, seed=11)
    plan = clustered.build_clustered_plan(bm, cfg)
    packed = clustered.device_operand(bm, plan, cuda)
    work = clustered.device_worklist(plan, cuda)
    kw = dict(n_slots=plan.slot_ibs.size, tile_rows=plan.ti, tile_words=plan.wk)
    want = clustered.count_tiles_worklist_plain(packed, *work, **kw)
    bare = clustered.count_tiles_worklist(packed, *work, **kw)

    def no_read_back(*a, **k):
        raise AssertionError("the checked route read the work list back")

    monkeypatch.setattr(clustered, "_slot_starts", no_read_back)
    got = clustered.count_tiles_worklist(packed, *work, checked=work, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(bare, want)
    clones = [t.clone() for t in work]
    with pytest.raises(ValueError, match="other work-list tensors"):
        clustered.count_tiles_worklist(packed, *clones, checked=work, **kw)
    work.tensors[3].add_(0)  # an in-place write, whatever it wrote
    with pytest.raises(ValueError, match="written to"):
        clustered.count_tiles_worklist(packed, *work, checked=work, **kw)


@pytest.mark.parametrize("bad", ("unsorted", "first", "range"))
def test_k5_bad_worklist_raises_on_the_card(cuda, bad):
    import dataclasses

    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
    bm = _block_diagonal(100, 9000, 2, 0.35, seed=7)
    plan = clustered.build_clustered_plan(bm, cfg)
    k = plan.n_work
    swap = {
        "unsorted": dict(slots_w=np.concatenate([plan.slots_w[:k][::-1], plan.slots_w[k:]])),
        "first": dict(first_w=np.concatenate([[0], plan.first_w[1:]]).astype(np.int32)),
        "range": dict(gsel_w=np.full_like(plan.gsel_w, plan.ng + 1)),
    }[bad]
    broken = dataclasses.replace(plan, **swap)
    with pytest.raises(ValueError):
        clustered.device_worklist(broken, cuda)
    packed = clustered.device_operand(bm, plan, cuda)
    arrays = [torch.from_numpy(np.ascontiguousarray(a[:k])).to(cuda) for a in (
        broken.ibs_w, broken.jbs_w, broken.gsel_w, broken.slots_w, broken.first_w)]
    with pytest.raises(ValueError):
        clustered.count_tiles_worklist(packed, *arrays, n_slots=plan.slot_ibs.size,
                                       tile_rows=plan.ti, tile_words=plan.wk)


@pytest.mark.parametrize("salt", (0, 0xDEADBEEF))
@pytest.mark.parametrize("r,w", [(37, 1001), (1000, 4096), (3, 5)])
def test_k0_kernel_equals_plain(cuda, r, w, salt):
    a = to_device_words(_words(r, w, 0.5, seed=r), cuda)
    b = to_device_words(_words(r, w, 0.5, seed=w), cuda)
    got = dense.pair_count_stream_pallas(a, b, salt=salt)
    want = dense.pair_count_stream_plain(a, b, salt=salt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_clustered_and_dense_entry_points_launch_their_kernels(cuda):
    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
    bm = _block_diagonal(96, 16384, 3, 0.3, seed=7)
    reset_launches()
    got = intersect_count_matrix(bm, config=cfg)
    assert np.array_equal(got, oracle_count_matrix(bm.packed))
    assert launch_counts()["k5"] == 1 and launch_counts()["k2_tri"] == 0
    got = intersect_count_matrix(bm, strategy="pallas_dense", config=cfg)
    assert np.array_equal(got, oracle_count_matrix(bm.packed))
    assert launch_counts()["k1"] == 1


def _full_worklist(nb, ng, device):
    """Every (upper-triangular tile pair, K-group) as a sorted work list:
    (ibs, jbs, gsel, slots, first) and the number of slots."""
    pairs = [(i, j, g) for i in range(nb) for j in range(i, nb) for g in range(ng)]
    cols = ([p[0] for p in pairs], [p[1] for p in pairs], [p[2] for p in pairs],
            [k // ng for k in range(len(pairs))], [int(k % ng == 0) for k in range(len(pairs))])
    return [torch.tensor(c, dtype=torch.int32, device=device) for c in cols], len(pairs) // ng


@pytest.mark.parametrize("density", (0.001, 0.5, 1.0))
@pytest.mark.parametrize("steps", (1, 3))
@pytest.mark.parametrize("wk", (8, 256))
@pytest.mark.parametrize("ti", (32, 160, 256))
@pytest.mark.parametrize("n", (37, 2053))
def test_k2_body_through_all_wrappers_equals_plain(cuda, n, ti, wk, steps, density):
    """The tile body the wrappers launch, through K2-tri, K2-rect and K5, at
    small, odd and full tile rows, the smallest and the default K step, a
    width of one K step and of several, and N below and above one tile."""
    w = wk * steps
    packed = _words(n, w, density, seed=n + ti + wk)
    xp = np.zeros((round_up(n, ti), w), np.uint32)
    xp[:n] = packed
    nb = xp.shape[0] // ti
    ibs, jbs = triangular_tile_ids(nb)
    x = to_device_words(xp, cuda)
    ids = (torch.from_numpy(ibs).to(cuda), torch.from_numpy(jbs).to(cuda))
    want = mxu.count_tiles_plain(x, *ids, tile_rows=ti, tile_words=wk)
    got = mxu.count_tiles_pallas_mxu(x, *ids, tile_rows=ti, tile_words=wk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    a = x[: min(x.shape[0], 2 * ti)]
    got = mxu.count_block_pallas_mxu(a, x)
    torch.cuda.synchronize()
    assert torch.equal(got, mxu.count_block_plain(a, x, tile_words=wk))
    if nb <= 16:  # the plain work list walks its items one by one in Python
        work, n_slots = _full_worklist(nb, steps, cuda)
        got = clustered.count_tiles_worklist(x, *work, n_slots=n_slots, tile_rows=ti,
                                             tile_words=wk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)  # all groups of every pair: K2's tiles


def test_k2_body_all_ones_at_the_int32_edge(cuda):
    m = 1 << 27
    ones = torch.full((128, m // 32), -1, dtype=torch.int32, device=cuda)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = mxu.count_tiles_pallas_mxu(ones, ids, ids, tile_rows=128, tile_words=256)
    assert bool((got == m).all())
    got = mxu.count_block_pallas_mxu(ones[:32], ones)
    assert bool((got == m).all())
    ng = ones.shape[1] // 256
    zeros = torch.zeros(ng, dtype=torch.int32, device=cuda)
    first = zeros.clone()
    first[0] = 1
    got = clustered.count_tiles_worklist(
        ones, zeros, zeros, torch.arange(ng, dtype=torch.int32, device=cuda), zeros, first,
        n_slots=1, tile_rows=128, tile_words=256)
    assert bool((got == m).all())


def test_tile_body_at_odd_tile_rows_equals_plain_and_the_build_has_no_spills(cuda):
    """K2-tri, K5 and K2-rect at odd tile rows and a K step that is no
    multiple of a chunk; the library holds one kernel a form."""
    from stormtpu_torch.kernels._build import kernel_resources

    used = kernel_resources("k2_mxu")
    # k2_tri and k5 on the tile body, k2_rect on the TMA body in clusters
    # of one and two
    assert len(used) == 4
    assert len([s for s in used if "k2_rect_tma_kernel" in s]) == 2
    assert all(v["spill_bytes"] == 0 for v in used.values())
    from stormtpu_torch.kernels import _build

    log = _build._target("k2_mxu").with_suffix(".log").read_text()
    assert "setmaxnreg ignored" not in log
    assert "C7515" not in log and "C7517" not in log  # no product waits on the one before
    xp = np.zeros((320, 72), np.uint32)
    xp[:300, :70] = _words(300, 70, 0.5, seed=3)
    x = to_device_words(xp, cuda)
    ibs, jbs = triangular_tile_ids(2)
    ids = (torch.from_numpy(ibs).to(cuda), torch.from_numpy(jbs).to(cuda))
    want = mxu.count_tiles_plain(x, *ids, tile_rows=160, tile_words=24)
    work, n_slots = _full_worklist(2, 3, cuda)
    got = mxu.count_tiles_pallas_mxu(x, *ids, tile_rows=160, tile_words=24)
    assert torch.equal(got, want)
    got = clustered.count_tiles_worklist(x, *work, n_slots=n_slots, tile_rows=160,
                                         tile_words=24)
    assert torch.equal(got, want)
    got = mxu.count_block_pallas_mxu(x[:160], x)
    assert torch.equal(got, mxu.count_block_plain(x[:160], x, tile_words=24))


def test_download_bounds_the_page_locked_bytes_of_live_results(cuda, monkeypatch):
    from stormtpu_torch.utils import download, tiling

    t = torch.arange(1 << 16, dtype=torch.int32, device=cuda).view(256, 256)  # 256 KiB
    monkeypatch.setattr(tiling, "PINNED_RESULT_BYTES_MAX", 2 * (1 << 18))
    base = tiling._pinned_live_bytes
    held = [download(t) for _ in range(3)]
    assert all(np.array_equal(h, t.cpu().numpy()) for h in held)
    assert tiling._pinned_live_bytes - base == 2 * (1 << 18)  # the third is pageable
    view = held[0][3:5]
    del held
    assert tiling._pinned_live_bytes - base == 1 << 18  # a view keeps its buffer counted
    del view
    assert tiling._pinned_live_bytes == base


@pytest.mark.parametrize("nb,ti,n", [(1, 32, 20), (5, 32, 137), (3, 160, 480), (9, 256, 2053)])
def test_device_assembly_on_card_equals_numpy(cuda, nb, ti, n):
    rng = np.random.default_rng(nb)
    ibs, jbs = triangular_tile_ids(nb)
    keep = np.sort(rng.permutation(ibs.size)[: max(1, ibs.size * 2 // 3)])
    ibs, jbs = ibs[keep], jbs[keep]
    tiles = rng.integers(0, 1 << 30, size=(keep.size, ti, ti)).astype(np.int32)
    for t in np.flatnonzero(ibs == jbs):
        tiles[t] = np.triu(tiles[t]) + np.triu(tiles[t], 1).T
    got = assemble_triangular_torch(torch.from_numpy(tiles).to(cuda), ibs, jbs, nb, n)
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), assemble_triangular(tiles, ibs, jbs, nb, n))


# ------------------------------------------------------- the streaming walks
def _same_stripe_files(got_dir, want_dir):
    import json
    import os

    with open(os.path.join(got_dir, "manifest.json")) as f, \
            open(os.path.join(want_dir, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    names = sorted(p for p in os.listdir(want_dir) if p.endswith(".npz"))
    assert sorted(p for p in os.listdir(got_dir) if p.endswith(".npz")) == names
    for name in names:
        with np.load(os.path.join(got_dir, name)) as a, np.load(os.path.join(want_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for member in b.files:
                assert a[member].dtype == b[member].dtype
                assert np.array_equal(a[member], b[member]), (name, member)


def _stream_case(kernel):
    """(matrix, config, superblock rows): small shapes with two tiles a
    superblock side; the clustered one has empty and non-empty
    off-diagonal stripes."""
    if kernel == "clustered":
        return (_block_diagonal(250, 40_000, 5, 0.3, seed=3),
                EngineConfig(k2_tile_rows=32, k2_tile_words=128), 64)
    rng = np.random.default_rng(4)
    bm = BitMatrix.from_dense((rng.random((150, 9000)) < 0.3).astype(np.uint8))
    return bm, EngineConfig(k1_tile_rows=40, k1_tile_words=128, k2_tile_rows=32,
                            k2_tile_words=64), 64


@pytest.mark.parametrize("operand_streaming", (False, True), ids=("resident", "streaming"))
@pytest.mark.parametrize("kernel", ("mxu", "dense", "xla_int8", "xla_popcount", "clustered"))
def test_stream_directory_on_card_equals_the_cpu_route(cuda, tmp_path, kernel,
                                                       operand_streaming):
    from stormtpu_torch import stream

    bm, cfg, sb = _stream_case(kernel)
    kw = dict(superblock_rows=sb, kernel=kernel, config=cfg, compress=False,
              operand_streaming=operand_streaming)
    reset_launches()
    man = stream.stream_count_matrix(bm, str(tmp_path / "card"), **kw)
    counts = launch_counts()
    stream.stream_count_matrix(bm, str(tmp_path / "cpu"), device="cpu", **kw)
    assert launch_counts() == counts  # the CPU route launches nothing
    _same_stripe_files(str(tmp_path / "card"), str(tmp_path / "cpu"))
    assert np.array_equal(stream.load_streamed_matrix(str(tmp_path / "card")),
                          oracle_count_matrix(bm.packed))
    stripes = man["n_super"] * (man["n_super"] + 1) // 2
    key = {"mxu": "k2_tri", "dense": "k1", "clustered": "k5"}.get(kernel)
    if kernel == "clustered":
        assert 0 < counts["k5"] < stripes and counts["k2_tri"] == 0
    elif key:
        assert counts[key] == stripes


@pytest.mark.parametrize("kernel", ("mxu", "dense", "clustered"))
def test_stripe_walk_reads_nothing_back_before_the_download(cuda, tmp_path, monkeypatch,
                                                            kernel):
    """Between a stripe's launch and its download nothing comes back from
    the card: the wrappers' own checks (which read back) are not run, and
    no CUDA tensor is asked for ``cpu()``, ``item()`` or ``tolist()``
    outside ``download``."""
    from stormtpu_torch import stream

    bm, cfg, sb = _stream_case(kernel)
    want = oracle_count_matrix(bm.packed)

    def refuse(what):
        def raising(*a, **k):
            raise AssertionError(f"the stripe walk called {what}")
        return raising

    monkeypatch.setattr(mxu, "_check_tile_ids", refuse("_check_tile_ids"))
    monkeypatch.setattr(clustered, "_slot_starts", refuse("_slot_starts"))
    allowed = []
    for name in ("cpu", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def guarded(self, *a, _real=real, _name=name, **k):
            if self.is_cuda and not allowed:
                raise AssertionError(f"a CUDA tensor's {_name}() outside download")
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, guarded)
    real_download = stream.download

    def download(t):
        allowed.append(1)
        try:
            return real_download(t)
        finally:
            allowed.pop()

    monkeypatch.setattr(stream, "download", download)
    for streaming in (False, True):
        out = str(tmp_path / f"s{int(streaming)}")
        stream.stream_count_matrix(bm, out, superblock_rows=sb, kernel=kernel, config=cfg,
                                   compress=False, operand_streaming=streaming)
        assert np.array_equal(stream.load_streamed_matrix(out), want)


@pytest.mark.parametrize("wrapper", ("k2", "k1"))
def test_tile_ids_checked_on_the_host_on_the_card(cuda, wrapper, monkeypatch):
    xp = np.zeros((128, 64), np.uint32)
    xp[:100, :60] = _words(100, 60, 0.5, seed=9)
    x = to_device_words(xp, cuda)
    call = mxu.count_tiles_pallas_mxu if wrapper == "k2" else dense.count_tiles_pallas_dense
    plain = mxu.count_tiles_plain if wrapper == "k2" else dense.count_tiles_dense_plain
    ibs, jbs = triangular_tile_ids(4)
    ids = mxu.device_tile_ids(ibs, jbs, 4, cuda)
    assert ids.ibs.is_cuda and ids.ibs.is_contiguous() and ids.jbs.is_contiguous()
    want = plain(x, *ids, tile_rows=32, tile_words=16)
    bad = np.array([0, 4], np.int32)
    for route in ("host", "card"):
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            if route == "host":
                mxu.device_tile_ids(bad, bad, 4, cuda)
            else:
                t = torch.from_numpy(bad).to(cuda)
                call(x, t, t, tile_rows=32, tile_words=16)

    def no_read_back(*a, **k):
        raise AssertionError("the checked route read the tile ids back")

    call(x, *ids, tile_rows=32, tile_words=16, checked=ids)  # builds the library
    monkeypatch.setattr(mxu, "_check_tile_ids", no_read_back)
    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, no_read_back)
    got = call(x, *ids, tile_rows=32, tile_words=16, checked=ids)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="other tile-id tensors"):
        call(x, ids.ibs.clone(), ids.jbs, tile_rows=32, tile_words=16, checked=ids)
    ids.ibs.add_(0)
    with pytest.raises(ValueError, match="written to"):
        call(x, *ids, tile_rows=32, tile_words=16, checked=ids)


@pytest.mark.parametrize("kernel", ("mxu", "dense", "xla_int8"))
def test_two_slice_buffer_gives_the_resident_operands_stripe(cuda, kernel):
    from stormtpu_torch import stream

    bm, cfg, sb = _stream_case(kernel)
    ti, wk = ((cfg.k2_tile_rows, cfg.k2_tile_words) if kernel == "mxu"
              else (cfg.k1_tile_rows, cfg.k1_tile_words))
    sb = round_up(sb, ti)
    n_pad, w_pad = round_up(bm.n, sb), round_up(bm.n_words, wk)
    xp = clustered.padded_operand(bm, n_pad, w_pad, cuda)
    slices = stream._SliceBuffer(bm, sb, w_pad, cuda)
    n_super = n_pad // sb
    assert n_super >= 2
    pairs = [(i, j) for i in range(n_super) for j in range(i, n_super)]
    for i, j in pairs + [(0, 1)]:
        want = stream._compute_stripe(xp, i, j, sb // ti, ti, wk, kernel)
        got = stream._compute_stripe_pair(slices.stripe_operand(i, j), sb // ti, ti, wk, kernel)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (i, j)
    assert slices.buf.shape == (2 * sb, w_pad) and slices.staging[0].is_pinned()


def test_stream_sinks_on_card_equal_the_cpu_route(cuda):
    from stormtpu_torch import stream

    bm, cfg, sb = _stream_case("clustered")
    ti, wk = mxu.k2_tile_shape(cfg, bm.n, bm.n_words)
    w_pad = (-(-bm.n_words // wk) + 1) * wk
    xp = np.zeros((round_up(bm.n, sb), w_pad), np.uint32)
    xp[: bm.n, : bm.n_words] = bm.packed
    kw = dict(superblock_rows=sb, config=cfg)
    reset_launches()
    card = stream.stream_count_checksums(to_device_words(xp, cuda), bm.n, bm.m_bits, **kw)
    assert launch_counts()["k2_tri"] == len(card["stripes"]) == 10
    host = stream.stream_count_checksums(xp, bm.n, bm.m_bits, device="cpu", **kw)
    card_c = stream.stream_count_checksums_clustered(bm, **kw)
    host_c = stream.stream_count_checksums_clustered(bm, device="cpu", **kw)
    for a, b in ((card, host), (card_c, host_c)):
        assert a["stripes"] == b["stripes"]
        for key in ("sample_ii", "sample_jj", "sample_vals"):
            assert np.array_equal(a[key], b[key])
    assert [r["checksum"] for r in card["stripes"]] == [r["checksum"] for r in card_c["stripes"]]
    assert launch_counts()["k5"] == sum(not r["skipped"] for r in card_c["stripes"]) < 10
    want = oracle_count_matrix(bm.packed)[np.triu_indices(bm.n, 1)]
    for bins, width in ((64, None), (5, 7)):
        reset_launches()
        got = stream.stream_count_histogram(to_device_words(xp, cuda), bm.n, bm.m_bits,
                                            n_bins=bins, bin_width=width, **kw)
        oracle = np.bincount(np.minimum(want // got["bin_width"], bins - 1), minlength=bins)
        assert np.array_equal(got["hist"], oracle)
        assert launch_counts()["k2_hist"] == 10 and launch_counts()["k2_tri"] == 0
    with pytest.raises(ValueError, match="lies on"):
        stream.stream_count_checksums(to_device_words(xp, "cpu"), bm.n, bm.m_bits, **kw)


# ------------------------------------------------------------- K3, K4
def _sparse_case(n, m, density, seed):
    rng = np.random.default_rng(seed)
    k = max(1, int(n * m * density))
    return BitMatrix.from_positions(rng.integers(0, n, k), rng.integers(0, m, k), n, m)


@pytest.mark.parametrize("block_rows", (None, 1, 7))
@pytest.mark.parametrize("n,m,density", [(37, 5000, 0.01), (300, 1 << 16, 0.002), (129, 4096, 0.2)])
def test_k3_on_card_equals_its_cpu_form(cuda, n, m, density, block_rows):
    from stormtpu_torch.kernels import sparse

    bm = _sparse_case(n, m, density, seed=n + m)
    lists = torch.from_numpy(sparse.padded_position_lists(bm))
    a = lists[: max(1, n // 3)]
    reset_launches()
    got = sparse.count_block_sparse(a.to(cuda), lists.to(cuda), sentinel=m, block_rows=block_rows)
    torch.cuda.synchronize()
    blocks = launch_counts()["k3"]
    assert blocks == (1 if block_rows is None else -(-a.shape[0] // block_rows))
    want = sparse.count_block_sparse(a, lists, sentinel=m, block_rows=block_rows)
    assert launch_counts()["k3"] == blocks  # the CPU form is not a launch
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), oracle_count_block(bm.packed[: a.shape[0]], bm.packed))


def test_sparse_strategies_on_the_card(cuda):
    bm = _sparse_case(300, 1 << 18, 1e-4, seed=7)
    want = oracle_count_matrix(bm.packed)
    reset_launches()
    assert np.array_equal(intersect_count_matrix(bm, strategy="sparse", device=cuda), want)
    assert launch_counts()["k3"] >= 1 and launch_counts()["k2_tri"] == 0
    reset_launches()
    assert np.array_equal(intersect_count_matrix(bm, strategy="sparse_outer", device=cuda), want)
    assert launch_counts()["k4"] == 1 and launch_counts()["k2_tri"] == 0
    assert np.array_equal(intersect_count_matrix(bm, device=cuda), want)  # D1 on the card


def _k4_square_case(n, m, density, seed, every_row_column=False):
    """(bm, rows, off, lens, diag) of a seeded matrix (one more column in
    every row where asked) and its sorted K4 list, CPU tensors."""
    from stormtpu_torch.kernels import sparse

    rng = np.random.default_rng(seed)
    k = int(n * m * density)
    rows, pos = rng.integers(0, n, k), rng.integers(0, m, k)
    if every_row_column:
        rows, pos = np.r_[rows, np.arange(n)], np.r_[pos, np.full(n, 3)]
    bm = BitMatrix.from_positions(rows, pos, n, m)
    cols, rows = sparse._k4_sorted_rows(bm, torch.device("cpu"))
    off, lens = sparse.k4_runs(cols)
    return bm, rows, off, lens, torch.from_numpy(bm.row_nnz.astype(np.int32))


@pytest.mark.parametrize("n,m,density,every_row_column", [
    (2, 100, 0.3, False), (33, 4096, 0.01, False), (257, 1 << 16, 0.002, True),
    (1000, 1 << 18, 1e-3, False), (4099, 1 << 20, 2e-4, True), (300, 1 << 20, 0.0, False),
])
def test_k4_kernels_equal_plain(cuda, n, m, density, every_row_column):
    """Both K4 kernels (emission in its triangle form, the mirror with the
    diagonal) against their plain versions, ragged N, the column in every
    row (most contention), and no emission at all (density 0)."""
    from stormtpu_torch.kernels import sparse

    bm, rows, off, lens, diag = _k4_square_case(n, m, density, n + m, every_row_column)
    rows, off, lens, diag = (t.to(cuda) for t in (rows, off, lens, diag))
    prefix = sparse._emission_prefix(lens * (lens - 1) // 2)
    total = int(prefix[-1])
    want = torch.zeros((n, n), dtype=torch.int32, device=cuda)
    sparse.k4_emit_plain(rows, rows, off, lens, off, lens, prefix, want, triangle=True)
    reset_launches()
    got = torch.zeros((n, n), dtype=torch.int32, device=cuda)
    sparse.k4_emit(rows, rows, off, lens, off, lens, prefix, got, triangle=True)
    torch.cuda.synchronize()
    assert launch_counts()["k4"] == (1 if total else 0)  # no launch at no emissions
    assert torch.equal(got, want)
    sparse.k4_mirror(got, diag)
    sparse.k4_mirror_plain(want, diag)
    torch.cuda.synchronize()
    assert launch_counts()["k4_mirror"] == 1
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), sparse.count_matrix_sparse_outer(bm, device="cpu"))


@pytest.mark.parametrize("na,nb,m,density", [(37, 300, 5000, 0.02), (4096, 4096, 1 << 16, 1e-3),
                                             (64, 1, 100, 0.5)])
def test_k4_rectangle_kernel_equals_plain(cuda, na, nb, m, density):
    from stormtpu_torch import stream
    from stormtpu_torch.kernels import sparse

    rng = np.random.default_rng(na + nb)
    k = int((na + nb) * m * density)
    bm = BitMatrix.from_positions(rng.integers(0, na + nb, k), rng.integers(0, m, k), na + nb, m)
    sb = max(na, nb)
    plan = stream._SparseStripePlan(bm, sb, 2, device="cpu")
    oa, p, ob, q = (torch.from_numpy(a) for a in plan._segments(0, 1))
    rows_i = torch.from_numpy(plan.subs[0][1])
    rows_j = torch.from_numpy(plan.subs[1][1])
    want = sparse.k4_rect(rows_i, oa, p, rows_j, ob, q, sb, sb)
    reset_launches()
    got = sparse.k4_rect(rows_i.to(cuda), oa.to(cuda), p.to(cuda), rows_j.to(cuda), ob.to(cuda),
                         q.to(cuda), sb, sb)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert launch_counts()["k4"] == (1 if int((p * q).sum()) else 0)
    assert np.array_equal(want.numpy(), plan.stripe_counts(0, 1))  # the host C++ stripe


def test_k4_emission_index_past_2_31(cuda):
    """One segment of 2.6e9 emissions into an 8 x 4096 output: the flat
    emission index, the prefix and the lanes' offsets pass 2^31. Every
    entry is the product of its row's and its column's multiplicities."""
    from stormtpu_torch.kernels import sparse

    p, q = 65_536, 40_000
    rows_a = torch.arange(p, dtype=torch.int32, device=cuda) % 8
    rows_b = torch.arange(q, dtype=torch.int32, device=cuda) % 4096
    one = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = sparse.k4_rect(rows_a, one, one + p, rows_b, one, one + q, 8, 4096)
    torch.cuda.synchronize()
    assert p * q > 1 << 31
    want = np.outer(np.bincount(np.arange(p) % 8, minlength=8),
                    np.bincount(np.arange(q) % 4096, minlength=4096))
    assert np.array_equal(out.cpu().numpy(), want)


def test_k4_wrappers_refuse_malformed_card_input(cuda):
    from stormtpu_torch.kernels import sparse

    rows = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    seg = torch.tensor([0], dtype=torch.int64, device=cuda)
    lens = torch.tensor([3], dtype=torch.int64, device=cuda)
    prefix = torch.tensor([0, 3], dtype=torch.int64, device=cuda)
    out = torch.zeros((3, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows_a must be"):
        sparse.k4_emit(rows.long(), rows, seg, lens, seg, lens, prefix, out, triangle=True)
    with pytest.raises(ValueError, match="lies on"):
        sparse.k4_emit(rows, rows, seg.cpu(), lens, seg, lens, prefix, out, triangle=True)
    with pytest.raises(ValueError, match="out must be"):
        sparse.k4_emit(rows, rows, seg, lens, seg, lens, prefix, out.t(), triangle=False)
    with pytest.raises(ValueError, match="square int32"):
        sparse.k4_mirror(out[:, :2].contiguous())
    with pytest.raises(ValueError, match="diag lies on"):
        sparse.k4_mirror(out, rows.cpu())


@pytest.mark.parametrize("packed", (False, True), ids=("coo", "packed"))
def test_k4_single_shot_on_the_card(cuda, packed):
    """count_matrix_sparse_outer on the card against the host C++ route."""
    from stormtpu_torch.kernels import sparse

    bm = _sparse_case(2053, 1 << 20, 3e-4, seed=13)
    if packed:
        bm = BitMatrix.from_packed(bm.packed, bm.m_bits)
    reset_launches()
    got = sparse.count_matrix_sparse_outer(bm, device=cuda)
    counts = launch_counts()
    assert counts["k4"] == 1 and counts["k4_mirror"] == 1 and counts["k4_host"] == 0
    assert got.dtype == np.int32 and np.array_equal(got, sparse.count_matrix_sparse_outer(
        bm, device="cpu"))


def test_k4_streamed_walks_on_the_card(cuda, tmp_path, monkeypatch):
    """The streamed K4 walk, its histogram and a streamed query on the card,
    every stripe by K4's kernels (the cost model pinned so), against the
    same walks on the CPU (the host C++ stripes)."""
    from stormtpu_torch import stream, stream_hist, stream_query, tuning

    force = dict(c_sort_s_per_nnz=0.0, c_n2_s_per_elem=0.0, c_stripe_n2_s_per_elem=0.0,
                 c_emit_s_per_emission=0.0, c_emit_host_s_per_emission=1.0,
                 k2_int8_ops_per_s=1.0, dispatch_floor_s=100.0, h2d_bytes_per_s=1e9)
    for k, v in force.items():
        monkeypatch.setitem(tuning.K4_DEFAULTS, k, v)
    cfg = EngineConfig(k2_tile_rows=32, k2_tile_words=128)
    bm = _sparse_case(300, 1 << 14, 0.01, seed=31)
    reset_launches()
    got = stream.stream_count_matrix(bm, str(tmp_path / "card"), superblock_rows=128,
                                     kernel="sparse_outer", config=cfg, device=cuda)
    counts = launch_counts()
    assert got["stripe_kernels"] == {"k4": 6, "dense": 0}
    assert counts["k4"] >= 5 and counts["k4_mirror"] == 3 and counts["k4_host"] == 0
    want = stream.stream_count_matrix(bm, str(tmp_path / "host"), superblock_rows=128,
                                      kernel="sparse_outer", config=cfg, device="cpu")
    assert launch_counts()["k4_host"] == 6
    for i, j in want["completed"]:
        with np.load(stream.stripe_path(str(tmp_path / "card"), i, j)) as a, \
                np.load(stream.stripe_path(str(tmp_path / "host"), i, j)) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert np.array_equal(stream.load_streamed_matrix(str(tmp_path / "card")),
                          oracle_count_matrix(bm.packed))
    h_card = stream_hist.stream_hist_sparse(bm, superblock_rows=128, config=cfg, device=cuda)
    h_host = stream_hist.stream_hist_sparse(bm, superblock_rows=128, config=cfg, device="cpu")
    assert np.array_equal(h_card["hist"], h_host["hist"])
    assert h_card["stripe_kernels"] == h_host["stripe_kernels"] == {"k4": 6, "dense": 0}
    reset_launches()
    v_card, i_card = stream_query.stream_topk_neighbors(bm, 5, superblock_rows=128,
                                                        kernel="sparse_outer", config=cfg,
                                                        device=cuda)
    assert launch_counts()["k4"] >= 5
    v_host, _ = stream_query.stream_topk_neighbors(bm, 5, superblock_rows=128,
                                                   kernel="sparse_outer", config=cfg,
                                                   device="cpu")
    assert np.array_equal(v_card, v_host)


# ------------------------------------------------------------ queries
def _query_case(n, m, seed):
    return BitMatrix.from_packed(_words(n, -(-m // 32), 0.3, seed), -(-m // 32) * 32)


@pytest.mark.parametrize("chunk_tiles", (1, 5, None))
@pytest.mark.parametrize("n,ti,k", [(300, 64, 8), (129, 32, 40), (520, 256, 3)])
def test_tile_topk_on_card_equals_its_cpu_form(cuda, monkeypatch, n, ti, k, chunk_tiles):
    """The tile top-k (K2 tiles and the merge on the card) against the same
    walk on the CPU: equal values, indices that realize them."""
    import stormtpu_torch.config as tconf
    from stormtpu_torch import dispatch, query

    monkeypatch.setattr(tconf, "_DEFAULT", EngineConfig(k2_tile_rows=ti, k2_tile_words=128))
    monkeypatch.setattr(dispatch, "choose_strategy", lambda *a, **k_: "pallas_mxu")
    if chunk_tiles is not None:
        monkeypatch.setattr(query, "_SCREEN_TILE_CHUNK_BYTES", chunk_tiles * 4 * ti * ti)
    bm = _query_case(n, 3000, seed=n + ti)
    reset_launches()
    vals, idx = query.topk_neighbors(bm, k, device=cuda)
    assert launch_counts()["k2_topk" if k <= mxu.TOPK_EPI_MAX else "k2_tri"] >= 1
    want, _ = query.topk_neighbors(bm, k, device="cpu")
    assert np.array_equal(vals, want)
    c = oracle_count_matrix(bm.packed)
    assert np.array_equal(c[np.arange(n)[:, None], idx], vals)
    assert all(len(set(r.tolist())) == k and i not in r for i, r in enumerate(idx))


@pytest.mark.parametrize("chunk_tiles", (3, None))
@pytest.mark.parametrize("measure,threshold", [("count", 250), ("jaccard", 0.2), ("r2", 0.003)])
def test_tile_screen_on_card_equals_its_cpu_form(cuda, monkeypatch, measure, threshold,
                                                 chunk_tiles):
    """The tile screen (K2 tiles, float32 screen and bit packing on the
    card, the two-phase download, the K0 refine) against the CPU route."""
    import stormtpu_torch.config as tconf
    from stormtpu_torch import dispatch, query

    monkeypatch.setattr(tconf, "_DEFAULT", EngineConfig(k2_tile_rows=64, k2_tile_words=128))
    monkeypatch.setattr(dispatch, "choose_strategy", lambda *a, **k_: "pallas_mxu")
    if chunk_tiles is not None:
        monkeypatch.setattr(query, "_SCREEN_TILE_CHUNK_BYTES", chunk_tiles * 4 * 64 * 64)
    bm = _query_case(333, 3000, seed=11)
    reset_launches()
    got = query.pairs_above(bm, threshold, measure=measure, device=cuda)
    counts = launch_counts()
    assert counts["k2_tri"] >= 1 and counts["k0"] >= 1
    want = query.pairs_above(bm, threshold, measure=measure, device="cpu")
    assert want[0].size > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("route", ("block", "tile", "ring"))
def test_topk_on_card_never_ranks_padding(cuda, monkeypatch, route):
    """Sparse and empty rows, N not a multiple of the block or tile: padded
    rows count 0 like the real zero partners and must never be ranked.
    Values equal numpy's, partner sets valid, on the block form (K2-rect),
    the tile walk (K2-topk at this k) and the one-rank NCCL ring (K2-rect)."""
    import stormtpu_torch.config as tconf
    from stormtpu_torch import dispatch, query
    from stormtpu_torch.parallel import distributed_topk_neighbors, make_row_mesh

    dense = (np.random.default_rng(0).random((70, 512)) < 0.01).astype(np.uint8)
    bm = BitMatrix.from_dense(dense)
    k = 8
    monkeypatch.setattr(tconf, "_DEFAULT", EngineConfig(k2_tile_rows=32, k2_tile_words=128))
    monkeypatch.setattr(dispatch, "choose_strategy",
                        lambda *a, **k_: "pallas_mxu" if route == "tile" else "mxu")
    reset_launches()
    if route == "ring":
        vals, idx = distributed_topk_neighbors(bm, k, mesh=make_row_mesh(device=cuda))
    else:
        vals, idx = query.topk_neighbors(bm, k, device=cuda)
    assert launch_counts()["k2_topk" if route == "tile" else "k2_rect"] >= 1
    c = dense.astype(np.int64) @ dense.T.astype(np.int64)
    np.fill_diagonal(c, -1)
    assert np.array_equal(vals, -np.sort(-c, axis=1)[:, :k])
    assert np.array_equal(c[np.arange(70)[:, None], idx], vals)
    assert all(len(set(r.tolist())) == k and i not in r for i, r in enumerate(idx))


def test_untuned_card_takes_k2_at_every_m(cuda, tmp_path):
    """With no tuning cache for the card (this file's fixture pins an
    absent one), D1 and the streamed walks' ``auto`` name K2 at every M,
    as ``count_block_auto`` does there, and the count launches K2."""
    from stormtpu_torch import stream
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.kernels import plain_product_max_bits

    assert plain_product_max_bits(cuda) == 0 and plain_product_max_bits("cpu") == 1 << 17
    for m in (4096, 65536, 1 << 17, 1 << 20):
        assert choose_strategy(1000, m, 0.5, device=cuda) == "pallas_mxu", m
        assert choose_strategy(1000, m, 0.5, device="cpu") == (
            "mxu" if m <= 1 << 17 else "pallas_mxu"), m
        assert stream._auto_stream_kernel(m, 1000, cuda) == "mxu", m
    bm = _uniform(300, 65536, seed=8)
    reset_launches()
    assert np.array_equal(intersect_count_matrix(bm, device=cuda), oracle_count_matrix(bm.packed))
    assert launch_counts()["k2_tri"] == 1
    man = stream.stream_count_matrix(bm, str(tmp_path / "s"), superblock_rows=128, device=cuda)
    assert man["kernel"] == "mxu"


def test_pair_counts_on_card_launch_k0(cuda):
    from stormtpu_torch import pair_counts

    bm = _query_case(200, 70_000, seed=3)
    rng = np.random.default_rng(4)
    ii, jj = rng.integers(0, 200, 5000), rng.integers(0, 200, 5000)
    reset_launches()
    got = pair_counts(bm, ii, jj, device=cuda)
    assert launch_counts()["k0"] >= 1
    assert np.array_equal(got, oracle_count_matrix(bm.packed)[ii, jj])


# ------------------------------------------------------------ streamed queries
def _stripe_case(cuda, n, seed, diagonal):
    """A stripe's counts on the card and their CPU copy, with row offsets."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, (n, n), dtype=np.int64).astype(np.int32)
    counts[rng.random((n, n)) < 0.2] = 0
    if diagonal:
        counts = np.triu(counts) + np.triu(counts, 1).T
    nnz = rng.integers(60, 200, 2 * n).astype(np.int32)
    return (torch.from_numpy(counts).to(cuda), torch.from_numpy(counts),
            torch.from_numpy(nnz).to(cuda), torch.from_numpy(nnz))


@pytest.mark.parametrize("diagonal", (True, False))
@pytest.mark.parametrize("k", (1, 8, 20))
def test_stripe_topk_on_card_equals_its_cpu_form(cuda, diagonal, k):
    """The per-stripe top-k reduction (k passes of max, or torch.topk above
    16) on the card against the same reduction on the CPU: the masked
    values equal, each index realizing its value."""
    from stormtpu_torch.stream_query import _stripe_topk

    n, sb = 200, 96  # the last superblock is partial: rows from 192 are padding
    c_d, c_h, _, _ = _stripe_case(cuda, sb, seed=k, diagonal=diagonal)
    row0_i, row0_j = (96, 96) if diagonal else (0, 96)
    got = _stripe_topk(c_d, row0_i, row0_j, n, k=k, diagonal=diagonal)
    want = _stripe_topk(c_h, row0_i, row0_j, n, k=k, diagonal=diagonal)
    rows = torch.arange(sb)[:, None] + row0_i
    cols = torch.arange(sb)[None, :] + row0_j
    masked = torch.where((rows < n) & (cols < n) & (rows != cols), c_h, -1)
    for side, (v, i) in enumerate(((got[0], got[1]), (got[2], got[3]))):
        if v is None:
            assert diagonal and side == 1
            continue
        wv = want[2 * side]
        m = masked if side == 0 else masked.T
        assert torch.equal(v.cpu(), wv)
        assert torch.equal(torch.gather(m, 1, i.cpu().long()), wv)


SCREENS = [("count", 40), ("jaccard", 0.2), ("dice", 0.3), ("cosine", 0.3), ("overlap", 0.4),
           ("phi", 0.1), ("r2", 0.05)]


def _screened(fn, args, cap):
    """(total, the hits (row, column, count) row-major) of a screen into a
    buffer of ``cap`` hits."""
    from stormtpu_torch.kernels import screen

    out = screen.hit_buffer(cap, args[0].device)
    fn(*args, out)
    total = int(out[0])
    h = out[1:1 + 3 * min(total, cap)].view(-1, 3).cpu().numpy().astype(np.int64)
    return total, h[np.lexsort((h[:, 1], h[:, 0]))]


@pytest.mark.parametrize("n,diagonal", [(180, False), (180, True), (250, False), (250, True)])
@pytest.mark.parametrize("measure,threshold", SCREENS)
def test_stripe_screen_on_card_equals_its_cpu_form(cuda, measure, threshold, n, diagonal):
    """The per-stripe screen's compaction (``csrc/stripe_screen.cu``: float32
    values, the strict upper triangle, rows and columns below n) on the card
    against its plain form on the CPU: the same total, and the same hits
    with their counts. n = 180 cuts the column superblock (and the row one
    on the diagonal); 250 cuts neither."""
    from stormtpu_torch.kernels import screen
    from stormtpu_torch.query import _validate_screen

    sb = 96
    c_d, c_h, nz_d, nz_h = _stripe_case(cuda, sb, seed=7, diagonal=diagonal)
    row0, col0 = (96, 96) if diagonal else (0, 96)
    t = float(_validate_screen(measure, threshold))
    reset_launches()
    got = _screened(screen.stripe_screen,
                    (c_d, nz_d[:sb], nz_d[sb:], row0, col0, n, t, 4096.0, measure), sb * sb)
    assert launch_counts()["stripe_screen"] == 1
    want = _screened(screen.stripe_screen,
                     (c_h, nz_h[:sb], nz_h[sb:], row0, col0, n, t, 4096.0, measure), sb * sb)
    assert got[0] == want[0] > 0
    assert np.array_equal(got[1], want[1])


def test_stripe_screen_past_its_buffer_on_card(cuda, monkeypatch):
    """A buffer smaller than the stripe's hits: the kernel adds every hit to
    the total and writes as many as fit. The walk's buffers screen the
    first such stripe again into a buffer grown to fit and keep the size;
    the next stripe's copy holds as many hits; after a stripe of no hit the
    copy is small again, and a stripe past it has the rest read from its
    grown buffer without a second screen. Both count ``screen_refetch``."""
    from stormtpu_torch import stream_query as sq
    from stormtpu_torch.kernels import screen

    sb = 96
    c_d, c_h, nz_d, nz_h = _stripe_case(cuda, sb, seed=8, diagonal=False)
    args = (nz_d[:sb], nz_d[sb:], 0, 96, 180, 40.0, 4096.0, "count")
    none = args[:5] + (1e6,) + args[6:]
    total, part = _screened(screen.stripe_screen, (c_d, *args), 5)
    want_total, want = _screened(screen.stripe_screen_plain, (c_h, nz_h[:sb], nz_h[sb:],
                                                              *args[2:]), sb * sb)
    assert total == want_total > 5 and len(part) == 5
    assert set(map(tuple, part.tolist())) <= set(map(tuple, want.tolist()))
    monkeypatch.setattr(sq, "_SCREEN_HITS", 5)
    hits = sq._ScreenHits(cuda)
    reset_launches()
    with profiling.record() as rec:
        got = [hits.collect(hits.launch(c_d, *a)) for a in (args, args, none, args)]
    assert rec.counters["screen_refetch"] == 2 and launch_counts()["stripe_screen"] == 5
    assert hits.cap >= want_total
    for g, a in zip(got, (args, args, none, args)):
        assert all(x.dtype == np.int64 for x in g)
        assert np.array_equal(np.stack(g, axis=1), want if a is args else want[:0])


def _pairs_above_oracle(bm, threshold, measure):
    """``pairs_above``'s answer from the numpy oracle's whole count matrix,
    its similarities by ``setops.derive_similarity`` (the walk's float64
    refine), in blocks of rows."""
    from stormtpu_torch.setops import derive_similarity

    c = oracle_count_matrix(bm.packed)
    out_i, out_j, out_v = [], [], []
    for r0 in range(0, bm.n, 2048):
        blk = c[r0:r0 + 2048]
        if measure == "count":
            vals = blk
        else:
            vals = derive_similarity(blk, bm.row_nnz[r0:r0 + 2048, None],
                                     bm.row_nnz[None, :], bm.m_bits, measure)
        cols = np.arange(bm.n)[None, :]
        ii, jj = np.nonzero((vals >= threshold) & (cols > np.arange(r0, r0 + len(blk))[:, None]))
        out_i.append(ii + r0)
        out_j.append(jj)
        out_v.append(vals[ii, jj])
    ii, jj, vv = (np.concatenate(x) for x in (out_i, out_j, out_v))
    return (ii.astype(np.int32), jj.astype(np.int32),
            vv.astype(np.int32) if measure == "count" else vv)


@pytest.mark.parametrize("measure,threshold", [("count", 45), ("r2", 0.06)])
def test_stream_pairs_above_16384_rows_on_card_equals_the_oracle(cuda, measure, threshold):
    """``stream_pairs_above`` at 16,384 rows (superblock 4096: ten stripes,
    about 1,800 and 11,000 hits) on the card against the numpy oracle's
    answer: equal arrays; one screen launch a stripe, no refetch, and at
    most 2.5 host waits a stripe (the copy's event, the tile ids' upload).
    The CPU route is not run at this size: its plain int8 product takes
    about 300 s a measure on a CPU."""
    from stormtpu_torch import stream_query as sq

    bm = BitMatrix.from_packed(_words(16384, 8, 0.3, seed=16), 256)
    reset_launches()
    with profiling.record() as rec:
        got = sq.stream_pairs_above(bm, threshold, measure=measure, device=cuda)
    assert launch_counts()["stripe_screen"] == rec.counters["stripes"] == 10
    assert rec.counters.get("screen_refetch", 0) == 0
    assert rec.counters["waits"] <= 2.5 * rec.counters["stripes"], rec.counters
    want = _pairs_above_oracle(bm, threshold, measure)
    assert got[0].size > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kernel", ("mxu", "dense"))
@pytest.mark.parametrize("streaming", (False, True))
def test_streamed_queries_on_card_equal_the_cpu_route(cuda, monkeypatch, kernel, streaming):
    """``stream_topk_neighbors`` (count and Jaccard), ``stream_pairs_above``
    and ``stream_pairs_above_complete`` on the card, resident and on two
    slices, against the same calls on the CPU; the tile kernel launches."""
    from stormtpu_torch import stream_query as sq

    cfg = EngineConfig(k1_tile_rows=32, k1_tile_words=128, k2_tile_rows=64,
                       k2_tile_words=128)
    bm = _query_case(300, 3000, seed=5)
    kw = dict(superblock_rows=128, kernel=kernel, config=cfg)
    if streaming:  # two slices on the card, one stripe's operand at a time
        monkeypatch.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
    reset_launches()
    for measure, k in (("count", 6), ("jaccard", 4)):
        got = sq.stream_topk_neighbors(bm, k, measure=measure, device=cuda, **kw)
        want = sq.stream_topk_neighbors(bm, k, measure=measure, device="cpu", **kw)
        assert np.array_equal(got[0], want[0])
    for measure, thr in (("count", 300), ("jaccard", 0.2)):
        got = sq.stream_pairs_above(bm, thr, measure=measure, device=cuda, **kw)
        want = sq.stream_pairs_above(bm, thr, measure=measure, device="cpu", **kw)
        assert want[0].size > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    rng = np.random.default_rng(6)
    obs = rng.random((300, 3000)) > 0.1
    val = (rng.random((300, 3000)) < 0.4) & obs
    d, m = (BitMatrix.from_dense(x.astype(np.uint8)) for x in (val, obs))
    got = sq.stream_pairs_above_complete(d, m, 0.02, device=cuda, **kw)
    want = sq.stream_pairs_above_complete(d, m, 0.02, device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert launch_counts()["k2_tri" if kernel == "mxu" else "k1"] >= 1
    if kernel == "mxu":
        assert launch_counts()["k2_topk"] >= 1


@pytest.mark.parametrize("measure", ("jaccard", "dice", "cosine", "overlap", "phi", "r2"))
def test_derive_similarity_torch_on_card_equals_numpy_bit_for_bit(cuda, measure):
    """The streamed top-k's float64 rescore on the card gives the host
    formulas' bits (IEEE double operations, one kernel each)."""
    from stormtpu_torch.setops import derive_similarity, derive_similarity_torch

    rng = np.random.default_rng(31)
    m = 1 << 20
    ca = rng.integers(0, m + 1, (512, 1))
    cb = rng.integers(0, m + 1, (1, 700))
    ca[:3], cb[:, :3] = 0, m
    inter = np.minimum(rng.integers(0, m, (512, 700)), np.minimum(ca, cb))
    per_pair = np.maximum(rng.integers(m // 2, m + 1, (512, 700)), np.maximum(ca, cb))
    for universe in (m, per_pair):
        want = derive_similarity(inter, ca, cb, universe, measure)
        got = derive_similarity_torch(
            *(torch.from_numpy(x).to(cuda) for x in (inter, ca, cb)),
            torch.from_numpy(universe).to(cuda) if isinstance(universe, np.ndarray) else universe,
            measure).cpu().numpy()
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


# ------------------------------------------------------------ tuned routing
_KERNEL_OF = {"pallas_mxu": "k2_tri", "pallas_dense": "k1"}


def _guarded(winner, m):
    from stormtpu_torch.kernels import MXU_XLA_MAX_BITS

    return "pallas_mxu" if winner == "mxu" and m > MXU_XLA_MAX_BITS else winner


def _uniform(n, m, seed):
    rng = np.random.default_rng(seed)
    return BitMatrix.from_packed(rng.integers(0, 1 << 32, (n, m // 32), dtype=np.uint32), m)


def test_tune_on_card_and_d1_follows_the_cache(cuda, tmp_path, monkeypatch):
    from stormtpu_torch import tuning
    from stormtpu_torch.dispatch import choose_strategy

    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "t.json"))
    monkeypatch.setattr(tuning, "refit_k4_constants", lambda *a, **k: None)
    res = tuning.tune(shapes=[(256, 8192), (1024, 65536)], reps=1, log=lambda *a: None)
    assert res["device"] == torch.cuda.get_device_name() and res["peak_ops_per_s"] > 0
    for key, b in res["buckets"].items():
        n, m = map(int, key.split("x"))
        rates = b["dense_pairs_per_s"]
        assert {"pallas_dense", "pallas_mxu"} <= set(rates) and min(rates.values()) > 0
        want = _guarded(tuning._winner(rates), m)
        assert choose_strategy(n, m, 0.5) == want
        bm = _uniform(n, m, seed=n)
        reset_launches()
        assert np.array_equal(intersect_count_matrix(bm), oracle_count_matrix(bm.packed))
        counts = launch_counts()
        if want in _KERNEL_OF:
            assert counts[_KERNEL_OF[want]] >= 1
        else:
            assert counts["k2_tri"] == counts["k1"] == 0


def test_d1_and_stream_auto_follow_a_cache_on_the_card(cuda, tmp_path, monkeypatch):
    import json

    from stormtpu_torch import stream, tuning
    from stormtpu_torch.dispatch import choose_strategy

    path = tmp_path / "t.json"
    monkeypatch.setenv(tuning.CACHE_ENV, str(path))
    path.write_text(json.dumps({"device": torch.cuda.get_device_name(), "buckets": {
        "256x8192": {"dense_pairs_per_s": {"pallas_dense": 2.0, "pallas_mxu": 1.0}},
        "256x1048576": {"dense_pairs_per_s": {"mxu": 2.0, "pallas_mxu": 1.0}},
    }}))
    assert choose_strategy(200, 8192, 0.5) == "pallas_dense"
    assert choose_strategy(200, 8192, 0.5, device="cpu") == "mxu"  # the CPU is untuned
    assert choose_strategy(200, 1 << 20, 0.5) == "pallas_mxu"  # the memory guard
    assert stream._auto_stream_kernel(8192, 200, cuda) == "dense"
    bm = _uniform(200, 8192, seed=4)
    reset_launches()
    assert np.array_equal(intersect_count_matrix(bm), oracle_count_matrix(bm.packed))
    assert launch_counts()["k1"] == 1 and launch_counts()["k2_tri"] == 0
    reset_launches()
    man = stream.stream_count_matrix(bm, str(tmp_path / "s"), superblock_rows=128,
                                     kernel="auto", device=cuda)
    assert man["kernel"] == "dense" and launch_counts()["k1"] == len(man["completed"])
    assert np.array_equal(stream.load_streamed_matrix(str(tmp_path / "s")),
                          oracle_count_matrix(bm.packed))


def test_cli_on_card_equals_the_in_process_calls(cuda, tmp_path):
    from stormtpu_torch import topk_neighbors
    from stormtpu_torch.cli import main
    from stormtpu_torch.io import save_bitmatrix

    bm = _uniform(300, 4096, seed=5)
    f = tmp_path / "m.npz"
    save_bitmatrix(bm, str(f))
    assert main(["count", "--in", str(f), "--out", str(tmp_path / "c.npy")]) == 0
    got = np.load(tmp_path / "c.npy")
    assert np.array_equal(got, intersect_count_matrix(bm, device=cuda))
    assert np.array_equal(got, oracle_count_matrix(bm.packed))
    assert main(["topk", "--in", str(f), "--out", str(tmp_path / "t.npz"), "--k", "4"]) == 0
    vals, idx = topk_neighbors(bm, 4, device=cuda)
    with np.load(tmp_path / "t.npz") as z:
        assert np.array_equal(z["counts"], vals) and np.array_equal(z["indices"], idx)


@pytest.mark.parametrize("case", ("rows", "bits", "bits_k5"))
def test_parallel_one_rank_nccl_group_equals_the_oracle(cuda, case):
    """``stormtpu_torch.parallel`` over a one-rank NCCL group: the ring
    (K2-rect), the bits axis (K2-tri and the sum) and, on a
    block-clustered input, the sharded K5 work list."""
    from stormtpu_torch.parallel import distributed_count_matrix, make_row_mesh

    mesh = make_row_mesh(device=cuda)
    assert mesh.backend == "nccl" and mesh.size == 1
    packed = _words(300, 600, 0.3, seed=9)
    if case == "bits_k5":
        packed[:, 150:] = 0  # a quarter of the words occupied
    reset_launches()
    got = distributed_count_matrix(packed, mesh=mesh,
                                   shard_axis="rows" if case == "rows" else "bits")
    np.testing.assert_array_equal(got, oracle_count_matrix(packed))
    kernel = {"rows": "k2_rect", "bits": "k2_tri", "bits_k5": "k5"}[case]
    assert launch_counts()[kernel] >= 1


def test_sharded_topk_on_four_nccl_ranks(cuda):
    """Four NCCL ranks, one a card: the top-k's sharded form (each rank's
    ``RowShard`` made from its own rows on its card) equals the host form
    and the oracle's counts, and the in-place ring shift equals
    ``ppermute`` (a staging buffer of 1,000 elements over 3,003). The
    group is killed past 300 s."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards (one NCCL rank a card)")
    import torch_parallel_cases as cases

    from stormtpu_torch.parallel.dryrun import run_group

    out = run_group(4, "nccl", "cuda", cases.sharded_topk_group, timeout=300)
    packed = cases.dense_packed(1000, 8192, 0.3, seed=17)
    c = oracle_count_matrix(packed).astype(np.int64)
    np.fill_diagonal(c, -1)
    for rank, got in enumerate(out):
        assert got["backend"] == "nccl" and got["shift_equal"], rank
        for form in ("padded", "ones"):
            for a, b in zip(got[form], got["host"]):
                np.testing.assert_array_equal(a, b)
        vals, idx = got["padded"]
        np.testing.assert_array_equal(vals, -np.sort(-c, axis=1)[:, :9])
        assert np.array_equal(np.take_along_axis(c, idx.astype(np.int64), axis=1), vals)
        assert all(len(set(r)) == 9 for r in idx.tolist())


# ------------------------------------------------ K2-topk and K2-hist
def _epilogue_case(cuda, n, w, ti, wk, density, seed, order):
    """A padded operand on the card and a tile list: the upper triangle
    ("tri"), or every tile pair shuffled ("grid", as a stripe's off-diagonal
    list, some pairs below the diagonal)."""
    packed = _words(n, w, density, seed=seed)
    n_pad, w_pad = round_up(n, ti), round_up(w, wk)
    xp = np.zeros((n_pad, w_pad), np.uint32)
    xp[:n, :w] = packed
    nb = n_pad // ti
    if order == "tri":
        ibs, jbs = triangular_tile_ids(nb)
    else:
        ibs, jbs = (g.ravel().astype(np.int32) for g in np.meshgrid(np.arange(nb), np.arange(nb),
                                                                    indexing="ij"))
        perm = np.random.default_rng(seed).permutation(ibs.size)
        ibs, jbs = ibs[perm], jbs[perm]
    ids = mxu.device_tile_ids(ibs, jbs, nb, cuda)
    return to_device_words(xp, cuda), ids, dict(tile_rows=ti, tile_words=wk)


# ti 32, 64 and 96: clusters of one; 160, 224 and 256: clusters of two (at
# 160 and 224 the second sub-tile row is short); 384: three sub-tile rows,
# clusters of one. w_pad 104 and 72 end mid-chunk past the first chunk (TMA
# fills the K tail with zeros), and the last row block's boxes at ti 160,
# 224 and 96 read past the operand's last row.
EPI_SHAPES = [(37, 33, 64, 40, 0.5), (300, 300, 256, 256, 0.5), (70, 129, 32, 128, 0.01),
              (129, 16, 160, 8, 1.0), (520, 64, 256, 64, 0.001), (230, 100, 224, 104, 0.5),
              (100, 70, 96, 72, 0.3), (400, 64, 384, 64, 0.1)]


@pytest.mark.parametrize("order,offsets,cut", [("tri", None, 0), ("grid", None, 5),
                                               ("grid", (3, 1), 0)])
@pytest.mark.parametrize("k", (1, 8, 16, 32))
@pytest.mark.parametrize("n,w,ti,wk,density", EPI_SHAPES)
def test_k2_topk_kernel_equals_plain(cuda, n, w, ti, wk, density, k, order, offsets, cut):
    """K2-topk's candidate sets, values and indices, equal the plain
    version's exactly (ties to the lower index on both): at odd tile rows
    (one, two and three sub-tile rows; clusters of one and two), K tails
    mid-chunk, boxes past the last row, shuffled lists with tiles on both
    sides of the diagonal, global offsets (``offsets`` in tiles: a stripe's
    local ids) and an ``n_real`` below the rows."""
    x, ids, kw = _epilogue_case(cuda, n, w, ti, wk, density, n + k, order)
    row_off, col_off = (0, 0) if offsets is None else (offsets[0] * ti, offsets[1] * ti)
    args = dict(k=k, n_real=n - cut, row_off=row_off, col_off=col_off, **kw)
    reset_launches()
    got = mxu.count_tiles_topk(x, *ids, checked=ids, **args)
    assert launch_counts()["k2_topk"] == 1 and launch_counts()["k2_tri"] == 0
    want = mxu.count_tiles_topk_plain(x, *ids, **args)
    torch.cuda.synchronize()
    for g, h in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, h)


@pytest.mark.parametrize("n_bins,bin_width", [(64, None), (1, 1), (7, 1), (3, 1 << 21),
                                              (4096, 1), (5, 3)])
@pytest.mark.parametrize("order,offsets,cut", [("tri", None, 0), ("grid", (3, 1), 7)])
@pytest.mark.parametrize("n,w,ti,wk,density", EPI_SHAPES)
def test_k2_hist_kernel_equals_plain(cuda, n, w, ti, wk, density, n_bins, bin_width, order,
                                     offsets, cut):
    """K2-hist's bin counts equal the plain version's exactly (the shapes
    of the top-k test): one bin,
    crowded bins (all ones; a width past M), a bin a value (width 1, 4096
    bins), global offsets and an ``n_real`` below the rows."""
    from stormtpu_torch.stream import default_hist_bin_width

    x, ids, kw = _epilogue_case(cuda, n, w, ti, wk, density, n + n_bins, order)
    row_off, col_off = (0, 0) if offsets is None else (offsets[0] * ti, offsets[1] * ti)
    width = bin_width or default_hist_bin_width(w * 32, n_bins)
    args = dict(n_real=n - cut, bin_width=width, n_bins=n_bins, row_off=row_off,
                col_off=col_off, **kw)
    reset_launches()
    got = mxu.count_tiles_hist(x, *ids, checked=ids, **args)
    assert launch_counts()["k2_hist"] == 1
    want = mxu.count_tiles_hist_plain(x, *ids, **args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, want)
    lane = np.arange(ti)
    rows = row_off + ids.ibs.cpu().numpy()[:, None] * ti + lane
    cols = col_off + ids.jbs.cpu().numpy()[:, None] * ti + lane
    valid = (rows[:, :, None] < cols[:, None, :]) & (cols[:, None, :] < n - cut)
    assert int(got.sum()) == int(valid.sum())  # every valid pair binned once


def test_k2_epilogues_all_ones_at_the_int32_edge(cuda):
    """Every count 2^27: the top-k's value + 1 and the histogram's bins
    hold at the top of the counts' range."""
    m = 1 << 27
    ones = torch.full((256, m // 32), -1, dtype=torch.int32, device=cuda)
    ids = mxu.device_tile_ids(np.array([0, 0, 1], np.int32), np.array([0, 1, 1], np.int32), 2,
                              cuda)
    kw = dict(tile_rows=128, tile_words=2048, checked=ids)
    sets = mxu.count_tiles_topk(ones, *ids, k=4, n_real=256, **kw)
    assert bool((sets.row_v == m).all()) and bool((sets.col_v[1] == m).all())
    assert bool((sets.col_v[[0, 2]] == -1).all())
    # ties to the lower index: tile (0, 1)'s rows take columns 128..131, its
    # columns rows 0..3; row 0 of a diagonal tile skips itself
    assert bool((sets.row_i[1] == torch.arange(128, 132, device=cuda)).all())
    assert bool((sets.col_i[1] == torch.arange(4, device=cuda)).all())
    assert sets.row_i[0, 0, 0].tolist() == [1, 2, 3, 4]
    hist = mxu.count_tiles_hist(ones, *ids, n_real=256, bin_width=1 << 20, n_bins=200, **kw)
    assert int(hist[m >> 20]) == 256 * 255 // 2 and int(hist.sum()) == 256 * 255 // 2


def test_k2_epilogue_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xp = torch.zeros((64, 16), dtype=torch.int32, device=cuda)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw = dict(tile_rows=32, tile_words=8, n_real=64)
    with pytest.raises(ValueError, match="k=33"):
        mxu.count_tiles_topk(xp, ids, ids, k=mxu.TOPK_EPI_MAX + 1, **kw)
    with pytest.raises(ValueError, match="n_bins"):
        mxu.count_tiles_hist(xp, ids, ids, bin_width=1, n_bins=mxu.HIST_EPI_MAX_BINS + 1, **kw)
    with pytest.raises(TypeError):
        mxu.count_tiles_topk(xp.float(), ids, ids, k=4, **kw)
    with pytest.raises(ValueError):
        mxu.count_tiles_hist(xp, ids.cpu(), ids, bin_width=1, n_bins=4, **kw)


def test_k2_epilogue_tma_launchers_refuse_what_tma_does_not_take(cuda):
    """TMA's row stride is a multiple of 16 bytes and its base 16-byte
    aligned: the wrappers refuse a row of 6 words and an operand 4 bytes
    off (ValueError, nothing launched), and the C launchers return
    cudaErrorInvalidValue (1) for both without launching."""
    from stormtpu_torch.kernels._build import library

    lib = library("k2_epilogue")
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    hist = torch.zeros(4, dtype=torch.int64, device=cuda)
    kw = dict(tile_rows=32, n_real=32, bin_width=1, n_bins=4)
    reset_launches()
    with pytest.raises(ValueError):
        mxu.count_tiles_hist(torch.zeros((32, 6), dtype=torch.int32, device=cuda), ids, ids,
                             tile_words=6, **kw)
    off = torch.zeros(32 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(32, 8)
    with pytest.raises(ValueError, match="aligned"):
        mxu.count_tiles_hist(off, ids, ids, tile_words=8, **kw)
    assert launch_counts()["k2_hist"] == 0
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros((32, 8), dtype=torch.int32, device=cuda)
    for ptr, w in ((x.data_ptr(), 6), (x.data_ptr() + 4, 8)):
        assert lib.k2_hist_launch(ptr, ids.data_ptr(), ids.data_ptr(), hist.data_ptr(), 1, 32,
                                  32, w, 0, 0, 32, 1, 4, stream) == 1
    out = torch.zeros(32, dtype=torch.int32, device=cuda)
    assert lib.k2_topk_launch(x.data_ptr(), ids.data_ptr(), ids.data_ptr(),
                              *(out.data_ptr(),) * 4, 1, 32, 32, 6, 0, 0, 32, 1, stream) == 1
    torch.cuda.synchronize()
    assert int(hist.sum()) == 0


def test_k2_epilogue_cluster_follows_the_shape_rule(cuda):
    """Clusters of two blocks exactly when a tile has an even number of
    128-row sub-tile rows."""
    for ti, want in ((32, 1), (96, 1), (128, 1), (160, 2), (256, 2), (384, 1), (512, 2)):
        assert mxu.epilogue_cluster(ti) == want


def test_k2_epilogue_build_has_no_spills_and_k2_is_unchanged(cuda):
    """The epilogue kernels (the TMA body's two cluster instances, and no
    other) spill nothing and the compiler kept their register rebalancing
    (no "setmaxnreg ignored"); K2-tri's, K5's and K1's kernels on the
    shared tile body still build to the registers they had before the
    epilogues (PERF.md: 186, 192, 196)."""
    from stormtpu_torch.kernels import _build

    used = _build.kernel_resources("k2_epilogue")
    assert len(used) == 4
    for name in ("k2_topk_kernel", "k2_hist_kernel"):
        assert len([s for s in used if name in s]) == 2  # clusters 1, 2
    assert all(v["spill_bytes"] == 0 for v in used.values())
    log = _build._target("k2_epilogue").with_suffix(".log").read_text()
    assert "setmaxnreg ignored" not in log
    k2 = _build.kernel_resources("k2_mxu")
    assert all(v["spill_bytes"] == 0 for v in k2.values())
    body = {**k2, **_build.kernel_resources("k1_dense")}

    def registers(kernel):
        return next(v["registers"] for s, v in body.items() if kernel in s and "B1Wgmma" in s)

    assert [registers(k) for k in ("k2_tri_kernel", "k5_stream_kernel",
                                   "k1_pair_kernel")] == [186, 192, 196]


@pytest.mark.parametrize("k", (8, 32, 33))
def test_routes_through_the_epilogues_equal_the_store_route(cuda, monkeypatch, k):
    """``topk_neighbors`` (the tile walk), ``stream_topk_neighbors`` (K2
    stripes, resident and on two slices), ``stream_count_histogram`` and the
    streamed walk's ``_PairStripes`` launch K2-topk / K2-hist (k ≤ 32) and
    equal the store route (``TOPK_EPI_MAX`` and ``HIST_EPI_MAX_BINS`` set to
    0): the same values, valid partner sets."""
    import stormtpu_torch.config as tconf
    from stormtpu_torch import dispatch, query, stream, stream_hist
    from stormtpu_torch import stream_query as sq

    cfg = EngineConfig(k2_tile_rows=64, k2_tile_words=128)
    monkeypatch.setattr(tconf, "_DEFAULT", cfg)
    monkeypatch.setattr(dispatch, "choose_strategy", lambda *a, **k_: "pallas_mxu")
    bm = _query_case(300, 3000, seed=k)
    c = oracle_count_matrix(bm.packed).astype(np.int64)
    np.fill_diagonal(c, -1)

    def calls():
        out = [query.topk_neighbors(bm, k, device=cuda),
               sq.stream_topk_neighbors(bm, k, superblock_rows=128, kernel="mxu", config=cfg,
                                        device=cuda)]
        with monkeypatch.context() as m:
            m.setenv("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES", "1000")
            out.append(sq.stream_topk_neighbors(bm, k, superblock_rows=128, kernel="mxu",
                                                config=cfg, device=cuda))
            out.append(stream_hist.stream_hist_streamed(bm, n_bins=k, superblock_rows=128,
                                                        config=cfg, device=cuda)["hist"])
        xp = np.zeros((384, 128), np.uint32)
        xp[:300, :bm.n_words] = bm.packed
        out.append(stream.stream_count_histogram(to_device_words(xp, cuda), 300, bm.m_bits,
                                                 n_bins=k, superblock_rows=128, config=cfg,
                                                 device=cuda)["hist"])
        return out

    reset_launches()
    got = calls()
    counts = launch_counts()
    assert counts["k2_hist"] >= 1 and (counts["k2_topk"] >= 1) == (k <= mxu.TOPK_EPI_MAX)
    monkeypatch.setattr(mxu, "TOPK_EPI_MAX", 0)
    monkeypatch.setattr(mxu, "HIST_EPI_MAX_BINS", 0)
    reset_launches()
    want = calls()
    assert launch_counts()["k2_topk"] == launch_counts()["k2_hist"] == 0
    for (gv, gi), (wv, _) in zip(got[:3], want[:3]):
        assert np.array_equal(gv, wv) and np.array_equal(gv, -np.sort(-c, axis=1)[:, :k])
        assert np.array_equal(c[np.arange(300)[:, None], gi], gv)
        assert all(len(set(r.tolist())) == k and i not in r for i, r in enumerate(gi))
    for g, h in zip(got[3:], want[3:]):
        assert np.array_equal(g, h)


def test_the_density_order_on_the_card_equals_the_k2_walk(cuda):
    """An LD panel of 16,384 × 2²⁰ bits (``tests/reference_ld.py``: neutral
    carrier counts, nested carriers in blocks of 32 rows) under the card's
    own constants: ``kernel="auto"`` orders it by count and K4 answers the
    rare superblocks' stripes (the diagonal, both sides' runs and the
    gathered other side), with the K2 walk's hits and r² top-k."""
    import stormtpu_torch.stream_query as tsq
    from reference_ld import ld_panel

    bm = BitMatrix.from_packed(ld_panel(11, 16384, 1 << 20), 1 << 20)
    with profiling.record() as rec:
        got = tsq.stream_pairs_above(bm, 0.8, measure="r2", kernel="auto", device=cuda)
        vals, idx = tsq.stream_topk_neighbors(bm, 4, measure="r2", kernel="auto", device=cuda)
    assert rec.counters["routes.k4"] > 0 and rec.counters["routes.mxu"] > 0
    assert rec.counters["order_positions"] > 0
    bm.clear_device_cache()
    want = tsq.stream_pairs_above(bm, 0.8, measure="r2", kernel="mxu", device=cuda)
    assert want[0].size > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    dvals, _ = tsq.stream_topk_neighbors(bm, 4, measure="r2", kernel="mxu", device=cuda)
    assert np.array_equal(vals, dvals)
    assert np.all(idx != np.arange(bm.n)[:, None])
