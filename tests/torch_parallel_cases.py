"""Inputs and per-rank cases of the ``stormtpu_torch.parallel`` tests.

This module imports neither JAX nor ``stormtpu``: the ranks that run its
``run_*`` functions are spawned processes (``parallel.dryrun.run_group``),
and import it by name. Each ``run_*`` builds every mesh of ``SHAPES`` in
the same order on every rank, runs each case of its table on the meshes the
case names, and returns ``{(case, shape): result}`` for the meshes this
rank is in. The test files hold rank 0's results against the JAX package's
functions on the same inputs (``data()``), in the pytest process.
"""

from __future__ import annotations

import os

import numpy as np

#: mesh shapes: 1-D row meshes of R ranks, and [rows × bits] grids
ROWS = (1, 2, 3, 4, 5, 8)
GRIDS = ((2, 2), (4, 2))
SHAPES = tuple(f"r{r}" for r in ROWS) + tuple(f"g{a}x{b}" for a, b in GRIDS)
WORLD = 8


def dense_packed(n: int, m_bits: int, density: float, seed: int) -> np.ndarray:
    """``conftest.random_bitmatrix``'s input, packed: uint32 [n, ⌈m/32⌉]."""
    from stormtpu_torch.layout import pack_bits

    rng = np.random.default_rng(seed)
    return pack_bits((rng.random((n, m_bits)) < density).astype(np.uint8))


def data() -> dict:
    """Every input of the cases, by name: (packed uint32 [N, W], m_bits)."""
    rng = np.random.default_rng(67)
    d = {}
    d["ragged"] = (rng.integers(0, 2**32, (43, 19), dtype=np.uint32), 19 * 32)
    d["dense30"] = (dense_packed(30, 2048, 0.3, seed=51), 2048)
    from stormtpu_torch.layout import pack_bits

    d["eye"] = (pack_bits(np.eye(32, 64, dtype=np.uint8)), 64)
    d["sparse_dense"] = (dense_packed(24, 4096, 0.001, seed=44), 4096)
    wb = 8 * 128 + 7  # ragged words: the K2-tri tiles of the bits axis at every R ≤ 8
    pb = rng.integers(0, 2**32, (37, wb), dtype=np.uint32)
    pb &= rng.integers(0, 2**32, (37, wb), dtype=np.uint32)
    pb &= rng.integers(0, 2**32, (37, wb), dtype=np.uint32)
    d["bits_tri"] = (pb, wb * 32)
    pc = np.zeros((37, 8 * 512), dtype=np.uint32)  # a quarter of the words occupied
    pc[:, :1024] = rng.integers(0, 2**32, (37, 1024), dtype=np.uint32)
    d["bits_k5"] = (pc, 8 * 512 * 32)
    d["columns"] = (dense_packed(19, 1000, 0.3, seed=55), 1000)
    d["setops"] = (dense_packed(45, 1024, 0.3, seed=81), 1024)
    d["grid_setops"] = (dense_packed(21, 330, 0.35, seed=73), 330)
    # queries
    d["topk"] = (dense_packed(96, 2048, 0.2, seed=51), 2048)
    d["topk_small"] = (dense_packed(21, 512, 0.4, seed=52), 512)
    d["measure"] = (dense_packed(70, 700, 0.25, seed=91), 700)
    d["screen"] = (dense_packed(90, 1024, 0.25, seed=53), 1024)
    d["screen_bits"] = (dense_packed(90, 8 * 128 * 32 + 50, 0.02, seed=91), 8 * 128 * 32 + 50)
    d["topk_bits"] = (dense_packed(70, 8 * 128 * 32 + 50, 0.02, seed=93), 8 * 128 * 32 + 50)
    # sparse and empty rows, N not a multiple of the block: padded rows
    # must never be ranked among a row's partners
    d["topk_sparse"] = (dense_packed(70, 512, 0.01, seed=0), 512)
    d["measure_bits"] = (dense_packed(48, 8192, 0.3, seed=93), 8192)
    d["grid_q"] = (dense_packed(45, 610, 0.3, seed=71), 610)
    d["grid_measure"] = (dense_packed(40, 2048, 0.3, seed=92), 2048)
    d["cross_a"] = (rng.integers(0, 2**32, (5, 16), dtype=np.uint32), 512)
    d["cross_b"] = (rng.integers(0, 2**32, (67, 16), dtype=np.uint32), 512)
    d["row_sums"] = (dense_packed(41, 9000, 0.4, seed=84), 9000)
    d["hist"] = (dense_packed(50, 700, 0.3, seed=91), 700)
    d["hist_width"] = (dense_packed(60, 512, 0.4, seed=94), 512)
    banded = np.zeros((300, 8192), dtype=np.uint8)
    rb = np.random.default_rng(96)
    banded[:64, :4096] = rb.random((64, 4096)) < 0.3
    banded[-44:, 4096:] = rb.random((44, 4096)) < 0.3
    d["banded"] = (pack_bits(banded), 8192)
    # streaming
    d["stream"] = (dense_packed(100, 2048, 0.2, seed=49), 2048)
    blocks = np.zeros((128, 16384), dtype=np.uint8)
    rz = np.random.default_rng(65)
    blocks[:64, :8192] = rz.random((64, 8192)) < 0.3
    blocks[64:, 8192:] = rz.random((64, 8192)) < 0.3
    d["stream_blocks"] = (pack_bits(blocks), 16384)
    return d


def bitmatrix(d: dict, name: str):
    from stormtpu_torch.layout import BitMatrix

    packed, m = d[name]
    return BitMatrix.from_packed(packed, m)


def threshold_of(d: dict, name: str, pct: float) -> int:
    """A count threshold at the ``pct`` percentile of the off-diagonal
    pairs (at least 1): a screen that keeps a few pairs."""
    packed, m = d[name]
    bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    c = bits @ bits.T
    return max(1, int(np.percentile(c[np.triu_indices(c.shape[0], 1)], pct)))


def _meshes(device):
    """Every mesh of ``SHAPES`` (None where this rank is not in it), made in
    the same order on every rank."""
    from stormtpu_torch.parallel import make_grid_mesh, make_row_mesh

    meshes = {f"r{r}": make_row_mesh(r, device=device) for r in ROWS}
    meshes.update({f"g{a}x{b}": make_grid_mesh(a, b, device=device) for a, b in GRIDS})
    return meshes


def _run(device, table: dict) -> dict:
    d = data()
    meshes = _meshes(device)
    out = {}
    for name, (fn, shapes) in table.items():
        for shape in shapes:
            if meshes[shape] is not None:
                out[(name, shape)] = fn(meshes[shape], d)
    return out


ALL_1D = tuple(f"r{r}" for r in ROWS)
ALL_2D = tuple(f"g{a}x{b}" for a, b in GRIDS)


# ------------------------------------------------------------------ allpairs
def _count(name, **kw):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_count_matrix

        return distributed_count_matrix(d[name][0], mesh=mesh, **kw)

    return fn


def _columns(mesh, d):
    from stormtpu_torch.parallel import distributed_column_counts

    return distributed_column_counts(bitmatrix(d, "columns"), mesh=mesh, chunk_words=8)


def _cardinality(name, op):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_pairwise_cardinality

        return distributed_pairwise_cardinality(bitmatrix(d, name), op, mesh=mesh)

    return fn


def _similarity(name, measure):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_similarity_matrix

        return distributed_similarity_matrix(bitmatrix(d, name), measure, mesh=mesh)

    return fn


def _block_fn_ring(mesh, d):
    """A caller's block kernel on the ring and on the bits axis (the square
    form): the plain int8 product."""
    from stormtpu_torch.kernels.xla import count_block_int8_xla
    from stormtpu_torch.parallel import distributed_count_matrix

    packed = d["dense30"][0]
    return (distributed_count_matrix(packed, mesh=mesh, block_fn=count_block_int8_xla),
            distributed_count_matrix(packed, mesh=mesh, block_fn=count_block_int8_xla,
                                     shard_axis="bits"))


ALLPAIRS = {
    "rows_dense": (_count("dense30"), ALL_1D),
    "rows_ragged": (_count("ragged"), ALL_1D + ALL_2D),
    "rows_eye": (_count("eye"), ALL_1D),
    "rows_sparse": (_count("sparse_dense"), ALL_1D),
    "block_fn": (_block_fn_ring, ("r3", "r8")),
    "bits_square": (_count("ragged", shard_axis="bits"), ALL_1D),
    "bits_tri": (_count("bits_tri", shard_axis="bits"), ALL_1D),
    "bits_k5": (_count("bits_k5", shard_axis="bits"), ALL_1D),
    "columns": (_columns, ALL_1D + ALL_2D),
    "cardinality": (_cardinality("setops", "xor"), ALL_1D),
    "similarity": (_similarity("setops", "cosine"), ALL_1D),
    "grid_union": (_cardinality("grid_setops", "union"), ALL_2D),
    "grid_jaccard": (_similarity("grid_setops", "jaccard"), ALL_2D),
}


def _errors(device) -> dict:
    """What the meshes and the count functions refuse, as (type, message)."""
    from stormtpu_torch.parallel import (
        distributed_count_matrix,
        make_grid_mesh,
        make_row_mesh,
    )

    out = {}
    for key, call in (
        ("mesh9", lambda: make_row_mesh(WORLD + 1, device=device)),
        ("grid3x3", lambda: make_grid_mesh(3, 3, device=device)),
        ("grid0", lambda: make_grid_mesh(0, 2, device=device)),
        ("shard_axis", lambda: distributed_count_matrix(
            np.zeros((8, 8), np.uint32), mesh=make_row_mesh(device=device),
            shard_axis="cols")),
    ):
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


#: meshes named by their ranks (``devices=``), out of rank order
DEVICE_MESHES = {"row": (None, (5, 2, 7)), "grid": ((2, 2), (7, 6, 1, 4)),
                 "head": (2, (3, 0, 6))}


def _devices_cases(device) -> dict:
    """On each mesh of ``DEVICE_MESHES`` this rank is in: the mesh's ranks
    in order, the ring's count matrix of ``ragged`` and the ring's top-k of
    ``topk_sparse``; and what ``devices=`` refuses."""
    from stormtpu_torch.parallel import (
        distributed_count_matrix,
        distributed_topk_neighbors,
        make_grid_mesh,
        make_row_mesh,
    )

    d = data()
    out = {}
    for key, (shape, ranks) in DEVICE_MESHES.items():
        mesh = (make_grid_mesh(*shape, devices=ranks, device=device) if isinstance(shape, tuple)
                else make_row_mesh(shape, devices=ranks, device=device))
        if mesh is not None:
            out[("devices", key)] = (
                tuple(int(r) for r in mesh.devices.flat),
                distributed_count_matrix(d["ragged"][0], mesh=mesh),
                distributed_topk_neighbors(bitmatrix(d, "topk_sparse"), 8, mesh=mesh))
    errs = {}
    for key, call in (
        ("row_short", lambda: make_row_mesh(4, devices=(0, 1), device=device)),
        ("grid_short", lambda: make_grid_mesh(2, 2, devices=(0, 1, 2), device=device)),
        ("not_a_rank", lambda: make_row_mesh(devices=(0, 8), device=device)),
        ("repeated", lambda: make_row_mesh(devices=(1, 1), device=device)),
    ):
        try:
            call()
            errs[key] = None
        except ValueError as e:
            errs[key] = str(e)
    out[("devices", "errors")] = errs
    return out


def run_allpairs(device) -> dict:
    out = _run(device, ALLPAIRS)
    out[("errors", "world")] = _errors(device)
    out.update(_devices_cases(device))
    return out


# ------------------------------------------------------------------- queries
def _topk(name, k, **kw):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_topk_neighbors

        return distributed_topk_neighbors(bitmatrix(d, name), k, mesh=mesh, **kw)

    return fn


def _screen(name, threshold, **kw):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_pairs_above

        t = threshold(d) if callable(threshold) else threshold
        return distributed_pairs_above(bitmatrix(d, name), t, mesh=mesh, **kw)

    return fn


def _cross_topk(mesh, d):
    from stormtpu_torch.parallel import distributed_cross_topk_neighbors

    return distributed_cross_topk_neighbors(bitmatrix(d, "cross_a"), bitmatrix(d, "cross_b"),
                                            3, mesh=mesh)


def _cross_screen(measure, threshold):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_cross_pairs_above

        return distributed_cross_pairs_above(bitmatrix(d, "cross_a"), bitmatrix(d, "cross_b"),
                                             threshold, measure=measure, mesh=mesh)

    return fn


def _row_sums(mesh, d):
    from stormtpu_torch.parallel import distributed_count_row_sums

    bm = bitmatrix(d, "row_sums")
    return (distributed_count_row_sums(bm, mesh=mesh, chunk_words=64),
            distributed_count_row_sums(bm, mesh=mesh, include_self=False))


def _hist(name, **kw):
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_count_histogram

        man = distributed_count_histogram(bitmatrix(d, name), mesh=mesh, **kw)
        return {k: man[k] for k in ("kernel", "hist", "bin_width", "bin_edges", "pairs",
                                    "stripes_skipped") if k in man}

    return fn


QUERY = {
    "topk": (_topk("topk", 5, block_rows=8), ALL_1D),
    "topk_small_shard": (_topk("topk_small", 7, block_rows=4), ALL_1D),
    "topk_default_blocks": (_topk("topk_small", 3), ("r1", "r3")),
    "topk_measure": (_topk("measure", 5, measure="jaccard"), ALL_1D),
    "topk_measure_r2": (_topk("measure", 5, measure="r2"), ("r2", "r5")),
    "topk_bits": (_topk("topk_bits", 5, shard_axis="bits"), ALL_1D),
    "topk_bits_fallback": (_topk("topk_small", 3, shard_axis="bits", block_rows=4), ("r8",)),
    "topk_measure_bits": (_topk("measure_bits", 4, shard_axis="bits", measure="r2"), ALL_1D),
    "topk_grid": (_topk("grid_q", 4, block_rows=8), ALL_2D),
    "topk_sparse": (_topk("topk_sparse", 8), ("r2", "r3")),
    "topk_sparse_bits": (_topk("topk_sparse", 8, shard_axis="bits"), ("r2", "r3")),
    "topk_measure_grid": (_topk("grid_measure", 4, measure="jaccard"), ALL_2D),
    "screen_count": (_screen("screen", 40, block_rows=8), ALL_1D),
    "screen_jaccard": (_screen("screen", 0.15, measure="jaccard", block_rows=8), ALL_1D),
    "screen_r2": (_screen("screen", 0.005, measure="r2", block_rows=8), ALL_1D),
    "screen_empty": (_screen("topk_small", 10**6, block_rows=4), ("r8",)),
    "screen_bits": (_screen("screen_bits", lambda d: threshold_of(d, "screen_bits", 99),
                            shard_axis="bits"), ALL_1D),
    "screen_bits_jaccard": (_screen("screen_bits", 0.02, measure="jaccard",
                                    shard_axis="bits"), ("r1", "r8")),
    "screen_bits_fallback": (_screen("topk_small", 50, shard_axis="bits", block_rows=4),
                             ("r8",)),
    "screen_grid": (_screen("grid_q", 40, block_rows=8), ALL_2D),
    "cross_topk": (_cross_topk, ALL_1D + ALL_2D),
    "cross_screen": (_cross_screen("count", 140), ALL_1D + ALL_2D),
    "cross_screen_jaccard": (_cross_screen("jaccard", 0.3), ("r1", "r3", "g4x2")),
    "row_sums": (_row_sums, ALL_1D + ALL_2D),
    "hist_ring": (_hist("hist", n_bins=8, block_rows=32, method="ring"), ALL_1D),
    "hist_auto": (_hist("hist", n_bins=8, block_rows=32), ("r1", "r8")),
    "hist_width": (_hist("hist_width", n_bins=97, bin_width=1, block_rows=32), ALL_2D),
    "hist_stripes": (_hist("banded", n_bins=8, superblock_rows=64), ALL_1D + ALL_2D),
    "hist_ring_banded": (_hist("banded", n_bins=8, method="ring", block_rows=32), ("r8",)),
    "hist_stripes_dense": (_hist("hist", n_bins=6, method="stripes", superblock_rows=32),
                           ("r2", "r8")),
}


def _query_errors(device) -> dict:
    from stormtpu_torch.parallel import (
        distributed_count_histogram,
        distributed_pairs_above,
        distributed_topk_neighbors,
        make_row_mesh,
    )

    mesh = make_row_mesh(device=device)
    bm = bitmatrix(data(), "topk_small")
    out = {}
    for key, call in (
        ("topk_axis", lambda: distributed_topk_neighbors(bm, 3, mesh=mesh, shard_axis="cols")),
        ("topk_k", lambda: distributed_topk_neighbors(bm, bm.n, mesh=mesh)),
        ("screen_axis", lambda: distributed_pairs_above(bm, 50, mesh=mesh, shard_axis="cols")),
        ("hist_small_n", lambda: distributed_count_histogram(
            bitmatrix({"one": (np.ones((1, 4), np.uint32), 128)}, "one"), mesh=mesh)),
        ("hist_method", lambda: distributed_count_histogram(bm, method="bogus", mesh=mesh)),
        ("hist_width", lambda: distributed_count_histogram(bm, bin_width=0, mesh=mesh)),
    ):
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def _row_shard(mesh, d, name, block_rows, fill: int = 0):
    """This rank's :class:`RowShard` of ``d[name]``, made from its own rows
    only (:func:`shard_rows`'s range), its padding rows ``fill``."""
    import torch

    from stormtpu_torch.parallel import RowShard, shard_rows

    packed, m = d[name]
    n = packed.shape[0]
    row0, row1 = shard_rows(n, m, mesh, block_rows=block_rows)
    real = packed[min(row0, n) : min(row1, n)]
    words = np.full((row1 - row0, packed.shape[1]), fill, np.uint32)
    words[: real.shape[0]] = real
    return RowShard(torch.from_numpy(words.view(np.int32)).to(mesh.device), row0, n, m)


def _sharded_topk(name, k, block_rows=None):
    """The sharded form, its padding rows zero and all ones (padding of any
    content is never ranked), beside the host form on the same mesh."""
    def fn(mesh, d):
        from stormtpu_torch.parallel import distributed_topk_neighbors

        got = [distributed_topk_neighbors(_row_shard(mesh, d, name, block_rows, fill), k,
                                          mesh=mesh, block_rows=block_rows)
               for fill in (0, 0xFFFFFFFF)]
        host = distributed_topk_neighbors(bitmatrix(d, name), k, mesh=mesh,
                                          block_rows=block_rows)
        return {"padded": got[0], "ones": got[1], "host": host}

    return fn


#: the sharded form: N not a multiple of R·block (at R = 5 and 8 the last
#: ranks' shards are all padding), k above a shard's rows, k = N − 1
SHARDED = {
    "sharded_topk": (_sharded_topk("topk", 5, block_rows=8), ALL_1D),
    "sharded_k_past_shard": (_sharded_topk("topk_small", 7, block_rows=4), ALL_1D),
    "sharded_k_max": (_sharded_topk("topk_small", 20, block_rows=4), ("r3", "r8")),
    "sharded_default_blocks": (_sharded_topk("topk_sparse", 8), ("r2", "r5")),
}


def _shifts(mesh, d):
    """``ring_shift_`` beside ``ppermute`` on a 5 × 3 buffer: staging
    buffers of 7 and 4 elements (neither divides 15), of the whole buffer,
    and the one :func:`shift_stage` sizes; shifts −1 and 2."""
    import torch

    from stormtpu_torch.parallel.mesh import ppermute, ring_shift_, shift_stage

    axis = mesh.axis_names[0]
    x = torch.arange(15, dtype=torch.int32).reshape(5, 3) + 100 * mesh.rank
    out = {}
    for shift in (-1, 2):
        want = ppermute(x, mesh, axis, shift)
        for c in (7, 4, 15, None):
            stage = shift_stage(x, mesh, axis) if c is None else torch.empty(c, dtype=x.dtype)
            buf = x.clone()
            got = ring_shift_(buf, mesh, axis, shift, stage)
            out[(shift, c)] = (got is buf, bool(torch.equal(got, want)), got.numpy().copy())
    return out


def _sharded_errors(device) -> dict:
    import torch

    from stormtpu_torch.parallel import RowShard, distributed_topk_neighbors, make_row_mesh
    from stormtpu_torch.parallel.mesh import ring_shift_

    mesh = make_row_mesh(device=device)
    d = data()
    good = _row_shard(mesh, d, "topk_small", 4)
    out = {}
    for key, call in (
        ("row0", lambda: distributed_topk_neighbors(
            RowShard(good.words, good.row0 + 1, good.n, good.m_bits), 3, mesh=mesh,
            block_rows=4)),
        ("rows", lambda: distributed_topk_neighbors(
            RowShard(torch.cat([good.words, good.words[:1]]), good.row0, good.n, good.m_bits),
            3, mesh=mesh,
            block_rows=4)),
        ("words", lambda: distributed_topk_neighbors(
            RowShard(good.words[:, :-1], good.row0, good.n, good.m_bits), 3, mesh=mesh,
            block_rows=4)),
        ("measure", lambda: distributed_topk_neighbors(good, 3, mesh=mesh, block_rows=4,
                                                       measure="jaccard")),
        ("k", lambda: distributed_topk_neighbors(good, good.n, mesh=mesh, block_rows=4)),
        ("strided", lambda: ring_shift_(torch.zeros(4, 6)[:, ::2], mesh,
                                        mesh.axis_names[0], 1)),
        ("stage", lambda: ring_shift_(torch.zeros(4, 6, dtype=torch.int32), mesh,
                                      mesh.axis_names[0], 1, torch.empty(5))),
    ):
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def run_query(device) -> dict:
    out = _run(device, QUERY)
    out.update(_run(device, SHARDED))
    out.update(_run(device, {"shifts": (_shifts, ALL_1D + ALL_2D)}))
    out[("errors", "world")] = _query_errors(device)
    out[("sharded_errors", "world")] = _sharded_errors(device)
    return out


def sharded_topk_group(device) -> dict:
    """Four ranks of a group, one a card (``run_group(4, "nccl",
    "cuda", ...)``): the sharded form over a 1,000 × 8,192-bit panel, the
    host form, and the in-place shift beside ``ppermute``, on the cards."""
    import torch

    from stormtpu_torch.parallel import make_row_mesh
    from stormtpu_torch.parallel.mesh import ppermute, ring_shift_

    mesh = make_row_mesh(device=device)
    d = {"panel": (dense_packed(1000, 8192, 0.3, seed=17), 8192)}
    got = _sharded_topk("panel", 9)(mesh, d)
    axis = mesh.axis_names[0]
    x = torch.arange(3 * 1001, dtype=torch.int32, device=mesh.device).reshape(3, 1001)
    x += 10**6 * mesh.rank
    want = ppermute(x, mesh, axis, -1)
    # gloo carries a card's tensor through page-locked host memory
    stage = (torch.empty(1000, dtype=x.dtype, pin_memory=True) if mesh.backend == "gloo"
             else torch.empty(1000, dtype=x.dtype, device=mesh.device))
    shifted = ring_shift_(x.clone(), mesh, axis, -1, stage)
    got["shift_equal"] = bool(torch.equal(shifted, want))
    got["backend"] = mesh.backend
    return got


# ----------------------------------------------------------------- multihost
def _stream(name, sb):
    def fn(mesh, d, root):
        from stormtpu_torch.parallel import distributed_stream_count_matrix

        out_dir = os.path.join(root, f"{name}_{mesh.size}_{'x'.join(map(str, mesh.devices.shape))}")
        calls = []
        man = distributed_stream_count_matrix(bitmatrix(d, name), out_dir, superblock_rows=sb,
                                              mesh=mesh, progress=lambda a, b: calls.append(a))
        again = []
        distributed_stream_count_matrix(bitmatrix(d, name), out_dir, superblock_rows=sb,
                                        mesh=mesh, progress=lambda a, b: again.append(a))
        return {"dir": out_dir, "manifest": man, "progress": calls, "progress_resumed": again}

    return fn


def _extend(mesh, d, root):
    """A directory of the first 80 rows, written by the single-device walk,
    grown to all 100 through the mesh."""
    from stormtpu_torch.config import EngineConfig
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.parallel.mesh import barrier
    from stormtpu_torch.stream import extend_streamed_matrix, stream_count_matrix

    packed, m = d["stream"]
    out_dir = os.path.join(root, f"extend_{mesh.size}_{'x'.join(map(str, mesh.devices.shape))}")
    if mesh.is_writer():
        stream_count_matrix(BitMatrix.from_packed(packed[:80], m), out_dir, superblock_rows=64,
                            kernel="mxu", config=EngineConfig(k2_tile_rows=32), device="cpu")
    barrier(mesh)
    man = extend_streamed_matrix(BitMatrix.from_packed(packed, m), out_dir, mesh=mesh)
    return {"dir": out_dir, "manifest": man}


MULTIHOST = {
    "stream": (_stream("stream", 64), ALL_1D + ALL_2D),
    "stream_zero_stripe": (_stream("stream_blocks", 64), ("r8",)),
    # the directory's superblock of 64 rows must be a multiple of R·8
    "extend": (_extend, ("r1", "r2", "r4", "r8") + ALL_2D),
}


def _scaling(device):
    from stormtpu_torch.parallel import measure_scaling

    return measure_scaling(n=128, m_bits=2048, device_counts=(1, 2, 4, 8), reps=1,
                           log=lambda *a: None, device=device)


#: config 5's rows here: an eighth of its scaled 2,048, whose plain int8
#: products would take eight CPU ranks over a minute (the card runs the
#: scaled size: chip_smoke.py phase 32)
CONFIG5_ROWS = 256


def _config5(device):
    from stormtpu_torch import acceptance

    acceptance.CONFIG5_SCALED = (CONFIG5_ROWS, acceptance.CONFIG5_SCALED[1])
    return acceptance.CONFIGS[5](False, lambda *a: None, device)


def _dryrun(device):
    from stormtpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(device=device)
    return True


def run_multihost(device, root: str) -> dict:
    d = data()
    meshes = _meshes(device)
    out = {}
    for name, (fn, shapes) in MULTIHOST.items():
        for shape in shapes:
            if meshes[shape] is not None:
                out[(name, shape)] = fn(meshes[shape], d, root)
    out[("scaling", "world")] = _scaling(device)
    out[("config5", "world")] = _config5(device)
    out[("dryrun", "world")] = _dryrun(device)
    return out


def fail_on_rank_1(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return dist.get_rank()


def hang_on_rank_1(device):
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(3600)
    return dist.get_rank()
