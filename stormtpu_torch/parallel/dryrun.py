"""Process groups spawned for a run, and the multi-rank dry run (the port's
twin of the JAX package's ``dryrun_multichip``).

:func:`run_group` starts ``world`` processes (``spawn``), joins them in a
process group on a ``FileStore`` in a temporary directory, calls
``fn(device, *args)`` on every rank and returns each rank's result. It is
bounded: when ``timeout`` runs out, or a rank fails, every process is
killed and the call raises. The tests use it with gloo on the CPU;
``chip_smoke.py`` with gloo and every rank on one card.

:func:`dryrun_multichip` runs every public ``distributed_*`` entry point of
``stormtpu_torch.parallel`` on tiny shapes over the ranks of the group
this process is in, and holds each result against the NumPy oracle or the
single-device form; it raises on the first difference.

    python -m stormtpu_torch.parallel.dryrun --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np

__all__ = ["dryrun_multichip", "run_group"]


def _rank_main(rank: int, world: int, backend: str, device: str, store_path: str,
               timeout: float, fn: Callable, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    try:
        if device.startswith("cuda"):
            from stormtpu_torch.parallel.mesh import rank_device

            torch.cuda.set_device(rank_device(device))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_group(world: int, backend: str, device: str, fn: Callable, *args,
              timeout: float = 120.0) -> list:
    """``fn(device, *args)`` on each rank of a new ``world``-rank group
    (``backend`` "gloo" or "nccl"); returns the ranks' results in rank
    order. ``fn`` and its arguments and results must pickle (``fn`` a
    module-level function). ``device``: "cpu", "cuda" (rank r on card
    ``r % device_count``) or "cuda:i" (every rank on card i). Raises
    ``RuntimeError`` with the rank's traceback when a rank fails, and
    ``TimeoutError`` when the group has not ended within ``timeout``
    seconds; either way no process outlives the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="stormtpu_torch_group_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, backend, device, os.path.join(tmp, "store"),
                               timeout, fn, args, results))
             for rank in range(world)]
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {world}-rank group did not end within {timeout} s "
                                   f"(ranks done: {sorted(got)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {world} died without a result "
                                       f"(exit codes {[procs[i].exitcode for i in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]


def dryrun_multichip(n_ranks: Optional[int] = None, device=None) -> None:
    """Run every public ``distributed_*`` entry point over a row mesh of
    the first ``n_ranks`` ranks (default: all) of this process's group —
    and a [R/2 × 2] grid where R is even and at least 4 — on tiny shapes,
    and hold each result against the NumPy oracle or the single-device
    form. Every rank of the group must call it; raises
    ``AssertionError`` naming the first result that differs."""
    from stormtpu_torch import similarity_matrix
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.oracle import oracle_count_block, oracle_count_matrix
    from stormtpu_torch.parallel import (
        distributed_column_counts,
        distributed_count_histogram,
        distributed_count_matrix,
        distributed_count_row_sums,
        distributed_cross_pairs_above,
        distributed_cross_topk_neighbors,
        distributed_pairs_above,
        distributed_pairwise_cardinality,
        distributed_similarity_matrix,
        distributed_stream_count_matrix,
        distributed_topk_neighbors,
        make_grid_mesh,
        make_row_mesh,
    )
    from stormtpu_torch.parallel.mesh import barrier, join_group
    from stormtpu_torch.setops import derive_similarity
    from stormtpu_torch.stream import load_streamed_matrix

    import torch.distributed as dist

    join_group(device)
    mesh = make_row_mesh(n_ranks, device=device)
    r = n_ranks or dist.get_world_size()
    grid = make_grid_mesh(r // 2, 2, device=device) if r >= 4 and r % 2 == 0 else None
    if mesh is None:
        return
    rng = np.random.default_rng(1)

    def check(name, got, want):
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"multi-rank dry run: {name} inexact")

    def top_values(c, k):
        c = np.array(c, dtype=np.int64)
        np.fill_diagonal(c, -1)
        return -np.sort(-c, axis=1)[:, :k]

    # rows axis, ragged N
    n, w = 8 * r + 3, 16
    packed = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    want = oracle_count_matrix(packed)
    check("count_matrix rows", distributed_count_matrix(packed, mesh=mesh), want)
    bm = BitMatrix.from_packed(packed, m_bits=w * 32)
    tri = want[np.triu_indices(n, 1)]
    thresh = max(1, int(np.percentile(tri, 90)))
    ii, jj, vv = distributed_pairs_above(bm, thresh, mesh=mesh, block_rows=8)
    si, sj = np.nonzero(np.triu(want, 1) >= thresh)
    check("pairs_above rows (ii)", ii, si.astype(np.int32))
    check("pairs_above rows (vv)", vv, want[si, sj])
    vals, _ = distributed_topk_neighbors(bm, 3, mesh=mesh, block_rows=8)
    check("topk rows (values)", vals, top_values(want, 3))
    mv, mi = distributed_topk_neighbors(bm, 3, mesh=mesh, block_rows=8, measure="jaccard")
    sim = derive_similarity(want, bm.row_nnz[:, None], bm.row_nnz[None, :], bm.m_bits,
                            "jaccard")
    np.fill_diagonal(sim, -np.inf)
    want_mi = np.stack([np.lexsort((np.arange(n), -sim[i]))[:3] for i in range(n)])
    check("topk rows measure (indices)", mi, want_mi.astype(np.int32))
    check("topk rows measure (values)", mv, np.take_along_axis(sim, want_mi, axis=1))
    check("column_counts", distributed_column_counts(bm, mesh=mesh),
          bm.to_dense().sum(axis=0).astype(np.int32))
    check("count_row_sums rows", distributed_count_row_sums(bm, mesh=mesh),
          np.asarray(want, dtype=np.int64).sum(axis=1))
    man = distributed_count_histogram(bm, n_bins=5, mesh=mesh, block_rows=32)
    want_h = np.zeros(5, dtype=np.int64)
    np.add.at(want_h, np.minimum(tri // man["bin_width"], 4), 1)
    check("count_histogram rows", man["hist"], want_h)
    check("pairwise_cardinality union",
          distributed_pairwise_cardinality(bm, "union", mesh=mesh),
          bm.row_nnz[:, None] + bm.row_nnz[None, :] - want)
    check("similarity_matrix jaccard", distributed_similarity_matrix(bm, "jaccard", mesh=mesh),
          similarity_matrix(bm, "jaccard", device=mesh.device))
    tmp = tempfile.mkdtemp(prefix="stormtpu_torch_dryrun_") if mesh.is_writer() else None
    try:
        holder = [tmp]
        if mesh.size > 1:
            dist.broadcast_object_list(holder, src=int(mesh.devices.flat[0]),
                                       group=mesh.axis_group(mesh.axis_names[0]))
        distributed_stream_count_matrix(bm, holder[0], superblock_rows=2 * r + 8, mesh=mesh)
        check("stream round-trip", load_streamed_matrix(holder[0]), want)
        barrier(mesh)  # every rank has read the directory before it goes
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    # cross-set: A on every rank, the reference panel row-sharded
    packed_q = rng.integers(0, 2**32, (5, w), dtype=np.uint32)
    bq = BitMatrix.from_packed(packed_q, m_bits=w * 32)
    want_x = oracle_count_block(packed_q, packed).astype(np.int64)
    xv, _ = distributed_cross_topk_neighbors(bq, bm, 3, mesh=mesh)
    check("cross topk (values)", xv, -np.sort(-want_x, axis=1)[:, :3])
    thresh_x = max(1, int(np.percentile(want_x.ravel(), 90)))
    xi2, _, xv2 = distributed_cross_pairs_above(bq, bm, thresh_x, mesh=mesh)
    wi_x, wj_x = np.nonzero(want_x >= thresh_x)
    check("cross screen (ii)", xi2, wi_x.astype(np.int32))
    check("cross screen (vv)", xv2, want_x[wi_x, wj_x].astype(np.int32))

    # bits axis: W ≥ R·128 words takes the K-shard tile paths
    nb_, wb_ = 2 * r + 5, r * 128 + 7
    packed_b = rng.integers(0, 2**32, (nb_, wb_), dtype=np.uint32)
    packed_b &= rng.integers(0, 2**32, (nb_, wb_), dtype=np.uint32)
    packed_b &= rng.integers(0, 2**32, (nb_, wb_), dtype=np.uint32)
    want_b = oracle_count_matrix(packed_b)
    check("count_matrix bits",
          distributed_count_matrix(packed_b, mesh=mesh, shard_axis="bits"), want_b)
    bmb = BitMatrix.from_packed(packed_b, m_bits=wb_ * 32)
    thresh_b = max(1, int(np.percentile(want_b[np.triu_indices(nb_, 1)], 90)))
    ii, jj, vv = distributed_pairs_above(bmb, thresh_b, mesh=mesh, shard_axis="bits")
    si, sj = np.nonzero(np.triu(want_b, 1) >= thresh_b)
    check("pairs_above bits (ii)", ii, si.astype(np.int32))
    check("pairs_above bits (vv)", vv, want_b[si, sj])
    vals, _ = distributed_topk_neighbors(bmb, 3, mesh=mesh, shard_axis="bits")
    check("topk bits (values)", vals, top_values(want_b, 3))

    # bits axis, block-clustered: the sharded K5 work lists (a quarter of
    # the words occupied; ranks whose slice is empty write filler zeros)
    nc, wc = 2 * r + 5, r * 512
    packed_c = np.zeros((nc, wc), dtype=np.uint32)
    packed_c[:, : wc // 4] = rng.integers(0, 2**32, (nc, wc // 4), dtype=np.uint32)
    check("count_matrix bits clustered (K5)",
          distributed_count_matrix(packed_c, mesh=mesh, shard_axis="bits"),
          oracle_count_matrix(packed_c))

    # 2-D [rows × bits] mesh: the ring plus the sum over word slices
    if grid is not None:
        n2, w2 = 3 * r + 1, 2 * r + 3
        packed_2d = rng.integers(0, 2**32, (n2, w2), dtype=np.uint32)
        want_2d = oracle_count_matrix(packed_2d)
        check("count_matrix 2d mesh", distributed_count_matrix(packed_2d, mesh=grid), want_2d)
        bm2d = BitMatrix.from_packed(packed_2d, m_bits=w2 * 32)
        v2d, _ = distributed_topk_neighbors(bm2d, 3, mesh=grid, block_rows=8)
        check("topk 2d mesh", v2d, top_values(want_2d, 3))
        thr2 = max(1, int(np.percentile(want_2d[np.triu_indices(n2, 1)], 90)))
        i2, j2, v2 = distributed_pairs_above(bm2d, thr2, mesh=grid, block_rows=8)
        si2, sj2 = np.nonzero(np.triu(want_2d, 1) >= thr2)
        check("pairs_above 2d mesh (ii)", i2, si2.astype(np.int32))
        check("pairs_above 2d mesh (jj)", j2, sj2.astype(np.int32))
        check("pairs_above 2d mesh (vv)", v2, want_2d[si2, sj2])
        check("count_row_sums 2d mesh", distributed_count_row_sums(bm2d, mesh=grid),
              np.asarray(want_2d, dtype=np.int64).sum(axis=1))


def _dryrun_rank(device: str, n_ranks: Optional[int]) -> bool:
    dryrun_multichip(n_ranks, device=device)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-rank dry run of stormtpu_torch.parallel")
    ap.add_argument("--ranks", type=int, default=4, help="ranks to spawn")
    ap.add_argument("--device", default="cuda",
                    help="'cpu', 'cuda' (a card a rank) or 'cuda:i' (every rank on card i)")
    ap.add_argument("--backend", default=None, help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    run_group(args.ranks, backend, args.device, _dryrun_rank, None, timeout=args.timeout)
    print(f"dryrun_multichip over {args.ranks} ranks ({backend}, {args.device}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
