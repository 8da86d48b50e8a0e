"""Joining a multi-process group, and the distributed streaming walk
(port of ``stormtpu/parallel/multihost.py``).

:func:`initialize_multihost` joins this process to a ``torch.distributed``
group: from the arguments (coordinator ``host:port``, world size, rank), or
with none from the environment ``torchrun`` sets. Call it once per process
before building meshes; ``make_row_mesh`` joins the ``torchrun`` group by
itself too.

:func:`distributed_stream_count_matrix` produces the count matrix as
superblock stripes on disk (the 1M × 1M acceptance config, whose N²·int32
result is terabytes): each stripe is computed data-parallel over the mesh
(the stripe's i rows shared among the ranks, its j rows on every rank) and
written by the mesh's first rank, in the directory format of
``stream.py`` (manifest ``"kernel": "distributed"``; resumable by file),
which both packages load.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.layout import BitMatrix
from stormtpu_torch.parallel.mesh import (
    GROUP_TIMEOUT_S,
    Mesh,
    barrier,
    fetch_global,
    local_shard,
    make_row_mesh,
    rank_device,
)
from stormtpu_torch.utils import round_up

__all__ = ["initialize_multihost", "distributed_stream_count_matrix"]

BlockFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> None:
    """Join a multi-process group: ``coordinator_address`` ("host:port" of
    rank 0's store), ``num_processes`` and ``process_id``, or with none of
    them the ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). NCCL when this rank's device (``None``: its
    card) is a card, gloo for the CPU."""
    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if coordinator_address is None and num_processes is None and process_id is None:
        dist.init_process_group(backend, timeout=timeout)
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("pass all of coordinator_address, num_processes and process_id, "
                         "or none (the torchrun environment)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)


def distributed_stream_count_matrix(
    bm: BitMatrix,
    out_dir: str,
    *,
    superblock_rows: int = 8192,
    mesh: Optional[Mesh] = None,
    config: Optional[EngineConfig] = None,
    block_fn: Optional[BlockFn] = None,
    resume: bool = True,
    compress: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """Stream all upper-triangular superblock stripes of the count
    matrix, each computed data-parallel over ``mesh`` (default:
    :func:`make_row_mesh` on ``device``). Every rank computes; only the
    mesh's first rank writes (stripe files and the manifest). The
    superblock's per-K-group summary marks the stripes that are exactly
    zero: those never reach a device and are written as empty
    sparse-tile records."""
    from stormtpu_torch.stream import _content_fingerprint, _save_stripe, stripe_path

    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    if mesh is None:
        mesh = make_row_mesh(device=device)
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    superblock_rows = round_up(superblock_rows, r * 8)
    if block_fn is None:
        from stormtpu_torch.kernels import count_block_auto

        block_fn = lambda a, b: count_block_auto(a, b, config=cfg)  # noqa: E731

    sb = superblock_rows
    n_pad = round_up(bm.n, sb)
    n_super = n_pad // sb
    n_loc = sb // r
    my = mesh.axis_index(axis)
    w = bm.n_words
    dev = mesh.device

    # the summary skip at superblock granularity, decided alike on every
    # rank with no collective
    occ_sb = None
    if bm.n and bm.n_words:
        occ_rows = bm.block_summary(block_bits=128 * 32).astype(bool)
        occ_pad = np.zeros((n_pad, occ_rows.shape[1]), dtype=bool)
        occ_pad[: bm.n] = occ_rows
        occ_sb = occ_pad.reshape(n_super, sb, -1).any(axis=1)

    is_writer = mesh.is_writer()
    if is_writer:
        os.makedirs(out_dir, exist_ok=True)
    # every rank reads which stripes exist before the writer writes one,
    # so that all ranks resume the same stripes
    done_before = set()
    if resume and os.path.isdir(out_dir):
        done_before = {(i, j) for i in range(n_super) for j in range(i, n_super)
                       if os.path.exists(stripe_path(out_dir, i, j))}
    barrier(mesh)

    manifest = {
        "n": bm.n,
        "content": _content_fingerprint(bm),
        "m_bits": bm.m_bits,
        "superblock_rows": superblock_rows,
        "n_super": n_super,
        "kernel": "distributed",
        "tile_rows": 8,  # assembly unit of zero (sparse-tile) stripes
        "completed": [],
    }
    total = n_super * (n_super + 1) // 2
    done = 0
    for i in range(n_super):
        xi = None  # uploaded when first needed: an all-skipped row never is
        for j in range(i, n_super):
            path = stripe_path(out_dir, i, j)
            if (i, j) in done_before:
                manifest["completed"].append([i, j])
                done += 1
                continue
            if occ_sb is not None and not (occ_sb[i] & occ_sb[j]).any():
                if is_writer:
                    z = np.zeros(0, dtype=np.int32)
                    _save_stripe(path, False, dict(tiles=np.zeros((0, 8, 8), dtype=np.int32),
                                                   loc_i=z, loc_j=z, i=i, j=j))
            else:
                if xi is None:
                    r0 = i * sb + my * n_loc
                    xi = local_shard(bm.packed, (r0, r0 + n_loc), (0, w), dev)
                xj = local_shard(bm.packed, (j * sb, (j + 1) * sb), (0, w), dev)
                # row-sharded stripe: every rank takes part in the gather,
                # though only the writer writes
                stripe = fetch_global(block_fn(xi, xj).to(torch.int32), mesh)
                if is_writer:
                    _save_stripe(path, compress, dict(counts=stripe, i=i, j=j))
            manifest["completed"].append([i, j])
            done += 1
            if progress is not None:
                progress(done, total)
    if is_writer:
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    barrier(mesh)
    return manifest
