"""Scaling measurement of the distributed ring (port of
``stormtpu/parallel/scaling.py``).

For each rank count R (the first R ranks of the group this process is
in), row-shard one N×W problem over a mesh of R ranks and time the ring
all-pairs: warm, each repetition on an input perturbed in one word, each
ending in a checksum summed over the ranks. Efficiency(R) = R0·T(R0) /
(R·T(R)), relative to the first count measured.

Every rank of the group must call it. Ranks outside a count's mesh wait;
the times are shared at the end, so every rank returns the same result.

Only ranks on distinct cards give a scaling figure. With one rank, or
ranks that share one card (or the CPU), the run checks the work division, the collectives and
the exactness, and its wall time is not a scaling figure: ``note`` says so,
as the JAX package does for forced host devices.
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["measure_scaling"]


def measure_scaling(
    n: int = 2048,
    m_bits: int = 65536,
    device_counts: Optional[Sequence[int]] = None,
    reps: int = 2,
    verify: bool = True,
    log=print,
    device=None,
) -> dict:
    """Time the ring all-pairs at each rank count; returns
    ``{"n", "m_bits", "platform", "note", "results": {R: {"seconds",
    "pairs_per_s", "efficiency"}}}``. ``device``: this rank's device
    (``None``: its card)."""
    import torch
    import torch.distributed as dist

    from stormtpu_torch.kernels import count_block_auto
    from stormtpu_torch.parallel.allpairs import ring_count_rows
    from stormtpu_torch.parallel.mesh import (
        fetch_global,
        join_group,
        local_shard,
        make_row_mesh,
        psum,
        rank_device,
    )
    from stormtpu_torch.utils import round_up

    dev = rank_device(device)
    join_group(dev)
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [r for r in (1, 2, 4, 8, 16, 32) if r <= world]
    rng = np.random.default_rng(7)
    w = m_bits // 32
    packed = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    ns = min(n, 32)
    if verify:
        sample = np.bitwise_count(packed[:ns, None, :] & packed[None, :ns, :]).sum(
            axis=2, dtype=np.int64)
    # where every rank of the group runs: one card each, or shared
    places = [None] * world
    dist.all_gather_object(places, (socket.gethostname(), str(dev)))

    seconds = np.zeros(len(device_counts), dtype=np.float64)
    for c, r in enumerate(device_counts):
        mesh = make_row_mesh(r, device=dev)
        if mesh is None:
            continue
        axis = mesh.axis_names[0]
        n_pad = round_up(max(n, r), r * 8)
        n_loc = n_pad // r
        i = mesh.axis_index(axis)
        fn = ring_count_rows(mesh, axis, n_loc, count_block_auto)
        xs = []
        for k in range(reps + 1):
            xq = packed.copy()
            if k:
                xq[0, 0] ^= np.uint32(k)  # a distinct input each repetition
            xs.append(local_shard(xq, (i * n_loc, (i + 1) * n_loc), (0, w), dev))
        c0 = fn(xs[0])
        if verify:
            got = fetch_global(c0, mesh)[:ns, :ns].astype(np.int64)
            if not np.array_equal(got, sample):
                raise AssertionError(f"the ring is inexact at R={r}")

        def checksum(x):
            s = (fn(x).to(torch.int64) % 251).sum().reshape(1)
            return int(psum(s, mesh, axis).item())

        checksum(xs[0])  # warm
        t0 = time.perf_counter()
        for x in xs[1:]:
            checksum(x)
        seconds[c] = (time.perf_counter() - t0) / reps
    # the times of the first rank, which is in every mesh
    shared = torch.from_numpy(seconds)
    if dist.get_backend() == "nccl":
        shared = shared.to(dev)
    dist.broadcast(shared, src=0)
    seconds = shared.cpu().numpy()

    results: dict[int, dict] = {}
    base = None
    for r, dt in zip(device_counts, seconds):
        if base is None:
            base = (r, dt)
        eff = (base[0] * base[1]) / (r * dt)
        pairs = float(n) * n
        results[r] = {"seconds": float(dt), "pairs_per_s": pairs / dt, "efficiency": eff}
        log(f"[scaling] R={r:3d}: {dt * 1e3:9.1f} ms  "
            f"{pairs / dt / 1e6:9.1f} M-pairs/s  efficiency {eff:.2f}")
    own_cards = dev.type == "cuda" and world > 1 and len(set(places)) == world
    return {
        "n": n,
        "m_bits": m_bits,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "note": (
            "real devices: one card a rank" if own_cards
            else "one rank, or ranks sharing one card or the CPU — structural "
            "validation only, efficiency is not a scaling figure"
        ),
        "results": results,
    }
