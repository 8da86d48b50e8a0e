#!/usr/bin/env python3
"""Time the ways to turn K2's tile stack into the N x N matrix on the host,
in one process on one card, at the main path's shape (2080 tiles of 256 x
256 into 16384 x 16384 int32, 1 GiB).

    python3 scripts/torch_assembly_d2h.py [--reps 3]

- ``host``: download the tile stack, assemble with numpy (the path before
  the assembly moved to the card);
- ``device``: assemble on the card, download the matrix into pageable
  memory (``.cpu()``): what ``count_matrix_pallas_mxu`` does;
- ``device_pinned``: the same, into a pinned buffer allocated inside the
  timed region;
- ``device_pinned_reused``: into a pinned buffer allocated once before.

The device assembly is first held against the numpy one, entry for entry,
on tiles with symmetric diagonal tiles. Host-clock seconds, synchronised;
one JSON line at the end, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_assembly_d2h: no CUDA card", file=sys.stderr)
        return 1
    from stormtpu_torch.utils import (assemble_triangular, assemble_triangular_torch,
                                      triangular_tile_ids)

    dev = torch.device("cuda")
    nb, ti = 64, 256
    n = nb * ti
    ibs, jbs = triangular_tile_ids(nb)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tiles = torch.randint(0, 1 << 20, (ibs.size, ti, ti), dtype=torch.int32, device=dev,
                          generator=gen)
    diag = torch.from_numpy(np.flatnonzero(ibs == jbs)).to(dev)
    tiles[diag] = torch.triu(tiles[diag]) + torch.triu(tiles[diag], 1).transpose(1, 2)

    def timed(fn):
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return r, out

    def device_pinned():
        full = assemble_triangular_torch(tiles, ibs, jbs, nb, n)
        host = torch.empty(full.shape, dtype=full.dtype, pin_memory=True)
        host.copy_(full)
        return host.numpy()

    reused = torch.empty((n, n), dtype=torch.int32, pin_memory=True)

    def device_pinned_reused():
        reused.copy_(assemble_triangular_torch(tiles, ibs, jbs, nb, n))
        return reused.numpy()

    res = {}
    want, res["host"] = timed(lambda: assemble_triangular(tiles.cpu().numpy(), ibs, jbs, nb, n))
    got, res["device"] = timed(
        lambda: assemble_triangular_torch(tiles, ibs, jbs, nb, n).cpu().numpy())
    if not np.array_equal(got, want):
        raise AssertionError("device assembly differs from the numpy assembly")
    got, res["device_pinned"] = timed(device_pinned)
    if not np.array_equal(got, want):
        raise AssertionError("pinned download differs")
    got, res["device_pinned_reused"] = timed(device_pinned_reused)
    if not np.array_equal(got, want):
        raise AssertionError("reused pinned download differs")
    _, res["device_assembly_only"] = timed(
        lambda: assemble_triangular_torch(tiles, ibs, jbs, nb, n))
    for k, v in res.items():
        print(f"[assembly] {k}: " + " / ".join(f"{x:.4f}" for x in v) + " s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
