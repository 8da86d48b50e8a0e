#!/usr/bin/env python3
"""Time the query walks' pieces at config 4's shape (100,000 x 1,048,576
bits), in one process on one card, in turns.

    python3 scripts/torch_query_ab.py [--seed 0]

1. K2 over the whole triangle of the query tile walk (76,636 tiles of
   256 rows in chunks of 1024, an operand of uniform words made on the
   card) with the tile list in i-major order and in the walk's blocked
   order (``query._blocked_tile_ids``): blocked, i-major, i-major, blocked.
2. The top-k merge's pieces on one chunk of count tiles at config 4's
   counts (mean 262,144, sd 443): ``torch.topk`` of k = 8 along a tile's
   rows and along its columns, the walk's own per-row top-k
   (``query._top_rows``), and ``query._merge_sets`` on the candidates of
   a chunk of the blocked list.
3. The histogram's bin pass on a stripe of 256 tiles: ``torch.bincount``
   of the bins as they are, and with the contention spread over 32
   sub-bins a bin (``stream_hist._bin_counts``).

CUDA-event milliseconds, the mean of several launches after a warm-up;
one line a section, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_query_ab: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms
    from stormtpu_torch import query, stream_hist
    from stormtpu_torch.kernels import mxu
    from stormtpu_torch.utils import triangular_tile_ids

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ti, wk, chunk, k = 256, 256, 1024, 8

    # 1. K2 over the triangle in two tile orders
    n_pad, w = 100_096, 1 << 15
    xd = torch.randint(-(1 << 31), 1 << 31, (n_pad, w), dtype=torch.int32, device=dev,
                       generator=gen)
    nb = n_pad // ti
    orders = {"i-major": triangular_tile_ids(nb), "blocked": query._blocked_tile_ids(nb, 16)}

    def walk(name):
        ib, jb = orders[name]
        ids = [mxu.device_tile_ids(ib[c : c + chunk], jb[c : c + chunk], nb, dev)
               for c in range(0, ib.size, chunk)]

        def run():
            for i in ids:
                mxu.count_tiles_pallas_mxu(xd, *i, tile_rows=ti, tile_words=wk, checked=i)
        return cuda_ms(torch, run, reps=1)

    k2 = {name: [] for name in orders}
    for name in ("blocked", "i-major", "i-major", "blocked"):
        k2[name].append(round(walk(name), 2))
    print(f"[query ab] K2 over {orders['blocked'][0].size} tiles in chunks of {chunk}, ms: {k2}")
    del xd
    torch.cuda.empty_cache()

    # 2. the merge's pieces on one chunk
    tiles = (262_144 + 443 * torch.randn((chunk, ti, ti), device=dev, generator=gen)
             ).to(torch.int32)
    ib, jb = orders["blocked"]
    ib_c, jb_c = ib[5000 : 5000 + chunk], jb[5000 : 5000 + chunk]
    off = np.flatnonzero(ib_c != jb_c)
    o = torch.from_numpy(off).to(dev)
    rv, ri = query._top_rows(tiles, k)
    mv, mi = query._top_rows(tiles[o].transpose(1, 2), k)
    for got, want in ((rv, torch.topk(tiles, k, dim=2).values),
                      (mv, torch.topk(tiles[o].transpose(1, 2), k, dim=2).values)):
        if not torch.equal(got.sort(dim=2).values, want.sort(dim=2).values):
            raise AssertionError("the walk's per-row top-k differs from torch.topk")
    ri = ri + torch.from_numpy(jb_c.astype(np.int64)).to(dev)[:, None, None] * ti
    mi = mi + torch.from_numpy(ib_c[off].astype(np.int64)).to(dev)[:, None, None] * ti
    best_v = torch.full((nb * ti, k), -1, dtype=torch.int32, device=dev)
    best_i = torch.zeros((nb * ti, k), dtype=torch.int64, device=dev)
    tgt = np.concatenate([ib_c, jb_c[off]])
    cv, ci = torch.cat([rv, mv]), torch.cat([ri, mi])
    merge = {
        "torch.topk rows": cuda_ms(torch, lambda: torch.topk(tiles, k, dim=2), reps=10),
        "torch.topk columns (off-diagonal tiles)": cuda_ms(
            torch, lambda: torch.topk(tiles[o].transpose(1, 2), k, dim=2), reps=10),
        "_top_rows rows": cuda_ms(torch, lambda: query._top_rows(tiles, k), reps=10),
        "_top_rows columns (off-diagonal tiles)": cuda_ms(
            torch, lambda: query._top_rows(tiles[o].transpose(1, 2), k), reps=10),
        "_merge_sets": cuda_ms(torch, lambda: query._merge_sets(best_v, best_i, tgt, cv, ci, ti),
                               reps=10),
    }
    print(f"[query ab] merge pieces on a chunk of {chunk} tiles of {ti}^2, k={k}, ms: "
          + ", ".join(f"{name} {v:.3f}" for name, v in merge.items()))

    # 3. the bin pass on a stripe of 256 tiles, 64 bins of width 4200
    bins = torch.clamp(tiles[:256] // 4200, max=63).flatten()
    plain = torch.bincount(bins, minlength=65)
    if not torch.equal(stream_hist._bin_counts(bins, 65), plain):
        raise AssertionError("the spread bin count differs from torch.bincount")
    binning = {
        "torch.bincount": cuda_ms(torch, lambda: torch.bincount(bins, minlength=65), reps=10),
        "_bin_counts (32 sub-bins)": cuda_ms(torch, lambda: stream_hist._bin_counts(bins, 65),
                                             reps=10),
    }
    print(f"[query ab] bin count of {bins.numel()} values into 65 bins, ms: "
          + ", ".join(f"{name} {v:.3f}" for name, v in binning.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
