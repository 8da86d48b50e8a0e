#!/usr/bin/env python3
"""Time K2-topk and K2-hist (``csrc/k2_epilogue.cu``, on the TMA body)
beside K2-tri on the same tile lists, in one process on one card, to show
what the main loops and the epilogues cost.

    python3 scripts/torch_epilogue_ab.py [--seed 0] [--only TEXT] [--reps 10]

Two operands of uniform words made on the card: the main path's (16,384
rows x 262,144 bits) and two superblocks of config 4 (8,192 rows x
1,048,576 bits, a stripe's operand). On each, tile lists of 256-row
tiles: the first chunk of ``topk_neighbors``' walk (1024 tiles, the main
operand), a stripe's 16 x 16 off-diagonal tiles (the config-4 operand),
and on the main operand 1024 off-diagonal and 1024 diagonal tiles (ids
repeat): a diagonal tile's column side is not ranked, so the two lists
apart say what the row and the column passes each cost. Last, the main
path's first 4096 tiles at 128 rows: one sub-tile row a tile, so the TMA
body runs its clusters of one (the other lists run clusters of two). On
each list: K2-tri, K2-hist (64 bins) and K2-topk at k = 1, 4, 8, 16 and
32, with the cluster size the TMA body launched; the histogram and the
top-k sets (k = 1, 16) are held equal first to K2-tri's tiles reduced by
torch (``mxu.tile_hist``, ``mxu.tile_topk_sets``).

CUDA-event milliseconds, the mean of ``--reps`` launches after a warm-up;
one JSON line a list, then the card's name and power limit. The lines
also go to ``chiprun_out/epilogue_ab.jsonl``. ``--only TEXT`` keeps the
lists whose label holds TEXT; with ``--reps 1`` that makes a short run for
a profiler to wrap, as in

    ncu --metrics gpu__time_duration.sum,lts__t_sectors_op_read.sum \
        -k regex:"k2_(hist|topk|tri)" --launch-count 6 \
        python3 scripts/torch_epilogue_ab.py --only stripe --reps 1

(the first launches of each list: K2-tri, then K2-hist and K2-topk held
to K2-tri's tiles).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

KS = (1, 4, 8, 16, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="keep the lists whose label holds this text")
    ap.add_argument("--reps", type=int, default=10, help="launches timed a kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_epilogue_ab: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms
    from stormtpu_torch import query
    from stormtpu_torch.kernels import mxu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ti, wk = 256, 256

    def operand(rows: int, m_bits: int):
        return torch.randint(-(1 << 31), 1 << 31, (rows, m_bits // 32), dtype=torch.int32,
                             device=dev, generator=gen)

    main_x = operand(16_384, 1 << 18)
    nb = main_x.shape[0] // ti
    wib, wjb = query._blocked_tile_ids(nb, query._TILE_GROUP)
    rng = np.random.default_rng(args.seed)
    off_i = rng.integers(0, nb // 2, 1024).astype(np.int32)
    off_j = (off_i + rng.integers(1, nb // 2, 1024)).astype(np.int32)
    diag = rng.integers(0, nb, 1024).astype(np.int32)
    stripe_x = operand(8_192, 1 << 20)
    tps = 16
    loc_i, loc_j = (g.ravel().astype(np.int32) for g in np.meshgrid(
        np.arange(tps), np.arange(tps), indexing="ij"))
    sib, sjb = query._blocked_tile_ids(main_x.shape[0] // 128, query._TILE_GROUP)
    lists = (
        ("main path, first walk chunk", main_x, wib[:1024], wjb[:1024], ti),
        ("main operand, 1024 off-diagonal tiles", main_x, off_i, off_j, ti),
        ("main operand, 1024 diagonal tiles", main_x, diag, diag, ti),
        ("config-4 stripe (0, 1)", stripe_x, loc_i, loc_j + tps, ti),
        ("main path at 128-row tiles, first 4096", main_x, sib[:4096], sjb[:4096], 128),
    )
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    lines = []
    for label, x, ib, jb, rows in (entry for entry in lists if args.only in entry[0]):
        ids = mxu.device_tile_ids(ib, jb, x.shape[0] // rows, dev)
        kw = dict(tile_rows=rows, tile_words=wk, checked=ids)
        n_real = x.shape[0]
        row = {"list": label, "tiles": int(ib.size), "tile_rows": rows,
               "words": int(x.shape[1]), "cluster": mxu.epilogue_cluster(rows),
               "k2_tri_ms": cuda_ms(torch, lambda: mxu.count_tiles_pallas_mxu(x, *ids, **kw),
                                    reps=args.reps)}
        hkw = dict(n_real=n_real, bin_width=(x.shape[1] * 32 + 64) // 64, n_bins=64, **kw)
        tiles = mxu.count_tiles_pallas_mxu(x, *ids, **kw)
        red_kw = dict(n_real=n_real, bin_width=hkw["bin_width"], n_bins=64)
        same = torch.equal(mxu.count_tiles_hist(x, *ids, **hkw),
                           mxu.tile_hist(tiles, *ids, **red_kw))
        for k in (1, 16):
            same &= all(torch.equal(a, b) for a, b in zip(
                mxu.count_tiles_topk(x, *ids, k=k, n_real=n_real, **kw),
                mxu.tile_topk_sets(tiles, *ids, k=k, n_real=n_real)))
        del tiles
        if not same:
            raise AssertionError(f"{label}: the epilogues differ from K2-tri's tiles")
        row["k2_hist_ms"] = cuda_ms(torch, lambda: mxu.count_tiles_hist(x, *ids, **hkw),
                                    reps=args.reps)
        for k in KS:
            row[f"k2_topk_k{k}_ms"] = cuda_ms(torch, lambda: mxu.count_tiles_topk(
                x, *ids, k=k, n_real=n_real, **kw), reps=args.reps)
        lines.append(row)
        print(json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    with open(out_dir / "epilogue_ab.jsonl", "w") as f:
        for row in lines:
            f.write(json.dumps({**row, "card": smi}) + os.linesep)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
