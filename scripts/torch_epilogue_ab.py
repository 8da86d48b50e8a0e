#!/usr/bin/env python3
"""Time K2-topk and K2-hist (``csrc/k2_epilogue.cu``) beside K2-tri on the
same tile lists, in one process on one card, to show what the epilogues
cost and where.

    python3 scripts/torch_epilogue_ab.py [--seed 0]

Two operands of uniform words made on the card: the main path's (16,384
rows x 262,144 bits) and two superblocks of config 4 (8,192 rows x
1,048,576 bits, a stripe's operand). On each, tile lists of 256-row
tiles: the first chunk of ``topk_neighbors``' walk (1024 tiles, the main
operand), a stripe's 16 x 16 off-diagonal tiles (the config-4 operand),
and on the main operand 1024 off-diagonal and 1024 diagonal tiles (ids
repeat): a diagonal tile's column side is not ranked, so the two lists
apart say what the row and the column passes each cost. On each list:
K2-tri, K2-hist (64 bins) and K2-topk at k = 1, 4, 8, 16 and 32.

CUDA-event milliseconds, the mean of 10 launches after a warm-up; one
JSON line a list, then the card's name and power limit. The lines also go
to ``chiprun_out/epilogue_ab.jsonl``.
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
    lists = (
        ("main path, first walk chunk", main_x, wib[:1024], wjb[:1024]),
        ("main operand, 1024 off-diagonal tiles", main_x, off_i, off_j),
        ("main operand, 1024 diagonal tiles", main_x, diag, diag),
        ("config-4 stripe (0, 1)", stripe_x, loc_i, loc_j + tps),
    )
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    lines = []
    for label, x, ib, jb in lists:
        ids = mxu.device_tile_ids(ib, jb, x.shape[0] // ti, dev)
        kw = dict(tile_rows=ti, tile_words=wk, checked=ids)
        n_real = x.shape[0]
        row = {"list": label, "tiles": int(ib.size), "words": int(x.shape[1]),
               "k2_tri_ms": cuda_ms(torch, lambda: mxu.count_tiles_pallas_mxu(x, *ids, **kw),
                                    reps=10),
               "k2_hist_ms": cuda_ms(torch, lambda: mxu.count_tiles_hist(
                   x, *ids, n_real=n_real, bin_width=(x.shape[1] * 32 + 64) // 64, n_bins=64,
                   **kw), reps=10)}
        for k in KS:
            row[f"k2_topk_k{k}_ms"] = cuda_ms(torch, lambda: mxu.count_tiles_topk(
                x, *ids, k=k, n_real=n_real, **kw), reps=10)
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
