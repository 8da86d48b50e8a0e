#!/usr/bin/env python3
"""Time the port's kernels of two source trees in one run on one card.

    python3 scripts/torch_k2_ab.py PARENT_DIR CHANGE_DIR

Each directory holds a ``stormtpu_torch/`` package and ``chip_smoke.py``
(for example unpacked with ``git archive <commit> stormtpu_torch
chip_smoke.py``). The trees run in turn, parent, change, change, parent,
each in a fresh process that builds its own CUDA sources and times, with
CUDA events, through the wrappers: K2's triangular walk at 16384 × 262144
bits (T = 2080 tiles of 256 × 256) and its rectangle at 4096 × 16384 rows
of the same width (10 launches each); K1's walk on the same rows (T = 8256
tiles of 128 × 128; 3 launches); K5 on ``chip_smoke.py``'s LD panel
(16384 × 1,048,576 bits, 16 blocks; 20 launches) as the tree's own path
calls it: with the work list checked at plan time where the tree has
that, else with the wrapper's read-back. One JSON line per turn, then the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = r'''
import json, numpy as np, torch
import chip_smoke
import stormtpu_torch as st
from stormtpu_torch.kernels import _build, clustered, dense, mxu
from stormtpu_torch.layout import to_device_words
from stormtpu_torch.utils import triangular_tile_ids
_build.build_all()
dev = torch.device("cuda")
words = np.random.default_rng(0).integers(0, 1 << 32, size=(16384, 8192), dtype=np.uint32)
xp = to_device_words(words, dev)
ibs, jbs = (torch.from_numpy(x).to(dev) for x in triangular_tile_ids(64))
a = xp[:4096]

def ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps

tri = ms(lambda: mxu.count_tiles_pallas_mxu(xp, ibs, jbs, tile_rows=256, tile_words=256))
rect = ms(lambda: mxu._count_block_padded(a, xp, tile_rows=256, tile_words=256,
                                          variant="planes"))
ids128 = [torch.from_numpy(x).to(dev) for x in triangular_tile_ids(128)]
k1 = ms(lambda: dense.count_tiles_pallas_dense(xp, *ids128, tile_rows=128, tile_words=2048),
        reps=3)
del xp, a
torch.cuda.empty_cache()
ld, _, _ = chip_smoke.ld_panel(np.random.default_rng(0), chip_smoke.LD_N, chip_smoke.LD_M,
                               chip_smoke.LD_BLOCKS, chip_smoke.LD_DENSITY)
bm = st.BitMatrix.from_packed(ld, chip_smoke.LD_M)
plan = clustered.build_clustered_plan(bm)
packed = clustered.device_operand(bm, plan, dev)
work = clustered.device_worklist(plan, dev)
kw = dict(n_slots=plan.slot_ibs.size, tile_rows=plan.ti, tile_words=plan.wk)
if hasattr(clustered, "DeviceWorklist"):
    kw["checked"] = work
k5 = ms(lambda: clustered.count_tiles_worklist(packed, *work, **kw), reps=20)
print(json.dumps({"k2_tri_ms": tri, "k2_rect_ms": rect, "k1_ms": k1, "k5_ms": k5}))
'''


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": args[0], "change": args[1]}
    for name in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name],
                           capture_output=True, text=True, check=True, timeout=900)
        print(json.dumps({"tree": name, **json.loads(r.stdout.strip().splitlines()[-1])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
