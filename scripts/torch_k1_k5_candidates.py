#!/usr/bin/env python3
"""Time K1 and K5 of the port beside their alternatives, in one process on
one card, in turns (each list forwards, then backwards).

    python3 scripts/torch_k1_k5_candidates.py [--seed 0]

K1, at 16384 x 262144 bits (T = 8256 tiles of 128 x 128): the kernel the
wrapper launches, on the i-major tile list and on the same tiles ordered
in bands (does the tile order matter?), the straight route through K2's
triangular kernel at TI = 128 (half of each block's B rows zero-filled),
and K2 itself at TI = 256 on the same rows. Each result is compared with
K2's, exactly.

K5, on the LD panel of ``chip_smoke.py`` (16384 x 1,048,576 bits, 16
blocks): the launch alone (CUDA events around the C entry, the counter
zeroed before each launch as the wrapper does) with the units in slot
order and longest first, each compared exactly with the wrapper's result;
then the wrapper with bare tensors (it reads the list back) and with the
checked work list of ``device_worklist``, by CUDA events and by the host
clock around the un-synchronised call; and ``device_worklist`` itself.

While a PR weighs further candidates, their C entries are added to the
lists here and leave with the losers; PERF.md keeps their times.

One line per measurement; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    import stormtpu_torch as st
    from stormtpu_torch.kernels import _build, clustered, dense, mxu
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.utils import triangular_tile_ids

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    _build.build_all()
    for name in _build.KERNEL_SOURCES:
        for symbol, used in _build.kernel_resources(name).items():
            print(f"[build] {name}: {symbol}: {used['registers']} registers, "
                  f"{used['spill_bytes']} spill bytes")
        for line in _build._target(name).with_suffix(".log").read_text().splitlines():
            if "warning" in line.lower() or "wgmma" in line.lower():
                print(f"[build] {name}: {line}")
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def in_turns(label, cands, reps):
        names = list(cands)
        for turn, name in enumerate(names + names[::-1]):
            print(f"[{label}] turn {turn} {name}: {ms(cands[name], reps):.4f} ms", flush=True)

    # ------------------------------------------------------------------ K1
    words = rng.integers(0, 1 << 32, size=(16384, 8192), dtype=np.uint32)
    xp = to_device_words(words, dev)
    ids128 = [torch.from_numpy(x).to(dev) for x in triangular_tile_ids(128)]
    ids256 = [torch.from_numpy(x).to(dev) for x in triangular_tile_ids(64)]
    # the same tiles in bands of 8 row blocks, the tiles of a band by pairs of
    # column blocks: blocks that run together then share B rows as well as A rows
    band = np.lexsort((ids128[1].cpu().numpy(), ids128[0].cpu().numpy(),
                       ids128[1].cpu().numpy() // 2, ids128[0].cpu().numpy() // 8))
    banded128 = [x[torch.from_numpy(band).to(dev)].contiguous() for x in ids128]
    k1_cands = {
        "k1 wrapper (kernel launched)": lambda: dense.count_tiles_pallas_dense(
            xp, *ids128, tile_rows=128, tile_words=2048),
        "k1 wrapper, tile list in bands of 8 row blocks": lambda: dense.count_tiles_pallas_dense(
            xp, *banded128, tile_rows=128, tile_words=2048),
        "k2_tri at TI=128 (straight route)": lambda: mxu.count_tiles_pallas_mxu(
            xp, *ids128, tile_rows=128, tile_words=256),
        "k2_tri at TI=256": lambda: mxu.count_tiles_pallas_mxu(
            xp, *ids256, tile_rows=256, tile_words=256),
    }
    want = mxu.count_tiles_pallas_mxu(xp, *ids128, tile_rows=128, tile_words=256)
    for name, fn in k1_cands.items():
        if "256" not in name and "bands" not in name:
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from K2 at TI=128")
    del got, want
    print("[k1] every candidate equals K2's tiles at TI=128, exactly")
    in_turns("k1", k1_cands, reps=5)
    del xp, words
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ K5
    ld_words, _, _ = chip_smoke.ld_panel(rng, chip_smoke.LD_N, chip_smoke.LD_M,
                                         chip_smoke.LD_BLOCKS, chip_smoke.LD_DENSITY)
    bm = st.BitMatrix.from_packed(ld_words, chip_smoke.LD_M)
    plan = clustered.build_clustered_plan(bm)
    packed = clustered.device_operand(bm, plan, dev)
    work = clustered.device_worklist(plan, dev)
    n_slots = plan.slot_ibs.size
    kw = dict(n_slots=n_slots, tile_rows=plan.ti, tile_words=plan.wk)
    items = np.diff(work.starts)
    print(f"[k5] {plan.n_work} items in {n_slots} slots: items a slot min {items.min()} "
          f"median {np.median(items):.0f} max {items.max()}; histogram "
          f"{np.bincount(items).tolist()}")
    k2 = _build.library("k2_mxu")
    n_sub = k2.k2_sub_tiles(plan.ti)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_item = -(-plan.wk // 32)
    print(f"[k5] {n_slots * n_sub} units of {n_sub} sub-tiles a slot; {items.sum() * n_sub * per_item} "
          f"chunks of 32 words in all, {items.sum() * n_sub * per_item / sms:.1f} an SM on {sms} "
          f"SMs; the longest unit has {items.max() * per_item}")
    want = clustered.count_tiles_worklist(packed, *work, checked=work, **kw)
    out5 = torch.empty_like(want)
    longest_first = clustered.schedule_units(work.starts, n_sub)
    schedules = {
        "units in slot order": longest_first[np.argsort(longest_first[:, 2], kind="stable")],
        "units longest first": longest_first,
    }
    k5_cands = {}
    for name, units in schedules.items():
        u = torch.from_numpy(np.ascontiguousarray(units)).to(dev)

        def run(u=u):
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            err = k2.k5_launch(
                packed.data_ptr(), *(t.data_ptr() for t in work.tensors[:3]), u.data_ptr(),
                counter.data_ptr(), out5.data_ptr(), u.shape[0], min(sms, u.shape[0]),
                plan.ti, plan.wk, packed.shape[1], stream)
            if err:
                raise RuntimeError(f"k5_launch: CUDA error {err}")

        out5.fill_(-1)
        run()
        torch.cuda.synchronize()
        if not torch.equal(out5, want):
            raise AssertionError(f"k5 with {name} differs from the wrapper's result")
        k5_cands[name] = run
    print("[k5] every schedule gives the wrapper's tiles, exactly")
    in_turns("k5 launch alone", k5_cands, reps=50)
    in_turns("k5 launch alone", k5_cands, reps=50)

    wrappers = {
        "wrapper, bare tensors (read-back)": lambda: clustered.count_tiles_worklist(
            packed, *work, **kw),
        "wrapper, checked work list": lambda: clustered.count_tiles_worklist(
            packed, *work, checked=work, **kw),
    }
    in_turns("k5 wrapper, events", wrappers, reps=50)
    for name, fn in wrappers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host = (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        print(f"[k5 wrapper, host clock, call not synchronised] {name}: {host * 1e3:.4f} ms")
    t0 = time.perf_counter()
    for _ in range(20):
        clustered.device_worklist(plan, dev)
    torch.cuda.synchronize()
    print(f"[k5] device_worklist (host check, schedule, uploads): "
          f"{(time.perf_counter() - t0) / 20 * 1e3:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
