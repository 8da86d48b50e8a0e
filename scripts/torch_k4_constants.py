#!/usr/bin/env python3
"""Measure the K4 cost-model constants of ``stormtpu_torch/tuning.py`` on one
NVIDIA card and its host.

    python3 scripts/torch_k4_constants.py [--seed 7] [--out FILE]

- ``c_sort_s_per_nnz``: the port's sort-based unique (``unique_int64``) of
  4M random int64 keys (least of 3), a key; ``np.unique``'s time on the same
  keys is printed beside it;
- ``c_n2_s_per_elem``: K4's N² int32 buffer at config 3's n = 10,000 (a
  fresh ``np.zeros`` and ``stpu_mirror_upper`` over it, which touches every
  page), least of 3, an entry;
- ``c_emit_s_per_emission``: an end-to-end K4 run
  (``count_matrix_sparse_outer``: the COO cache, the C++ run walk) at
  10,000 × 2²⁰ bits, density 1e-3, least of 2: its remainder after the sort
  and N² terms over its emissions, counted exactly (Σ occ·(occ+1)/2);
- ``k2_int8_ops_per_s``: n²·M over the K2 triangular kernel's time (CUDA
  events, 5 launches) at BASELINE config 3, 10,000 × 1,048,576 bits, so
  that D1's ``n²·M / rate`` reproduces the measured kernel there;
- ``dispatch_floor_s``: the least wall time of 5 warm
  ``intersect_count_matrix(strategy="pallas_mxu")`` calls at 256 × 2²⁰
  bits, where the kernel does almost nothing;
- ``h2d_bytes_per_s``: a superblock slice of 4096 × 32,768 words (512 MiB)
  through the streamed walk's ``_SliceBuffer`` (the host's copy into the
  pinned buffer and the upload), least of 4, alternating the superblocks.

Prints one JSON object with the constants, the probes they came from and
the card's name and power limit (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def least(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_k4_constants: no CUDA card; this run needs one", file=sys.stderr)
        return 1
    import stormtpu_torch as st
    from stormtpu_torch import native, stream
    from stormtpu_torch.kernels import mxu
    from stormtpu_torch.kernels.sparse import count_matrix_sparse_outer, unique_int64
    from stormtpu_torch.utils import round_up, triangular_tile_ids

    if not native.have_native():
        raise RuntimeError(f"the C++ host tier did not build: {native.native_build_error()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # ------------------------------------------------------------ the host
    keys = rng.integers(0, 2**62, 4_000_000, dtype=np.int64)
    c_sort = least(lambda: unique_int64(keys), 3) / keys.size
    np_unique_s = least(lambda: np.unique(keys), 1)

    n = 10_000

    def n2_buffer():
        buf = np.zeros((n, n), dtype=np.int32)
        native.mirror_upper_native(buf)

    c_n2 = least(n2_buffer, 3) / (n * n)

    m = 1 << 20
    k = int(n * m * 1e-3)
    bm = st.BitMatrix.from_positions(rng.integers(0, n, k), rng.integers(0, m, k), n, m)
    _, occ = unique_int64(unique_int64(bm.coo[1] * n + bm.coo[0]) // n, presorted=True,
                          return_counts=True)
    emissions = int((occ.astype(np.int64) * (occ + 1) // 2).sum())
    k4_s = least(lambda: count_matrix_sparse_outer(bm), 2)
    c_emit = max(k4_s - c_sort * bm.nnz - c_n2 * n * n, 0.0) / emissions
    del bm

    # ------------------------------------------------------------ the card
    n3, m3 = 10_000, 1 << 20
    cfg = st.default_config()
    ti, wk = mxu.k2_tile_shape(cfg, n3, m3 // 32)
    n_pad, w_pad = round_up(n3, ti), round_up(m3 // 32, wk)
    xp = torch.zeros((n_pad, w_pad), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    xp[:n3] = torch.randint(-(1 << 31), 1 << 31, (n3, w_pad), dtype=torch.int32, device=dev,
                            generator=gen)
    ibs, jbs = triangular_tile_ids(n_pad // ti)
    ids = mxu.device_tile_ids(ibs, jbs, n_pad // ti, dev)

    def k2():
        return mxu.count_tiles_pallas_mxu(xp, *ids, tile_rows=ti, tile_words=wk, checked=ids)

    k2()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        k2()
    stop.record()
    torch.cuda.synchronize()
    k2_s = start.elapsed_time(stop) / 5 / 1e3
    k2_rate = n3 * n3 * m3 / k2_s
    del xp, ids
    torch.cuda.empty_cache()

    small = st.BitMatrix.from_packed(
        rng.integers(0, 1 << 32, size=(256, (1 << 20) // 32), dtype=np.uint32), 1 << 20)

    def dense_call():
        st.intersect_count_matrix(small, strategy="pallas_mxu", device=dev)
        torch.cuda.synchronize()

    dense_call()
    floor = least(dense_call, 5)

    sb, w_slice = 4096, (1 << 20) // 32
    words = rng.integers(0, 1 << 32, size=(3 * sb, w_slice), dtype=np.uint32)
    slices = stream._SliceBuffer(st.BitMatrix.from_packed(words, 1 << 20), sb, w_slice, dev)
    turn = iter([1, 2, 1, 2, 1, 2])

    def upload():
        slices.load(1, next(turn))
        torch.cuda.synchronize()

    upload()
    slice_bytes = sb * w_slice * 4
    h2d = slice_bytes / least(upload, 4)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    result = {
        "constants": {
            "c_sort_s_per_nnz": c_sort,
            "c_n2_s_per_elem": c_n2,
            "c_emit_s_per_emission": c_emit,
            "k2_int8_ops_per_s": k2_rate,
            "dispatch_floor_s": floor,
            "h2d_bytes_per_s": h2d,
        },
        "probes": {
            "sort_keys": keys.size,
            "np_unique_s_per_key": np_unique_s / keys.size,
            "numpy": np.__version__,
            "n2_buffer_n": n,
            "k4": {"n": n, "m_bits": m, "density": 1e-3, "nnz": k, "emissions": emissions,
                   "seconds": k4_s},
            "k2_tri_config3": {"n": n3, "m_bits": m3, "n_pad": n_pad, "w_pad": w_pad,
                               "tiles": int(ibs.size), "ms": k2_s * 1e3},
            "floor_shape": [256, 1 << 20],
            "slice_bytes": slice_bytes,
        },
        "card": smi.stdout.strip().splitlines()[0],
        "host_cpus": os.cpu_count(),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
