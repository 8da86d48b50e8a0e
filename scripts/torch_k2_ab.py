#!/usr/bin/env python3
"""Time the port's kernels of two source trees in one run on one card, or
K2-rect's forms within this tree.

    python3 scripts/torch_k2_ab.py PARENT_DIR CHANGE_DIR
    python3 scripts/torch_k2_ab.py --rect [--reps 5]

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
that, else with the wrapper's read-back; and K2-rect at the lookups of
``c4.lookup64``'s shape, Na = 1, 16, 64 and 128 query rows against
100,000 rows of 32,768 words (a 13.1-GB panel made on the card), through
``count_block_pallas_mxu``, which both trees have whatever kernel it
launches. K2-rect's rectangle goes through ``count_block_pallas_mxu`` too.
One JSON line per turn, with a digest of each lookup's counts (the runs
must agree), then the card's name and power limit.

``--rect`` times, in this tree, K2-rect's launches on one block of the
rows ring of config 5 (256 query rows against a 250,112-row shard of
32,768 words: a 32.8-GB B operand made on the card) and on one lookup of
``c4.lookup64`` (64 against 100,000 rows of the same width): the TMA body
in clusters of two and of one (``k2_rect_tma_launch``), the ``cp.async``
body in the TMA body's order (A sub-tile fastest: a variant built here
from ``csrc/tile_body.cuh``, which the program does not have), and the
program's route (``count_block_pallas_mxu``, whose shape rule picks one
of the first two). Each form runs twice (in order, then reversed) and
must give the same counts; one JSON line a shape, each time beside the
operation bound (2·Na·Nb·M at the b1 rate, 1.583e16 bit-op/s) and the byte
bound (both operands and the output once at 3.35 TB/s), then the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # --rect: this tree

CHILD = r'''
import hashlib, json, numpy as np, torch
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
rect = ms(lambda: mxu.count_block_pallas_mxu(a, xp))
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
del ld, bm, plan, packed, work
torch.cuda.empty_cache()
# lookups of c4.lookup64's shape: na query rows (a row view) against 100,000
# rows of 32,768 words, through the card route
panel = torch.empty((100_000 + 128, 32_768), dtype=torch.int32, device=dev)
gen = torch.Generator(device=dev)
gen.manual_seed(20)
panel.random_(-(1 << 31), 1 << 31, generator=gen)
b = panel[:100_000]
lookup_ms, digest = {}, {}
for na in (1, 16, 64, 128):
    q = panel[100_000 : 100_000 + na]
    got = mxu.count_block_pallas_mxu(q, b).contiguous().cpu().numpy()
    digest[na] = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    lookup_ms[na] = ms(lambda: mxu.count_block_pallas_mxu(q, b))
print(json.dumps({"k2_tri_ms": tri, "k2_rect_ms": rect, "k1_ms": k1, "k5_ms": k5,
                  "lookup_ms": lookup_ms, "lookup_digest": digest}))
'''


# K2-rect on tile::B1Wgmma with the blocks A sub-tile fastest, as the TMA
# form lays them out: the order without the TMA body, for timing only.
A_FASTEST_CU = r'''
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_body.cuh"

using namespace tile;

namespace {

__global__ void __launch_bounds__(B1Wgmma::THREADS, B1Wgmma::MIN_BLOCKS)
    rect_a_fastest(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   int* __restrict__ out, int64_t na, int64_t nb, int64_t w, int64_t ldo,
                   int nsub_m) {
  extern __shared__ __align__(1024) uint32_t smem_dyn[];
  constexpr int BM = B1Wgmma::BM, BN = B1Wgmma::BN;
  const int64_t ra = static_cast<int64_t>(blockIdx.x % nsub_m) * BM;
  const int64_t rb = static_cast<int64_t>(blockIdx.x / nsub_m) * BN;
  const int a_rows = static_cast<int>(min(static_cast<int64_t>(BM), na - ra));
  const int b_rows = static_cast<int>(min(static_cast<int64_t>(BN), nb - rb));
  B1Wgmma::Acc acc;
  zero_frags(acc.v);
  const RowPairSource src{a + ra * w, b + rb * w, static_cast<int>(w)};
  B1Wgmma::accumulate(acc, src, a_rows, b_rows, w, smem_dyn);
  B1Wgmma::store(acc, a_rows, b_rows, out + ra * ldo + rb, ldo);
}

}  // namespace

extern "C" int rect_a_fastest_launch(const void* a, const void* b, void* out, long long na,
                                     long long nb, long long w, long long ldo, void* stream) {
  const long long nsub_m = (na + B1Wgmma::BM - 1) / B1Wgmma::BM;
  const long long nsub_n = (nb + B1Wgmma::BN - 1) / B1Wgmma::BN;
  return launch<B1Wgmma>(rect_a_fastest, dim3(static_cast<unsigned>(nsub_m * nsub_n)), stream,
                         static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
                         static_cast<int*>(out), static_cast<int64_t>(na),
                         static_cast<int64_t>(nb), static_cast<int64_t>(w),
                         static_cast<int64_t>(ldo), static_cast<int>(nsub_m));
}
'''

RING_BLOCK = (256, 250_112)      # config 5's ring block: query rows, shard rows
LOOKUP = (64, 100_000)           # c4.lookup64's request
WORDS = 32_768                   # 1,048,576 bits
PEAK_B1_OPS = 8 * 1.979e15
PEAK_BYTES_PER_S = 3.35e12


def _a_fastest_library(tmp: str):
    """Build A_FASTEST_CU against the package's csrc with the package's nvcc
    flags into ``tmp`` and load it."""
    import ctypes
    import os

    from stormtpu_torch.kernels import _build

    src, so = os.path.join(tmp, "rect_a_fastest.cu"), os.path.join(tmp, "rect_a_fastest.so")
    with open(src, "w") as f:
        f.write(A_FASTEST_CU)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so,
                    src], check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(so)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.rect_a_fastest_launch.argtypes = [vp, vp, vp, ll, ll, ll, ll, vp]
    lib.rect_a_fastest_launch.restype = ctypes.c_int
    return lib


def rect_forms(reps: int) -> int:
    """``--rect``: K2-rect's forms at the ring block's and the lookup's
    shapes, one JSON line each."""
    import tempfile

    import torch

    from stormtpu_torch.kernels import _build, mxu

    if not torch.cuda.is_available():
        print("torch_k2_ab --rect: no CUDA card; this run needs one", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    k2 = _build.library("k2_mxu")
    tmp = tempfile.TemporaryDirectory()
    fast = _a_fastest_library(tmp.name)
    b_all = torch.empty((RING_BLOCK[1], WORDS), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    b_all.random_(generator=gen)  # 31 random bits a word: what is timed reads no value

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    for na, nb in (RING_BLOCK, LOOKUP):
        a, b = b_all[:na], b_all[:nb]  # views, as the ring's x_local[b0:b0 + 256]
        ldo = nb + (-nb) % mxu.RECT_WORD_ALIGN
        stream = torch.cuda.current_stream().cuda_stream
        outs = {}

        def direct(name, entry, *extra):
            out = outs.setdefault(name, torch.empty((na, ldo), dtype=torch.int32, device=dev))

            def run():
                err = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), na, nb, WORDS, ldo,
                            *extra, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            return run

        forms = {}
        if -(-na // mxu.RECT_BLOCK_ROWS) % 2 == 0:  # sub-tile rows that pair up
            forms["tma_cluster2"] = direct("tma_cluster2", k2.k2_rect_tma_launch, 2)
        forms["tma_cluster1"] = direct("tma_cluster1", k2.k2_rect_tma_launch, 1)
        forms["cp_async_a_fastest"] = direct("cp_async_a_fastest", fast.rect_a_fastest_launch)
        forms["program_route"] = lambda: outs.__setitem__("program_route",
                                                          mxu.count_block_pallas_mxu(a, b))
        times = {k: [] for k in forms}
        for name in [*forms, *reversed(forms)]:
            times[name].append(ms(forms[name]))
        want = outs["tma_cluster1"][:, :nb]
        for name, out in outs.items():
            if not torch.equal(out[:, :nb], want):
                raise AssertionError(f"{name} differs from tma_cluster1 at {na} x {nb}")
        plain = mxu.count_block_plain(a[:2], b[:512], tile_words=1024)
        if not torch.equal(plain, want[:2, :512]):
            raise AssertionError(f"tma_cluster1 differs from the plain version at {na} x {nb}")
        ops = 2.0 * na * nb * WORDS * 32
        nbytes = 4.0 * ((na + nb) * WORDS + na * nb)
        print(json.dumps({
            "na": na, "nb": nb, "words": WORDS, "reps": reps,
            "rect_cluster": mxu.rect_cluster(na),
            "ms": {k: v for k, v in times.items()},
            "op_bound_ms": ops / PEAK_B1_OPS * 1e3,
            "byte_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        }), flush=True)
        del outs, forms, want, plain
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    tmp.cleanup()
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--rect"]:
        reps = int(args[2]) if args[1:2] == ["--reps"] and len(args) == 3 else 5
        if len(args) not in (1, 3) or (len(args) == 3 and args[1] != "--reps"):
            print(__doc__, file=sys.stderr)
            return 2
        return rect_forms(reps)
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": args[0], "change": args[1]}
    digests = set()
    for name in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name],
                           capture_output=True, text=True, check=True, timeout=900)
        line = json.loads(r.stdout.strip().splitlines()[-1])
        digests.add(json.dumps(line["lookup_digest"], sort_keys=True))
        print(json.dumps({"tree": name, **line}), flush=True)
    if len(digests) != 1:
        raise AssertionError("the trees' lookup counts differ")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
