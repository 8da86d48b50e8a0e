"""Block-clustered (LD-panel) inputs on the PyTorch/CUDA port: the K5
summary-AND skip (the counterpart of ``examples/clustered.py``).

Each row cluster touches only its own bit stripe, so most (tile pair,
K-group) products are zero. D1 reads the block-occupancy summary; when
tile-pair co-occupancy is low it names ``"clustered"``, and K5 runs K2's
tile body over the co-occupied (tile pair, K-group) items only.

Run: python examples/torch_clustered.py [--device cpu]

Every result is held to NumPy; the last line says that all checks passed.
On the CPU the panel is smaller (the plain PyTorch forms stand in for the
kernels there).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, default) or 'cpu'")
    dev = ap.parse_args(argv).device

    from stormtpu_torch import BitMatrix, intersect_count_matrix, pairs_above
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.kernels import launch_counts, reset_launches
    from stormtpu_torch.kernels.clustered import clustered_work_fraction
    from stormtpu_torch.stream import load_streamed_matrix, stream_count_matrix

    # --- a block-diagonal genotype panel: B LD blocks, each row cluster
    # only touches its own bit stripe; every bit column is occupied by SOME
    # row, so a global empty-column compaction cannot help ---------------
    rng = np.random.default_rng(0)
    n, m, blocks, sb = (1024, 262_144, 8, 512) if dev != "cpu" else (512, 16_384, 4, 128)
    dense = np.zeros((n, m), dtype=np.uint8)
    want = np.zeros((n, n), dtype=np.int64)
    for b in range(blocks):
        r, c = slice(b * (n // blocks), (b + 1) * (n // blocks)), slice(b * (m // blocks),
                                                                          (b + 1) * (m // blocks))
        dense[r, c] = rng.random((n // blocks, m // blocks)) < 0.3
        # float32 products are exact below 2^24
        part = dense[r, c].astype(np.float32)
        want[r, r] = (part @ part.T).astype(np.int64)
    bm = BitMatrix.from_dense(dense)
    print(f"built {bm}; global column occupancy {bm.packed.any(axis=0).mean():.0%}")

    # --- dispatch sees the structure through the block summary ----------
    wf = clustered_work_fraction(bm)
    strategy = choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm, device=dev)
    print(f"co-occupied work fraction {wf:.1%} -> strategy {strategy!r}")

    # --- counts and screens ride the skip automatically -----------------
    reset_launches()
    counts = intersect_count_matrix(bm, device=dev)
    assert np.array_equal(counts, want)
    k5 = launch_counts()["k5"]
    assert (k5 >= 1) == (strategy == "clustered" and dev != "cpu"), (strategy, k5)
    print(f"count matrix {counts.shape}, exact; cross-block C[0, {n - 1}] = "
          f"{counts[0, n - 1]}; K5 launches {k5}")

    thr = int(np.percentile(want[np.triu_indices(n, 1)], 99.9))
    ii, jj, vv = pairs_above(bm, thr, device=dev)
    wi, wj = np.nonzero(np.triu(want, 1) >= thr)
    assert wi.size and np.array_equal(ii, wi) and np.array_equal(jj, wj)
    assert np.array_equal(vv, want[wi, wj])
    print(f"screen: {ii.size} high-overlap pairs (exact)")

    # --- the same skip at streaming scale: kernel="auto" reroutes to
    # per-stripe work lists; summary-zero stripes never touch the device --
    with tempfile.TemporaryDirectory() as out:
        man = stream_count_matrix(bm, out, superblock_rows=sb, kernel="auto", device=dev)
        size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        print(f"streamed via {man['kernel']!r}: {len(man['completed'])} stripes, "
              f"{size / 1e6:.1f} MB on disk")
        assert np.array_equal(load_streamed_matrix(out), want)
    print("streamed result identical to the in-memory path")
    print("torch_clustered: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
