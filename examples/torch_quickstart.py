"""Quickstart for the PyTorch/CUDA port: build bitmaps, count pairwise
intersections (the counterpart of ``examples/quickstart.py``).

Run: python examples/torch_quickstart.py [--device cpu]

Every result is held to NumPy; the last line says that all checks passed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, default) or 'cpu'")
    dev = ap.parse_args(argv).device

    from stormtpu_torch import BitMatrix, intersect_count_matrix, pair_count
    from stormtpu_torch.dispatch import choose_strategy

    # --- build from dense 0/1 rows (variants × samples, say) -------------
    rng = np.random.default_rng(0)
    n, m = 100, 4096
    dense = (rng.random((n, m)) < 0.1).astype(np.uint8)
    bm = BitMatrix.from_dense(dense)
    print(f"built {bm}")
    want = dense.astype(np.int64) @ dense.T.astype(np.int64)

    # --- full N×N intersection-count matrix (D1 picks the kernel) --------
    strategy = choose_strategy(bm.n, bm.m_bits, bm.density, bm=bm, device=dev)
    counts = intersect_count_matrix(bm, device=dev)
    assert counts.dtype == np.int32 and np.array_equal(counts, want)
    print(f"count matrix {counts.shape} {counts.dtype} by {strategy!r}; C[0,1] = {counts[0, 1]}")

    # --- single pair ------------------------------------------------------
    p = pair_count(dense[0], dense[1], device=dev)
    assert p == int((dense[0] & dense[1]).sum())
    print("pair |x0 ∩ x1| =", p)

    # --- build from scattered set-bit positions (sparse ingest) ----------
    lists = [rng.choice(m, size=50, replace=False) for _ in range(10)]
    bm_sparse = BitMatrix.from_position_lists(lists, m_bits=m)
    c2 = intersect_count_matrix(bm_sparse, strategy="sparse", device=dev)
    sets = [set(x.tolist()) for x in lists]
    assert np.array_equal(c2, [[len(a & b) for b in sets] for a in sets])
    print("sparse-path counts diag:", np.diag(c2)[:5], "(= row cardinalities)")

    # --- exactness: every strategy returns identical integer counts -----
    for s in ("popcount", "mxu", "pallas_mxu", "pallas_dense", "sparse", "clustered"):
        assert np.array_equal(intersect_count_matrix(bm, strategy=s, device=dev), want), s
    print("all strategies bit-exact")
    print("torch_quickstart: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
