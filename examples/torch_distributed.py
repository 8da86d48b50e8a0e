"""Distributed all-pairs over a row-sharded mesh on the PyTorch/CUDA port
(the counterpart of ``examples/distributed.py``).

``stormtpu_torch.parallel`` runs one process a device over a
``torch.distributed`` group: every rank calls the same ``distributed_*``
function with the same host arrays, computes its shard, joins the
collectives and returns the whole result. This script spawns such a group
with ``parallel.dryrun.run_group``: ``--ranks`` gloo ranks on the CPU
(``--device cpu``), or one NCCL rank on the card. Under ``torchrun`` the
same calls run a card a rank (``make_row_mesh()`` joins that group).

Run: python examples/torch_distributed.py [--device cpu] [--ranks 4]

Every rank's results are held to NumPy; the last line says that all checks
passed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

N, M, K = 128, 8192, 5


def panel() -> np.ndarray:
    rng = np.random.default_rng(7)
    dense = (rng.random((N, M)) < 0.2).astype(np.uint8)
    dense[100] = dense[3]  # a perfectly correlated pair for the LD screen
    return dense


def rank_main(device: str) -> dict:
    """One rank's calls; every rank returns the whole results."""
    from stormtpu_torch import BitMatrix, clump_from_pairs
    from stormtpu_torch.parallel import (
        distributed_column_counts,
        distributed_count_matrix,
        distributed_pairs_above,
        distributed_similarity_matrix,
        distributed_topk_neighbors,
        make_row_mesh,
    )

    bm = BitMatrix.from_dense(panel())
    mesh = make_row_mesh(device=device)  # every rank of the group
    out = {"mesh": dict(mesh.shape), "backend": mesh.backend}
    out["counts"] = distributed_count_matrix(bm.packed, mesh=mesh)
    # at N where C cannot materialize, the reduced queries on the same mesh
    out["topk"] = distributed_topk_neighbors(bm, K, mesh=mesh)
    ii, jj, r2 = distributed_pairs_above(bm, 0.9, measure="r2", mesh=mesh)
    out["screen"] = (ii, jj, r2)
    # the mesh screen's pair list feeds the single-device clumping pass
    out["leader"] = clump_from_pairs(ii, jj, stat=np.arange(bm.n)[::-1], n=bm.n).leader
    out["columns"] = distributed_column_counts(bm, mesh=mesh)
    out["jaccard"] = distributed_similarity_matrix(bm, "jaccard", mesh=mesh)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, default) or 'cpu'")
    ap.add_argument("--ranks", type=int, default=4, help="gloo ranks on the CPU (default 4)")
    args = ap.parse_args(argv)

    from stormtpu_torch.parallel.dryrun import run_group

    world, backend = (args.ranks, "gloo") if args.device == "cpu" else (1, "nccl")
    results = run_group(world, backend, args.device, rank_main, timeout=300)

    dense = panel()
    c = (dense.astype(np.float32) @ dense.T.astype(np.float32)).astype(np.int64)
    nnz = np.diag(c).astype(np.float64)
    cm = c.copy()
    np.fill_diagonal(cm, -1)
    m = float(M)
    num = m * c - nnz[:, None] * nnz[None, :]
    den = np.sqrt(nnz[:, None] * nnz[None, :] * (m - nnz[:, None]) * (m - nnz[None, :]))
    r2 = np.where(den * den > 0, (num * num) / np.where(den > 0, den * den, 1.0), 0.0)
    wi, wj = np.nonzero(np.triu(r2, 1) >= 0.9)
    jac = c / (nnz[:, None] + nnz[None, :] - c)
    for rank, out in enumerate(results):
        assert np.array_equal(out["counts"], c), rank
        vals, idx = out["topk"]
        assert np.array_equal(vals, -np.sort(-cm, axis=1)[:, :K]), rank
        assert np.array_equal(c[np.arange(N)[:, None], idx], vals), rank
        assert all(len(set(r.tolist())) == K and i not in r for i, r in enumerate(idx)), rank
        ii, jj, v = out["screen"]
        assert np.array_equal(ii, wi) and np.array_equal(jj, wj), rank
        assert np.array_equal(v, r2[wi, wj]) and (3, 100) in set(zip(ii.tolist(), jj.tolist()))
        assert out["leader"][100] == 3, rank  # the duplicate joins row 3's clump
        assert np.array_equal(out["columns"], dense.sum(axis=0)), rank
        assert np.array_equal(out["jaccard"], jac) and out["jaccard"][3, 100] == 1.0, rank
    print(f"mesh {results[0]['mesh']} over {world} {results[0]['backend']} rank(s)")
    print(f"distributed counts exact ({N} x {N}, sum {c.sum()})")
    print(f"top-{K} neighbours exact, every partner set valid")
    print(f"r² ≥ 0.9 screen exact ({wi.size} pair(s), the planted duplicate among them); "
          f"clumped; column counts and Jaccard matrix exact")
    print("torch_distributed: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
