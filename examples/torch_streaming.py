"""Streaming scale on the PyTorch/CUDA port: matrices whose result — or
whose operands — exceed the card's memory (the counterpart of
``examples/streaming.py``).

Five tiers, all exact and resumable:

1. N² result too big to materialize → ``stream_count_matrix`` writes
   superblock stripes with checkpoint and resume.
2. Packed operands too big for the card → the same call streams the
   operand (two superblock slices on the card at a time; automatic past a
   device budget, forced here).
3. No matrix wanted at all → the ``stream_query`` top-k and screens reduce
   each stripe on the card and never materialize C anywhere.
4. Extreme sparsity → the per-superblock inverted index (K4) on the host.
5. Panels bigger than host memory → a memory-mapped panel on disk.

Run: python examples/torch_streaming.py [--device cpu]

Every result is held to NumPy; the last line says that all checks passed.
On the CPU the panel and the tiles are smaller (the plain PyTorch forms
stand in for the kernels there).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def topk_of(c: np.ndarray, k: int) -> np.ndarray:
    """Each row's k largest counts off the diagonal, no-partner entries 0."""
    w = c.copy()
    np.fill_diagonal(w, -1)
    return np.maximum(-np.sort(-w, axis=1)[:, :k], 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, default) or 'cpu'")
    dev = ap.parse_args(argv).device

    from stormtpu_torch import BitMatrix
    from stormtpu_torch.config import EngineConfig
    from stormtpu_torch.io import load_bitmatrix_mmap, save_bitmatrix_mmap
    from stormtpu_torch.native import have_native
    from stormtpu_torch.stream import load_streamed_matrix, stream_count_matrix
    from stormtpu_torch.stream_query import stream_pairs_above, stream_topk_neighbors

    rng = np.random.default_rng(0)
    # the machinery is shape-agnostic: N is bounded by host memory, not by
    # the card's; the demo keeps it seconds long
    if dev == "cpu":
        n, m, sb = 256, 4_096, 64
        cfg = EngineConfig(k1_tile_rows=8, k1_tile_words=128, k2_tile_rows=32, k2_tile_words=32)
    else:
        n, m, sb = 2048, 65_536, 512
        cfg = None
    dense = (rng.random((n, m)) < 0.2).astype(np.uint8)
    bm = BitMatrix.from_dense(dense)
    want = (dense.astype(np.float32) @ dense.T.astype(np.float32)).astype(np.int64)
    print(f"panel: {bm}")

    # --- tiers 1 + 2: stripes with forced operand streaming -------------
    with tempfile.TemporaryDirectory() as out_dir:
        man = stream_count_matrix(bm, out_dir, superblock_rows=sb, operand_streaming=True,
                                  config=cfg, device=dev)
        print(f"wrote {len(man['completed'])} stripes (kernel={man['kernel']}, "
              f"operand_streaming=True)")
        assert np.array_equal(load_streamed_matrix(out_dir), want)
    print("stripes exact against NumPy")

    # --- tier 3: reduced queries without materializing C anywhere -------
    vals, idx = stream_topk_neighbors(bm, k=5, superblock_rows=sb, config=cfg, device=dev)
    assert np.array_equal(vals, topk_of(want, 5))
    assert np.array_equal(want[np.arange(n)[:, None], idx], vals)
    assert all(len(set(r.tolist())) == 5 and i not in r for i, r in enumerate(idx))
    print(f"stream_topk_neighbors: row 0 partners {idx[0].tolist()} counts "
          f"{vals[0].tolist()} (exact)")
    thr = int(np.percentile(want[np.triu_indices(n, 1)], 99.9))
    ii, jj, v = stream_pairs_above(bm, thr, superblock_rows=sb, config=cfg, device=dev)
    wi, wj = np.nonzero(np.triu(want, 1) >= thr)
    assert np.array_equal(ii, wi) and np.array_equal(jj, wj) and np.array_equal(v, want[wi, wj])
    print(f"stream_pairs_above(>= {thr}): {v.size} pairs, exact")

    # long walks checkpoint: out_dir keeps each stripe's hits, and a re-run
    # (or a crashed run) resumes at the first unfinished stripe
    with tempfile.TemporaryDirectory() as ck:
        stream_pairs_above(bm, thr, superblock_rows=sb, config=cfg, out_dir=ck, device=dev)
        again = stream_pairs_above(bm, thr, superblock_rows=sb, config=cfg, out_dir=ck,
                                   device=dev)
    assert all(np.array_equal(a, b) for a, b in zip(again, (wi, wj, want[wi, wj])))
    print("checkpoint/resume round trip exact")

    # --- tier 4: extreme sparsity, the per-superblock K4 on the host ----
    if have_native():
        sparse01 = (rng.random((n, m)) < 0.002).astype(np.uint8)
        ws = (sparse01.astype(np.float32) @ sparse01.T.astype(np.float32)).astype(np.int64)
        vals_s, _ = stream_topk_neighbors(BitMatrix.from_dense(sparse01), k=3,
                                          superblock_rows=sb, kernel="sparse_outer",
                                          config=cfg, device=dev)
        assert np.array_equal(vals_s, topk_of(ws, 3))
        print("sparse_outer stripe top-k exact (K4 on the host)")

    # --- tier 5: panels bigger than host memory stream from disk --------
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "panel.npy")
        save_bitmatrix_mmap(bm, p)        # uncompressed .npy + .json sidecar
        bm_disk = load_bitmatrix_mmap(p)  # a view of the file
        assert not bm_disk.packed.flags.owndata
        vals_d, _ = stream_topk_neighbors(bm_disk, k=5, superblock_rows=sb, config=cfg,
                                          device=dev)
        assert np.array_equal(vals_d, vals)
    print("disk-resident (memmap) panel: streaming top-k identical")
    print("torch_streaming: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
