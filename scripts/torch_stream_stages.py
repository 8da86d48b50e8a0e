#!/usr/bin/env python3
"""Wall time of ``stream_count_matrix`` on one NVIDIA card with its stripe
files written in order, by one background thread and by the walk's own
number of them, in turns inside one process.

    python3 scripts/torch_stream_stages.py [--rows 16384] [--bits 1048576]
                                           [--superblock 4096] [--seed 0]

For the operand resident on the card and for operand streaming, with
``compress`` off, and (on the first ``--compress-rows`` rows) on. "In
order" waits for each stripe's file before the walk goes on, which is what
the walk did before it had writer threads. Every directory is loaded back
and compared with the first one's matrix. Prints one line a configuration
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--bits", type=int, default=1 << 20)
    ap.add_argument("--superblock", type=int, default=4096)
    ap.add_argument("--compress-rows", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_stream_stages: no CUDA card; this run needs one", file=sys.stderr)
        return 1
    import stormtpu_torch as st
    from stormtpu_torch import stream

    rng = np.random.default_rng(args.seed)
    words = rng.integers(0, 1 << 32, size=(args.rows, args.bits // 32), dtype=np.uint32)
    bm = st.BitMatrix.from_packed(words, args.bits)
    head = st.BitMatrix.from_packed(words[: args.compress_rows], args.bits)
    real_save = stream._StripeWriter.save

    def in_order_save(self, path, **members):
        real_save(self, path, **members)
        while self.pending:
            self._complete_oldest()

    def walk(matrix, writers, streaming, compress):
        """Seconds of one walk into a fresh directory, and its matrix."""
        stream._StripeWriter.save = in_order_save if writers == 0 else real_save
        stream._WRITERS = max(1, writers)
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            man = stream.stream_count_matrix(
                matrix, out, superblock_rows=args.superblock, kernel="mxu",
                compress=compress, operand_streaming=streaming)
            seconds = time.perf_counter() - t0
            return seconds, len(man["completed"]), stream.load_streamed_matrix(out)

    default_writers = stream._WRITERS
    try:
        walk(bm, default_writers, False, False)  # builds the kernels, uploads the operand
        for matrix, compress, label in ((bm, False, f"{args.rows} rows, compress off"),
                                        (head, True, f"{args.compress_rows} rows, compress on")):
            reference = None
            for streaming in (False, True):
                order = (0, 1, default_writers)
                for writers in order + order[::-1]:
                    seconds, stripes, full = walk(matrix, writers, streaming, compress)
                    if reference is None:
                        reference = full
                    elif not np.array_equal(full, reference):
                        raise AssertionError("a walk's matrix differs from the first one's")
                    how = "in order" if writers == 0 else f"{writers} writer thread(s)"
                    print(f"[stream] {label}, operand "
                          f"{'streaming' if streaming else 'resident'}, {how}: {stripes} stripes "
                          f"in {seconds:.3f} s = {seconds / stripes:.4f} s a stripe")
    finally:
        stream._StripeWriter.save = real_save
        stream._WRITERS = default_writers
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
