#!/usr/bin/env python3
"""Measure the K4 cost-model constants of ``stormtpu_torch/tuning.py`` on one
NVIDIA card and its host, without a full tune.

    python3 scripts/torch_k4_constants.py [--seed 7] [--out FILE]

``tuning.refit_k4_constants`` measures the constants of K4's route on the
card (its kernels, ``kernels/csrc/k4_sparse.cu``: the sort, the N² output,
a stripe's N² kept on the card, the emission), the host's emission rate,
the N² download, K2's host work on its operand and the upload, as its
docstring defines them;
``dispatch_floor_s`` is a warm K2 call at 256 × 2²⁰ bits, as ``tuning.tune``
takes it. ``tune`` also sets ``k2_int8_ops_per_s`` from its best
``pallas_mxu`` bucket, which this script does not measure. Prints one JSON
object with the constants and the card's name and power limit (and writes
it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_k4_constants: no CUDA card; this run needs one", file=sys.stderr)
        return 1
    from stormtpu_torch import native, tuning

    if not native.have_native():
        raise RuntimeError(f"the C++ host tier did not build: {native.native_build_error()}")
    dev = torch.device("cuda")
    fit = tuning.refit_k4_constants(lambda msg: print(msg, file=sys.stderr), device=dev,
                                    seed=args.seed)
    fit["dispatch_floor_s"] = tuning._dispatch_floor(dev, 256, 1 << 20)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    line = json.dumps({"constants": fit, "card": smi.stdout.strip().splitlines()[0],
                       "host_cpus": os.cpu_count()})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
