"""The control of a cell's correctness check, at the cell's own size:

    python3 portbench/control.py --workload <name> --seeds 1,2,3

For each seed, the cell's driver puts the reference in the program's
place, computed one step below exact (``control()`` of the driver: counts
as a bfloat16 product, or the matrix held in int8), and judges its answer
as a run judges the program's. Every number it prints has to exceed its
limit, or the check could not tell a wrong answer. The benchmark's own
runs do not run this."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT)
    wl = harness.find_workload(spec, args.workload)
    config = harness.load_config(ROOT, spec, wl["config"])
    traffic = harness.load_traffic(ROOT, wl["traffic"])
    driver = harness.load_driver(ROOT, traffic["entry"])
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("[control] no CUDA card", file=sys.stderr)
        return 2
    failed_none = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(ROOT, args.workload, config, traffic, seed, device)
        t0 = time.perf_counter()
        readings = driver.control(cell)
        caught = any(v > 0 for v in readings.values())
        if not caught:
            failed_none.append(seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings,
                          "caught": caught, "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if failed_none else 0


if __name__ == "__main__":
    sys.exit(main())
