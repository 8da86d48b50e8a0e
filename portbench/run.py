"""Run one cell of the benchmark of stormtpu_torch once, on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress and the compared numbers on
standard error, and the result as one JSON line, the last of standard
output. Exits non-zero, printing no result, without a CUDA card (or
fewer than the cell asks for), when the checkout lacks the program, or
when the process has imported jax, jaxlib, flax or stormtpu."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "portbench" / "out"


def _prepare_path_and_caches() -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    # build and kernel caches at fixed paths inside the checkout, so that
    # only a checkout's first run builds
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(OUT / "cache" / sub)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_path_and_caches()

    import torch

    from portbench import harness, roofline

    spec = harness.load_spec(ROOT)
    chips = harness.find_workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import stormtpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[portbench] the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    log(f"[portbench]   imports: {time.perf_counter() - T_START:.3f} s")
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"[portbench] the process imported {', '.join(bad)}: no result")
        return 3
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                     **out["device"]}
    log(f"[portbench] card: {_card_line()}; peaks: b1 {roofline.PEAK_B1_OPS:.4g} op/s, "
        f"HBM {roofline.PEAK_HBM_BYTES:.4g} B/s ({roofline.PEAKS['source']})")
    compared = out.pop("compared")
    out["compared"] = compared
    for name, c in compared.items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
