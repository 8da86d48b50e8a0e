"""Command line of the port (port of ``stormtpu/cli.py``).

  python -m stormtpu_torch info
  python -m stormtpu_torch count --in positions.npz --out counts.npy
  python -m stormtpu_torch --device cpu sweep --n 256 --m 8192

Every command runs on the card unless ``--device cpu`` is given; without a
card it exits non-zero (no command falls back to the CPU). ``sweep``
checks every timed strategy against the NumPy oracle before it prints its
row. The file readers take a PLINK ``.bed`` (with its ``.fam`` / ``.bim``),
an ``io.save_bitmatrix`` ``.npz``, a COO ``.npz`` (``row_ids``,
``positions``, ``n``, ``m_bits``) or a dense 0/1 ``.npy``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

_MEASURES = ("count", "jaccard", "dice", "cosine", "overlap", "phi", "r2")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_line() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cmd_info(args: argparse.Namespace) -> int:
    import torch

    from stormtpu_torch import native, tuning
    from stormtpu_torch.kernels import _build

    dev = args.dev
    print("stormtpu_torch (PyTorch/CUDA port of stormtpu)")
    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; device {dev}")
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}; nvidia-smi name, power.limit: "
              f"{_card_line()}")
    print(f"C++ host tier: {'built' if native.have_native() else 'not built'}")
    built = [n for n in _build.KERNEL_SOURCES if _build._target(n).exists()]
    print(f"CUDA kernels: {len(built)} of {len(_build.KERNEL_SOURCES)} built "
          f"({', '.join(built) or 'none'}; nvcc builds the rest at first use)")
    t = tuning.load_tuning()
    matches = tuning._device_tuning(dev) is not None
    print(f"tuning cache: {tuning.cache_path()} (snapshot {tuning._SNAPSHOT_CACHE}); "
          f"device {t.get('device') if isinstance(t, dict) else None!r}; "
          f"{'matches' if matches else 'does not match'} {tuning.device_name(dev)!r}")
    return 0


def cmd_sweep(args: argparse.Namespace) -> int:
    from stormtpu_torch import BitMatrix, intersect_count_matrix
    from stormtpu_torch.dispatch import STRATEGIES, choose_strategy
    from stormtpu_torch.oracle import oracle_count_matrix

    dev = args.dev
    densities = [float(d) for d in args.densities.split(",")]
    strategies = args.strategies.split(",") if args.strategies else list(STRATEGIES)
    rng = np.random.default_rng(args.seed)
    pairs = args.n * args.n
    print(f"{'density':>9} {'strategy':>14} {'ms/run':>10} {'M-pairs/s':>11} "
          f"{'vs oracle':>9}  {'auto':>5}")
    for d in densities:
        dense = (rng.random((args.n, args.m)) < d).astype(np.uint8)
        bm = BitMatrix.from_dense(dense)
        want = oracle_count_matrix(bm.packed)
        auto = choose_strategy(bm.n, bm.m_bits, bm.density, device=dev)
        for strat in strategies:
            got = intersect_count_matrix(bm, strategy=strat, device=dev)
            if not np.array_equal(got, want):
                print(f"{d:9.4f} {strat:>14}  *** MISMATCH vs oracle ***")
                return 1
            t0 = time.perf_counter()
            for _ in range(args.reps):
                intersect_count_matrix(bm, strategy=strat, device=dev)
            dt = (time.perf_counter() - t0) / args.reps
            mark = "<-" if strat == auto else ""
            print(f"{d:9.4f} {strat:>14} {dt * 1e3:10.2f} "
                  f"{pairs / dt / 1e6:11.2f} {'exact':>9}  {mark:>5}")
    return 0


def cmd_scaling(args: argparse.Namespace) -> int:
    import json

    from stormtpu_torch.parallel.scaling import measure_scaling

    out = measure_scaling(n=args.n, m_bits=args.m, reps=args.reps, log=_log, device=args.dev)
    print(json.dumps(out, indent=2, default=float))
    return 0


def cmd_tune(args: argparse.Namespace) -> int:
    from stormtpu_torch.tuning import tune

    if (args.n is None) != (args.m is None):
        print("tune: pass BOTH --n and --m for a single-shape probe "
              "(neither = full grid)", file=sys.stderr)
        return 2
    tune(n=args.n, m_bits=args.m, reps=args.reps, log=_log, device=args.dev)
    return 0


def cmd_accept(args: argparse.Namespace) -> int:
    from stormtpu_torch.acceptance import run_acceptance

    run_acceptance(args.config, full=args.full, log=_log, out_path=args.out, device=args.dev)
    return 0


def _load_matrix(infile: str):
    import zipfile

    from stormtpu_torch import BitMatrix

    if infile.endswith(".bed"):  # PLINK1 trio (dims from .fam/.bim)
        from stormtpu_torch.io import load_plink_bed

        return load_plink_bed(infile)
    if infile.endswith(".npz"):
        # the member list, without decompressing anything
        with zipfile.ZipFile(infile) as zf:
            is_bitmatrix = "packed.npy" in zf.namelist()
        if is_bitmatrix:  # io.save_bitmatrix format
            from stormtpu_torch.io import load_bitmatrix

            return load_bitmatrix(infile)
        with np.load(infile) as z:
            return BitMatrix.from_positions(
                z["row_ids"], z["positions"], int(z["n"]), int(z["m_bits"])
            )
    return BitMatrix.from_dense(np.load(infile))


def cmd_count(args: argparse.Namespace) -> int:
    from stormtpu_torch import intersect_count_matrix
    from stormtpu_torch.setops import pairwise_cardinality

    bm = _load_matrix(args.infile)
    _log(f"loaded {bm}")
    if args.op == "intersect":
        out = intersect_count_matrix(bm, strategy=args.strategy, device=args.dev)
    else:
        out = pairwise_cardinality(bm, args.op, strategy=args.strategy, device=args.dev)
    np.save(args.out, out)
    _log(f"wrote {args.out} shape={out.shape} dtype={out.dtype}")
    return 0


def cmd_stream(args: argparse.Namespace) -> int:
    from stormtpu_torch.stream import extend_streamed_matrix, stream_count_matrix

    bm = _load_matrix(args.infile)
    _log(f"loaded {bm}")
    if args.extend:
        man = extend_streamed_matrix(
            bm, args.out_dir, kernel=args.kernel, compress=not args.no_compress,
            progress=lambda d, t: _log(f"stripe {d}/{t}"), device=args.dev,
        )
        _log(f"extended {args.out_dir} to n={man['n']} "
             f"({len(man['completed'])} stripes total)")
        return 0
    man = stream_count_matrix(
        bm, args.out_dir, superblock_rows=args.superblock,
        kernel=args.kernel, compress=not args.no_compress,
        operand_streaming={"auto": None, "on": True, "off": False}[args.operand_streaming],
        progress=lambda d, t: _log(f"stripe {d}/{t}"), device=args.dev,
    )
    _log(f"wrote {len(man['completed'])} stripes to {args.out_dir} "
         f"(kernel={man['kernel']}, operand_streaming={man.get('operand_streaming')})")
    return 0


def cmd_hist(args: argparse.Namespace) -> int:
    from stormtpu_torch.stats import count_histogram, count_row_sums

    bm = _load_matrix(args.infile)
    _log(f"loaded {bm}")
    man = count_histogram(
        bm, n_bins=args.bins, bin_width=args.bin_width,
        superblock_rows=args.superblock, method=args.method,
        progress=lambda d, t: _log(f"stripe {d}/{t}"), device=args.dev,
    )
    _log(f"route: {man['kernel']}")
    payload = {
        "hist": man["hist"],
        "bin_edges": man["bin_edges"],
        "n": man["n"],
        "m_bits": man["m_bits"],
        "pairs": man["pairs"],
    }
    if args.row_sums:
        payload["row_sums"] = count_row_sums(bm, include_self=False, device=args.dev)
    np.savez(args.out, **payload)
    _log(f"wrote {args.out}: {man['n_bins']} bins x width {man['bin_width']}, "
         f"{man['pairs']} pairs" + (", row_sums" if args.row_sums else ""))
    return 0


def _check_query_flags(args: argparse.Namespace, what: str) -> None:
    if args.against and args.stream:
        raise SystemExit(
            "--against and --stream are mutually exclusive: the cross "
            "form walks the panel in device-sized chunks itself"
        )
    if args.ckpt_dir and not args.stream:
        raise SystemExit(
            "--ckpt-dir requires --stream: only the stripe walk "
            "checkpoints (a silent no-op here would lose a crashed "
            "multi-hour run)"
        )
    if args.extend and (args.against or not (args.stream and args.ckpt_dir)):
        raise SystemExit(
            f"--extend requires --stream and --ckpt-dir (the completed "
            f"run to grow; {what} ride its checkpoint) and "
            f"is incompatible with --against"
        )


def cmd_topk(args: argparse.Namespace) -> int:
    _check_query_flags(args, "k/measure/superblock")
    dev = args.dev
    bm = _load_matrix(args.infile)
    _log(f"loaded {bm}")
    if args.against:
        from stormtpu_torch import cross_topk_neighbors

        panel = _load_matrix(args.against)
        _log(f"against panel {panel}")
        vals, idx = cross_topk_neighbors(bm, panel, args.k, measure=args.measure, device=dev)
    elif args.stream and args.extend:
        from stormtpu_torch.stream_query import extend_stream_topk_neighbors

        vals, idx = extend_stream_topk_neighbors(bm, args.ckpt_dir, device=dev)
    elif args.stream:
        from stormtpu_torch.stream_query import stream_topk_neighbors

        vals, idx = stream_topk_neighbors(
            bm, args.k, superblock_rows=args.superblock, measure=args.measure,
            out_dir=args.ckpt_dir or None, device=dev,
        )
    else:
        from stormtpu_torch import topk_neighbors

        vals, idx = topk_neighbors(bm, args.k, measure=args.measure, device=dev)
    np.savez(args.out, counts=vals, indices=idx)
    _log(f"wrote {args.out}: counts ({vals.dtype}) / indices int32 [{bm.n}, {args.k}]")
    return 0


def cmd_screen(args: argparse.Namespace) -> int:
    _check_query_flags(args, "measure/threshold/superblock")
    if args.threshold is None and not args.extend:
        raise SystemExit(
            "--threshold is required (except with --extend, where it "
            "rides the directory's manifest)"
        )
    dev = args.dev
    bm = _load_matrix(args.infile)
    _log(f"loaded {bm}")
    if args.against:
        from stormtpu_torch import cross_pairs_above

        panel = _load_matrix(args.against)
        _log(f"against panel {panel}")
        ii, jj, vals = cross_pairs_above(bm, panel, args.threshold, measure=args.measure,
                                         device=dev)
    elif args.stream and args.extend:
        from stormtpu_torch.stream_query import extend_stream_pairs_above

        ii, jj, vals = extend_stream_pairs_above(bm, args.ckpt_dir, device=dev)
    elif args.stream:
        from stormtpu_torch.stream_query import stream_pairs_above

        ii, jj, vals = stream_pairs_above(
            bm, args.threshold, measure=args.measure, superblock_rows=args.superblock,
            out_dir=args.ckpt_dir or None, device=dev,
        )
    else:
        from stormtpu_torch import pairs_above

        ii, jj, vals = pairs_above(bm, args.threshold, measure=args.measure, device=dev)
    np.savez(args.out, ii=ii, jj=jj, values=vals)
    desc = ("the manifest's screen" if args.extend
            else f"{args.measure} >= {args.threshold}")
    _log(f"wrote {args.out}: {ii.size} pairs with {desc}")
    if args.print_pairs:
        for a, b, v in zip(ii[: args.print_pairs], jj[: args.print_pairs],
                           vals[: args.print_pairs]):
            print(f"{a}\t{b}\t{v}")
    return 0


def cmd_clump(args: argparse.Namespace) -> int:
    from stormtpu_torch.clump import clump, clump_from_pairs

    if args.ckpt_dir and not args.stream:
        raise SystemExit(
            "--ckpt-dir requires --stream: only the stripe walk "
            "checkpoints (a silent no-op here would lose a crashed "
            "multi-hour run)"
        )
    dev = args.dev
    bm = _load_matrix(args.infile)
    _log(f"loaded {bm}")
    if args.stat:
        stat = np.load(args.stat)
    else:
        # without an association statistic, the densest rows lead
        stat = bm.row_nnz.astype(np.float64)
        _log("no --stat given: using row cardinalities as significance")
    if args.stream:
        from stormtpu_torch.stream_query import stream_pairs_above

        ii, jj, _ = stream_pairs_above(
            bm, args.threshold, measure=args.measure, superblock_rows=args.superblock,
            out_dir=args.ckpt_dir or None, device=dev,
        )
        res = clump_from_pairs(ii, jj, stat, n=bm.n)
    else:
        res = clump(bm, stat, args.threshold, measure=args.measure, device=dev)
    np.savez(args.out, leader=res.leader, leaders=res.leaders, sizes=res.sizes())
    _log(f"wrote {args.out}: {res.n_clumps} clumps over {bm.n} rows "
         f"({args.measure} >= {args.threshold})")
    for lead in res.leaders[: args.print_clumps]:
        mem = res.members(int(lead))
        print(f"{lead}\t{mem.size}\t{' '.join(map(str, mem[:16]))}"
              f"{' ...' if mem.size > 16 else ''}")
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="stormtpu_torch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; no card is an error) or 'cpu'")
    sub = p.add_subparsers(dest="cmd", required=True)
    matrix_help = "matrix file (.bed; .npz from save_bitmatrix or COO; dense .npy)"

    sp = sub.add_parser("info", help="versions, device, kernels and tuning cache")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("sweep", help="density-sweep benchmark with oracle cross-check")
    sp.add_argument("--n", type=int, default=256)
    sp.add_argument("--m", type=int, default=8192)
    sp.add_argument("--densities", default="0.001,0.01,0.1,0.5")
    sp.add_argument("--strategies", default="", help="comma list; default all")
    sp.add_argument("--reps", type=int, default=2)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser(
        "tune", help="measure the dense crossovers on this device and cache them for D1")
    # default: the full grid (tuning.DEFAULT_GRID); both --n and --m probe one
    # shape and merge it into this device's grid cache
    sp.add_argument("--n", type=int, default=None)
    sp.add_argument("--m", type=int, default=None)
    sp.add_argument("--reps", type=int, default=3)
    sp.set_defaults(fn=cmd_tune)

    sp = sub.add_parser("accept", help="run the BASELINE acceptance configs (checked, timed)")
    sp.add_argument("--config", type=int, action="append", default=None,
                    help="config id 1-5 (repeatable; default all)")
    sp.add_argument("--full", action="store_true", help="spec sizes instead of scaled")
    sp.add_argument("--out", default="acceptance.json")
    sp.set_defaults(fn=cmd_accept)

    sp = sub.add_parser("scaling", help="ring scaling efficiency across rank counts")
    sp.add_argument("--n", type=int, default=2048)
    sp.add_argument("--m", type=int, default=65536)
    sp.add_argument("--reps", type=int, default=2)
    sp.set_defaults(fn=cmd_scaling)

    sp = sub.add_parser("count", help="compute a pairwise count matrix from a file")
    sp.add_argument("--in", dest="infile", required=True, help=matrix_help)
    sp.add_argument("--out", required=True, help="output .npy")
    sp.add_argument("--op", default="intersect",
                    choices=("intersect", "union", "xor", "andnot", "nand"))
    sp.add_argument("--strategy", default="auto")
    sp.set_defaults(fn=cmd_count)

    sp = sub.add_parser(
        "stream",
        help="stream count-matrix stripes to a directory (resumable; "
        "for N where the N² result or the operands exceed memory)",
    )
    sp.add_argument("--in", dest="infile", required=True, help=matrix_help)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--superblock", type=int, default=4096)
    sp.add_argument("--kernel", default="auto",
                    choices=("auto", "mxu", "dense", "xla_int8",
                             "xla_popcount", "clustered", "sparse_outer"))
    sp.add_argument("--no-compress", action="store_true",
                    help="write stripes uncompressed (disk-speed writes)")
    sp.add_argument("--operand-streaming", default="auto", choices=("auto", "on", "off"),
                    help="keep only two superblock slices on the device")
    sp.add_argument("--extend", action="store_true",
                    help="grow an existing directory to this (larger) panel, reusing "
                    "every stripe inside the unchanged rows (fingerprint-guarded)")
    sp.set_defaults(fn=cmd_stream)

    sp = sub.add_parser(
        "hist",
        help="exact histogram of off-diagonal pair counts (and optional "
        "row marginals) without materializing the matrix",
    )
    sp.add_argument("--in", dest="infile", required=True, help=matrix_help)
    sp.add_argument("--out", required=True, help="output .npz (hist, bin_edges[, row_sums])")
    sp.add_argument("--bins", type=int, default=64)
    sp.add_argument("--bin-width", type=int, default=None,
                    help="override the uniform bin width (default covers "
                    "[0, m_bits] in --bins bins)")
    sp.add_argument("--superblock", type=int, default=4096)
    sp.add_argument("--method", default="auto",
                    choices=("auto", "dense", "streamed", "sparse", "clustered"),
                    help="density route; auto dispatches like the streaming count walk")
    sp.add_argument("--row-sums", action="store_true",
                    help="also write exact per-row count-sum marginals "
                    "(self term excluded; O(N*M) identity, no pair walk)")
    sp.set_defaults(fn=cmd_hist)

    sp = sub.add_parser("topk", help="per-row top-k partners by intersection count")
    sp.add_argument("--in", dest="infile", required=True, help=matrix_help)
    sp.add_argument("--out", required=True, help="output .npz (counts, indices)")
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--measure", default="count", choices=_MEASURES,
                    help="ranking score; similarities rank exact float64 scores "
                    "on every route (single-shot, --against, --stream)")
    sp.add_argument("--against", default="",
                    help="reference panel file: rank each input row against "
                    "THIS matrix's rows (cross-set form)")
    sp.add_argument("--stream", action="store_true",
                    help="operand-streaming stripe walk (N beyond device memory)")
    sp.add_argument("--superblock", type=int, default=4096)
    sp.add_argument("--ckpt-dir", default="",
                    help="with --stream: checkpoint/resume directory")
    sp.add_argument("--extend", action="store_true",
                    help="grow a COMPLETED --ckpt-dir run to this larger panel, "
                    "rescoring old rows only against new partners "
                    "(k/measure come from the checkpoint)")
    sp.set_defaults(fn=cmd_topk)

    sp = sub.add_parser(
        "screen", help="all pairs with a measure above a threshold (LD-style screen)")
    sp.add_argument("--in", dest="infile", required=True, help=matrix_help)
    sp.add_argument("--out", required=True, help="output .npz (ii, jj, values)")
    sp.add_argument("--threshold", type=float, default=None,
                    help="hit threshold (required unless --extend)")
    sp.add_argument("--measure", default="count", choices=_MEASURES)
    sp.add_argument("--print-pairs", type=int, default=0, metavar="K",
                    help="also print the first K hits to stdout")
    sp.add_argument("--against", default="",
                    help="reference panel file: screen each input row against "
                    "THIS matrix's rows (cross-set form)")
    sp.add_argument("--stream", action="store_true",
                    help="operand-streaming stripe walk (N beyond device memory)")
    sp.add_argument("--superblock", type=int, default=4096)
    sp.add_argument("--ckpt-dir", default="",
                    help="with --stream: per-stripe hit files, resumable")
    sp.add_argument("--extend", action="store_true",
                    help="grow a COMPLETED --ckpt-dir run to this larger panel, "
                    "reusing old-range hit files (measure/threshold come from "
                    "the manifest)")
    sp.set_defaults(fn=cmd_screen)

    sp = sub.add_parser(
        "clump",
        help="greedy leader clumping over a similarity screen (PLINK --clump shape)",
    )
    sp.add_argument("--in", dest="infile", required=True, help=matrix_help)
    sp.add_argument("--out", required=True, help="output .npz (leader, leaders, sizes)")
    sp.add_argument("--threshold", type=float, required=True)
    sp.add_argument("--measure", default="r2", choices=_MEASURES)
    sp.add_argument("--stat", default="",
                    help=".npy with one significance per row (higher = "
                    "leads first); default: row cardinalities")
    sp.add_argument("--print-clumps", type=int, default=0, metavar="K",
                    help="also print the first K clumps to stdout")
    sp.add_argument("--stream", action="store_true",
                    help="screen via the operand-streaming stripe walk "
                    "(N beyond device memory)")
    sp.add_argument("--superblock", type=int, default=4096)
    sp.add_argument("--ckpt-dir", default="",
                    help="with --stream: per-stripe hit files, resumable")
    sp.set_defaults(fn=cmd_clump)
    return p


def main(argv=None) -> int:
    from stormtpu_torch.utils import resolve_device

    args = _parser().parse_args(argv)
    try:
        args.dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"stormtpu_torch: {e}", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
