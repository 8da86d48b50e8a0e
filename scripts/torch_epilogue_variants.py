#!/usr/bin/env python3
"""Time K2-topk's and K2-hist's TMA body (``csrc/tile_body_tma.cuh``,
``csrc/k2_epilogue.cu``) against variants of it that differ by one edit to
the CUDA sources, each beside the shipped body, to show what each part of
the design is worth and what the compiler does with the loop.

    python3 scripts/torch_epilogue_variants.py [--out _archive/epilogue_variants]

Each variant is a copy of ``stormtpu_torch/`` under ``--out`` (a directory
``.gitignore`` lists), built and timed in a process of its own, in turns
(shipped, each variant, each variant again in reverse order, shipped):

- ``shipped``: no edit;
- ``no_multicast``: the shape rule returns clusters of one at every tile
  (the TMA pipeline alone: each block loads all of its B rows);
- ``release_cluster``: the consumers release a stage with an arrive of
  ``.release.cluster`` semantics instead of the default;
- ``wait_trap``: the barrier wait traps after 10 s (reads ``%globaltimer``);
- ``first_build``: ``release_cluster`` and ``wait_trap`` together.

A variant prints one JSON line: ptxas's C75xx remarks on the kernels and,
on three tile lists of uniform words made on the card (the main path's
first walk chunk, 1024 tiles of 256 rows at 8,192 words; a config-4
stripe's 16 × 16 tiles of 256 rows at 32,768 words; the main operand's
first 4096 tiles of 128 rows, clusters of one), K2-hist's (64 bins) and
K2-topk's (k = 16) CUDA-event ms on its two turns beside the shipped
body's two (the mean of 10 launches each), K2-tri's ms and whether its
results equal the shipped body's. Then the card's name and power limit.
The lines also go to ``chiprun_out/epilogue_variants.jsonl``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_WAIT = '''  while (!mbar_try_wait(bar, parity)) {
  }'''
_TRAP = '''  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0;
  asm volatile("mov.u64 %0, %%globaltimer;\\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }'''
_ARRIVE = "mbarrier.arrive.shared::cluster.b64 _, [remote];"
_RULE = "return nsub_m(ti) % 2 == 0 ? 2 : 1;"
EDITS = {
    "no_multicast": [("k2_epilogue.cu", _RULE, "return ti > 0 ? 1 : 1;")],
    "release_cluster": [("tile_body_tma.cuh", _ARRIVE,
                         "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];")],
    "wait_trap": [("tile_body_tma.cuh", _WAIT, _TRAP)],
}
VARIANTS = {"shipped": [], **EDITS,
            "first_build": EDITS["release_cluster"] + EDITS["wait_trap"]}


def make_variant(out: Path, name: str) -> Path:
    """A copy of ``stormtpu_torch/`` under ``out/name`` with the variant's
    edits; raises if a source no longer holds the text an edit replaces."""
    tree = out / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "stormtpu_torch", tree / "stormtpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for fname, old, new in VARIANTS[name]:
        src = tree / "stormtpu_torch" / "kernels" / "csrc" / fname
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
        src.write_text(text.replace(old, new))
    return tree


def time_tree(tree: str) -> dict:
    """The JSON line of the variant whose copy of the package is ``tree``."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import stormtpu_torch
    from stormtpu_torch import query
    from stormtpu_torch.kernels import _build, mxu

    if not stormtpu_torch.__file__.startswith(str(Path(tree).resolve())):
        raise RuntimeError(f"imported {stormtpu_torch.__file__}, not the variant's copy")

    def cuda_ms(fn, reps=10):
        fn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    _build.library("k2_epilogue")
    log = _build._target("k2_epilogue").with_suffix(".log").read_text()
    remarks = sorted({re.sub(r" in (the )?function.*| in around line \d+", "", line).strip()
                      for line in log.splitlines() if "(C75" in line})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def operand(rows, m_bits):
        return torch.randint(-(1 << 31), 1 << 31, (rows, m_bits // 32), dtype=torch.int32,
                             device=dev, generator=gen)

    main_x, stripe_x = operand(16_384, 1 << 18), operand(8_192, 1 << 20)
    wib, wjb = query._blocked_tile_ids(64, query._TILE_GROUP)
    sib, sjb = query._blocked_tile_ids(128, query._TILE_GROUP)
    li, lj = (g.ravel().astype(np.int32) for g in np.meshgrid(np.arange(16), np.arange(16),
                                                              indexing="ij"))
    out = {"remarks": remarks}
    for label, x, ib, jb, ti in (("main path, first walk chunk", main_x, wib[:1024],
                                  wjb[:1024], 256),
                                 ("config-4 stripe (0, 1)", stripe_x, li, lj + 16, 256),
                                 ("128-row tiles, first 4096", main_x, sib[:4096], sjb[:4096],
                                  128)):
        ids = mxu.device_tile_ids(ib, jb, x.shape[0] // ti, dev)
        kw = dict(tile_rows=ti, tile_words=256, checked=ids, n_real=x.shape[0])
        hkw = dict(bin_width=(x.shape[1] * 32 + 64) // 64, n_bins=64, **kw)
        digest = hashlib.sha256()
        for t in (mxu.count_tiles_hist(x, *ids, **hkw), *mxu.count_tiles_topk(x, *ids, k=16, **kw)):
            digest.update(t.cpu().numpy().tobytes())
        out[label] = {
            "digest": digest.hexdigest()[:16], "cluster": mxu.epilogue_cluster(ti),
            "k2_hist_ms": cuda_ms(lambda: mxu.count_tiles_hist(x, *ids, **hkw)),
            "k2_topk_ms": cuda_ms(lambda: mxu.count_tiles_topk(x, *ids, k=16, **kw)),
            "k2_tri_ms": cuda_ms(lambda: mxu.count_tiles_pallas_mxu(
                x, *ids, tile_rows=ti, tile_words=256, checked=ids))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="_archive/epilogue_variants",
                    help="where the variants' copies go")
    ap.add_argument("--time", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time:
        print(json.dumps(time_tree(args.time)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_epilogue_variants: no CUDA card", file=sys.stderr)
        return 1
    out = Path(args.out)
    trees = {name: make_variant(out, name) for name in VARIANTS}
    edited = [name for name in VARIANTS if name != "shipped"]
    runs = {name: [] for name in VARIANTS}
    for name in ["shipped", *edited, *reversed(edited), "shipped"]:
        run = subprocess.run([sys.executable, __file__, "--time", str(trees[name])],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise RuntimeError(f"variant {name} failed:\n{run.stdout}\n{run.stderr}")
        runs[name].append(json.loads(run.stdout.strip().splitlines()[-1]))
    lines = []
    for name in edited:
        row = {"variant": name, "remarks": runs[name][0]["remarks"]}
        for label, first in runs[name][0].items():
            if label == "remarks":
                continue
            mine = [r[label] for r in runs[name]]
            shipped = [r[label] for r in runs["shipped"]]
            row[label] = {
                "equal": all(m["digest"] == shipped[0]["digest"] for m in mine + shipped),
                "cluster": first["cluster"],
                **{key: [m[key] for m in mine] for key in ("k2_hist_ms", "k2_topk_ms",
                                                           "k2_tri_ms")},
                **{f"shipped_{key}": [s[key] for s in shipped]
                   for key in ("k2_hist_ms", "k2_topk_ms")}}
        lines.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    Path("chiprun_out").mkdir(exist_ok=True)
    with open("chiprun_out/epilogue_variants.jsonl", "w") as f:
        for row in lines:
            f.write(json.dumps({**row, "card": smi}) + os.linesep)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
