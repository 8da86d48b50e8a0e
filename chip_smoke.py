#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stormtpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises on failure (exit code != 0, no result line):

1. build the CUDA kernels from ``stormtpu_torch/kernels/csrc`` (one nvcc
   per source, all started together);
2. hold each K2 kernel against its plain PyTorch version on the card, with
   exact equality (counts are integers: tolerance 0) — ragged small
   shapes, a mid shape at densities 0.001 / 0.5 / 1.0, and an all-ones
   matrix whose every count is 2^27;
3. the main path: ``intersect_count_matrix`` with ``strategy="auto"`` on
   16384 × 262144 bits of uniform random words; D1 must choose
   ``pallas_mxu`` and the K2 triangular kernel must launch; 4096 sampled
   pairs, the diagonal and symmetry are checked against numpy;
4. ``count_block`` of 4096 × 16384 rows at the same width; the K2
   rectangular kernel must launch; sampled pairs checked;
5. ``pair_count`` of one pair of 1,048,576 bits, checked against numpy;
6. timings at the main-path shapes (CUDA events): each kernel, its plain
   version (also compared, exactly), one ``torch._int_mm`` call on
   pre-unpacked int8 operands as a yardstick, and each kernel's bound.

The lines before the last are a ``kernels`` JSON object and the card's
``name, power.limit``; the last line is the result object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core rate and HBM3 rate
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES_PER_S = 3.35e12

DEVICE = "cuda"
MAIN_N = 16384
MAIN_M = 262144
RAGGED = ((37, 1000), (37, 100_003), (300, 100_003))
MID_N, MID_M = 2053, 262_161
ALL_ONES_N, ALL_ONES_M = 128, 1 << 27
BLOCK_NA = 4096
PAIR_M = 1 << 20
N_SAMPLES = 4096


def random_words(rng, n: int, m_bits: int, density: float) -> np.ndarray:
    """uint32 [n, ceil(m/32)] with bits beyond m_bits clear: all ones at
    density 1, uniform words at 0.5, else ~density·n·m uniform positions."""
    w = -(-m_bits // 32)
    if density >= 1.0:
        words = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    elif density == 0.5:
        words = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint32)
    else:
        flat = rng.integers(0, n * m_bits, size=int(density * n * m_bits))
        words = np.zeros((n, w), dtype=np.uint32)
        rows, pos = flat // m_bits, flat % m_bits
        np.bitwise_or.at(words, (rows, pos >> 5), np.uint32(1) << (pos & 31).astype(np.uint32))
    if m_bits % 32:
        words[:, -1] &= np.uint32((1 << (m_bits % 32)) - 1)
    return words


def sampled_counts(a: np.ndarray, b: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    out = np.empty(i.size, dtype=np.int64)
    for s in range(0, i.size, 256):
        out[s : s + 256] = np.bitwise_count(a[i[s : s + 256]] & b[j[s : s + 256]]).sum(
            axis=1, dtype=np.int64
        )
    return out


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def exact_diff(torch, got, want) -> int:
    """Max |got − want|; raises unless the two are exactly equal."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0
    if err:
        raise AssertionError(f"kernel differs from its plain version by up to {err}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this run needs one", file=sys.stderr)
        return 1

    import stormtpu_torch as st
    from stormtpu_torch.config import default_config
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.kernels import _build, mxu
    from stormtpu_torch.kernels.xla import unpack_to_int8
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.oracle import oracle_pair_count
    from stormtpu_torch.utils import assemble_triangular, round_up, triangular_tile_ids

    dev = torch.device(DEVICE)
    cfg = default_config()
    rng = np.random.default_rng(args.seed)
    max_err = {"k2_tri": 0, "k2_rect": 0}

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"[build] {len(_build.SOURCES)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    def tri_inputs(words: np.ndarray):
        n, w = words.shape
        ti, wk = mxu.k2_tile_shape(cfg, n, w)
        xp = np.zeros((round_up(n, ti), round_up(w, wk)), np.uint32)
        xp[:n, :w] = words
        ibs, jbs = triangular_tile_ids(xp.shape[0] // ti)
        return (to_device_words(xp, dev), torch.from_numpy(ibs).to(dev),
                torch.from_numpy(jbs).to(dev)), dict(tile_rows=ti, tile_words=wk)

    def rect_inputs(a: np.ndarray, b: np.ndarray):
        w = a.shape[1]
        ti, wk = mxu.k2_tile_shape(cfg, max(a.shape[0], b.shape[0]), w)
        pads = []
        for x in (a, b):
            xp = np.zeros((round_up(x.shape[0], ti), round_up(w, wk)), np.uint32)
            xp[: x.shape[0], :w] = x
            pads.append(to_device_words(xp, dev))
        return pads, dict(tile_rows=ti, tile_words=wk)

    def check_both(label: str, words: np.ndarray, expect_all=None) -> None:
        targs, tkw = tri_inputs(words)
        got = mxu.count_tiles_pallas_mxu(*targs, **tkw)
        want = mxu.count_tiles_plain(*targs, **tkw)
        torch.cuda.synchronize()
        max_err["k2_tri"] = max(max_err["k2_tri"], exact_diff(torch, got, want))
        a = words[: max(1, words.shape[0] // 3)]
        (ap, bp), rkw = rect_inputs(a, words)
        got_r = mxu._count_block_padded(ap, bp, variant=cfg.k2_variant, **rkw)
        want_r = mxu.count_block_plain(ap, bp, tile_words=rkw["tile_words"])
        torch.cuda.synchronize()
        max_err["k2_rect"] = max(max_err["k2_rect"], exact_diff(torch, got_r, want_r))
        if expect_all is not None:
            n = words.shape[0]
            if not (bool((got[0, :n, :n] == expect_all).all())
                    and bool((got_r[: a.shape[0], :n] == expect_all).all())):
                raise AssertionError(f"{label}: counts are not all {expect_all}")
        print(f"[kernel vs plain] {label}: N={words.shape[0]} W={words.shape[1]} "
              f"tile={tkw['tile_rows']}x{tkw['tile_words']} T={targs[1].numel()} exact")
        del targs, got, want, ap, bp, got_r, want_r
        torch.cuda.empty_cache()

    # ------------------------------------------------------- 2 kernel vs plain
    for n, m in RAGGED:
        check_both(f"ragged N={n} M={m}", random_words(rng, n, m, 0.5))
    for density in (0.001, 0.5, 1.0):
        check_both(f"mid N={MID_N} M={MID_M} density={density}",
                   random_words(rng, MID_N, MID_M, density))
    check_both(f"all-ones N={ALL_ONES_N} M={ALL_ONES_M}",
               random_words(rng, ALL_ONES_N, ALL_ONES_M, 1.0), expect_all=ALL_ONES_M)

    # --------------------------------------------------------- 3 main path
    words = rng.integers(0, 1 << 32, size=(MAIN_N, MAIN_M // 32), dtype=np.uint32)
    bm = st.BitMatrix.from_packed(words, MAIN_M)
    chosen = choose_strategy(bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev)
    if chosen != "pallas_mxu":
        raise AssertionError(f"D1 chose {chosen!r} at {MAIN_N} x {MAIN_M}, want 'pallas_mxu'")
    mxu.reset_launches()
    t0 = time.perf_counter()
    out = st.intersect_count_matrix(bm, strategy="auto", device=dev)
    wall_tri = time.perf_counter() - t0
    launches_tri = mxu.LAUNCHES["k2_tri"]
    if launches_tri < 1:
        raise AssertionError("the main path did not launch the K2 triangular kernel")
    if out.shape != (MAIN_N, MAIN_N) or out.dtype != np.int32:
        raise AssertionError(f"result {out.shape} {out.dtype}")
    i = rng.integers(0, MAIN_N, N_SAMPLES)
    j = rng.integers(0, MAIN_N, N_SAMPLES)
    if not np.array_equal(out[i, j], sampled_counts(words, words, i, j)):
        raise AssertionError("sampled pairs differ from numpy")
    if not np.array_equal(np.diagonal(out), bm.row_nnz):
        raise AssertionError("diagonal differs from row_nnz")
    if not np.array_equal(out, out.T):
        raise AssertionError("count matrix is not symmetric")
    print(f"[main path] intersect_count_matrix {MAIN_N} x {MAIN_M} bits: D1 chose {chosen}, "
          f"k2_tri launches {launches_tri}, {N_SAMPLES} sampled pairs + diagonal + symmetry "
          f"exact; wall {wall_tri:.3f} s (first call: upload, kernel, host assembly)")
    del out

    # --------------------------------------------------------- 4 count_block
    words_a = rng.integers(0, 1 << 32, size=(BLOCK_NA, MAIN_M // 32), dtype=np.uint32)
    bm_a = st.BitMatrix.from_packed(words_a, MAIN_M)
    mxu.reset_launches()
    t0 = time.perf_counter()
    blk = st.count_block(bm_a, bm, device=dev)
    wall_rect = time.perf_counter() - t0
    launches_rect = mxu.LAUNCHES["k2_rect"]
    if launches_rect < 1:
        raise AssertionError("count_block did not launch the K2 rectangular kernel")
    if blk.shape != (BLOCK_NA, MAIN_N) or blk.dtype != np.int32:
        raise AssertionError(f"result {blk.shape} {blk.dtype}")
    i = rng.integers(0, BLOCK_NA, N_SAMPLES)
    j = rng.integers(0, MAIN_N, N_SAMPLES)
    if not np.array_equal(blk[i, j], sampled_counts(words_a, words, i, j)):
        raise AssertionError("count_block sampled pairs differ from numpy")
    print(f"[count_block] {BLOCK_NA} x {MAIN_N} rows at {MAIN_M} bits: k2_rect launches "
          f"{launches_rect}, {N_SAMPLES} sampled pairs exact; wall {wall_rect:.3f} s")
    del blk

    # --------------------------------------------------------- 5 pair_count
    pa, pb = random_words(rng, 2, PAIR_M, 0.5)
    got = st.pair_count(st.BitMatrix.from_packed(pa[None], PAIR_M),
                        st.BitMatrix.from_packed(pb[None], PAIR_M), device=dev)
    if got != oracle_pair_count(pa, pb):
        raise AssertionError("pair_count differs from numpy")
    print(f"[pair_count] {PAIR_M} bits: {got} exact")

    # ------------------------------------------------------------ 6 timings
    t0 = time.perf_counter()
    st.intersect_count_matrix(bm, device=dev)
    wall_tri_warm = time.perf_counter() - t0
    # host-clock breakdown of the warm call's stages, in the order
    # api.intersect_count_matrix runs them (operand already cached on the card)
    stages = {}

    def stage(name, fn):
        s = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - s
        return r

    stage("dispatch", lambda: choose_strategy(bm.n, bm.m_bits, bm.density, cfg, bm=bm, device=dev))
    stage("compaction_scan", lambda: bm.packed.any(axis=0))
    ti_main, wk_main = mxu.k2_tile_shape(cfg, bm.n, bm.n_words)
    nb_main = round_up(MAIN_N, ti_main) // ti_main
    xp_main = stage("pad", lambda: mxu._pad(bm.device_padded(bm.n, device=dev),
                                            nb_main * ti_main, round_up(bm.n_words, wk_main)))
    ibs_np, jbs_np = triangular_tile_ids(nb_main)
    ids = stage("tile_ids_h2d", lambda: (torch.from_numpy(ibs_np).to(dev),
                                         torch.from_numpy(jbs_np).to(dev)))
    tiles = stage("k2_tri_kernel", lambda: mxu.count_tiles_pallas_mxu(
        xp_main, *ids, tile_rows=ti_main, tile_words=wk_main))
    tiles_np = stage("tiles_d2h", lambda: tiles.cpu().numpy())
    stage("host_assembly", lambda: assemble_triangular(tiles_np, ibs_np, jbs_np, nb_main, MAIN_N))
    del tiles, tiles_np
    print("[breakdown] warm intersect_count_matrix stages (host clock, s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} of wall {wall_tri_warm:.4f}")
    timings = {}
    # triangular K2 at the main path's shapes
    targs, tkw = tri_inputs(words)
    t_tiles = targs[1].numel()
    n_pad, w_pad = targs[0].shape
    got = mxu.count_tiles_pallas_mxu(*targs, **tkw)
    want = mxu.count_tiles_plain(*targs, **tkw)
    torch.cuda.synchronize()
    max_err["k2_tri"] = max(max_err["k2_tri"], exact_diff(torch, got, want))
    del got, want
    plain_ms = cuda_ms(torch, lambda: mxu.count_tiles_plain(*targs, **tkw), reps=2)
    kern_ms = cuda_ms(torch, lambda: mxu.count_tiles_pallas_mxu(*targs, **tkw), reps=5)
    u = torch.empty((n_pad, w_pad * 32), dtype=torch.int8, device=dev)
    for r in range(0, n_pad, 2048):
        u[r : r + 2048] = unpack_to_int8(targs[0][r : r + 2048])
    lib_ms = cuda_ms(torch, lambda: torch._int_mm(u, u.t()), reps=3)
    ti = tkw["tile_rows"]
    b_ms, b_by = bound(2.0 * t_tiles * ti * ti * w_pad * 32,
                       4.0 * (n_pad * w_pad + 2 * t_tiles + t_tiles * ti * ti))
    timings["k2_tri"] = dict(ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)
    print(f"[timing] k2_tri N_pad={n_pad} W_pad={w_pad} T={t_tiles} tile={ti}: kernel "
          f"{kern_ms:.3f} ms, plain {plain_ms:.3f} ms, _int_mm full square on unpacked "
          f"int8 {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    # rectangular K2 at count_block's shapes
    (ap, bp), rkw = rect_inputs(words_a, words)
    got = mxu._count_block_padded(ap, bp, variant=cfg.k2_variant, **rkw)
    want = mxu.count_block_plain(ap, bp, tile_words=rkw["tile_words"])
    torch.cuda.synchronize()
    max_err["k2_rect"] = max(max_err["k2_rect"], exact_diff(torch, got, want))
    del got, want
    plain_ms = cuda_ms(torch, lambda: mxu.count_block_plain(ap, bp, tile_words=rkw["tile_words"]), reps=2)
    kern_ms = cuda_ms(torch, lambda: mxu._count_block_padded(ap, bp, variant=cfg.k2_variant, **rkw), reps=5)
    ua = torch.empty((ap.shape[0], w_pad * 32), dtype=torch.int8, device=dev)
    for r in range(0, ap.shape[0], 2048):
        ua[r : r + 2048] = unpack_to_int8(ap[r : r + 2048])
    lib_ms = cuda_ms(torch, lambda: torch._int_mm(ua, u.t()), reps=3)
    na_pad, nb_pad = ap.shape[0], bp.shape[0]
    b_ms, b_by = bound(2.0 * na_pad * nb_pad * w_pad * 32,
                       4.0 * ((na_pad + nb_pad) * w_pad + na_pad * nb_pad))
    timings["k2_rect"] = dict(ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
    print(f"[timing] k2_rect {na_pad} x {nb_pad} W_pad={w_pad}: kernel {kern_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, _int_mm on unpacked int8 {lib_ms:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by})")
    print(f"[timing] intersect_count_matrix wall: first call {wall_tri:.3f} s, warm call "
          f"{wall_tri_warm:.3f} s; count_block wall {wall_rect:.3f} s")
    del u, ua, targs, ap, bp
    torch.cuda.empty_cache()

    source = "stormtpu_torch/kernels/csrc/k2_mxu.cu"
    kernels = [
        dict(name="k2_tri", route="cuda", source=source,
             replaces="stormtpu/kernels/mxu.py:202", launches=launches_tri,
             max_abs_err=max_err["k2_tri"], **timings["k2_tri"]),
        dict(name="k2_rect", route="cuda", source=source,
             replaces="stormtpu/kernels/mxu.py:248", launches=launches_rect,
             max_abs_err=max_err["k2_rect"], **timings["k2_rect"]),
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
