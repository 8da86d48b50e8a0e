"""Acceptance runs of ``BASELINE.json`` configs 1–5 (port of
``stormtpu/acceptance.py``).

Each config runs end to end on the device, is checked against the exact
NumPy oracle (on sampled pairs where the matrix is too large to check
whole), and reports its time. The scaled sizes are the JAX package's; on
the card each config also runs its full-scale parts: config 3's full
10,000-row pass, and config 4's rate at the 100,000 × 1,000,000-bit shape,
its full checksum walk and its aggregate sinks, each on an operand made on
the card from its seed.

  python -m stormtpu_torch accept              # configs 1-5
  python -m stormtpu_torch accept --config 3   # one config
  python -m stormtpu_torch accept --full       # spec sizes everywhere

Config 5 (multi-host, row-sharded all-pairs with a collective merge) runs
the ring of ``stormtpu_torch.parallel`` over the process group this
process is in: under ``torchrun`` every rank runs it, on its own card;
alone, a one-rank group. Each entry is stamped with the device's name and
power limit.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["run_acceptance", "CONFIGS"]

#: rows of config 4's row-sum panel on the card (the spec's 100,000)
CONFIG4_ROW_SUM_ROWS = 100_000


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sample_verify(counts_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                   packed: np.ndarray, n: int, n_samples: int, seed: int) -> None:
    """counts_fn(ii, jj) -> got; checked against the host popcount."""
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, n, n_samples)
    jj = rng.integers(0, n, n_samples)
    want = np.bitwise_count(packed[ii] & packed[jj]).sum(axis=1, dtype=np.int64)
    got = np.asarray(counts_fn(ii, jj)).astype(np.int64)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"acceptance verification FAILED on {int((got != want).sum())}"
            f"/{n_samples} sampled pairs"
        )


def _random_packed(n: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (n, w), dtype=np.uint32)


def _device_panel(n: int, w: int, n_pad: int, w_pad: int, seed: int,
                  dev: torch.device) -> torch.Tensor:
    """Uniform random words int32 [n_pad, w_pad] made on ``dev`` from
    ``seed``, zero outside the first n rows and w words."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.zeros((n_pad, w_pad), dtype=torch.int32, device=dev)
    for r in range(0, n, 4096):
        rows = min(4096, n - r)
        x[r : r + rows, :w] = torch.randint(-(1 << 31), 1 << 31, (rows, w),
                                            dtype=torch.int32, device=dev, generator=gen)
    _sync(dev)
    return x


def _host_words(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


def config1_single_pair(full: bool, log, device) -> dict:
    """Dense AND+popcount of two 1M-bit bitmaps, a single pair (B:7)."""
    from stormtpu_torch import BitMatrix, pair_count

    m = 1_000_000
    w = -(-m // 32)
    packed = _random_packed(2, w, seed=101)
    packed[:, -1] &= (1 << (m % 32)) - 1 if m % 32 else 0xFFFFFFFF
    a = BitMatrix.from_packed(packed[:1], m_bits=m)
    b = BitMatrix.from_packed(packed[1:], m_bits=m)
    t0 = time.perf_counter()
    got = pair_count(a, b, device=device)
    dt_cold = time.perf_counter() - t0
    want = int(np.bitwise_count(packed[0] & packed[1]).sum())
    assert got == want, f"single-pair mismatch {got} != {want}"
    packed2 = _random_packed(2, w, seed=111)
    a2 = BitMatrix.from_packed(packed2[:1], m_bits=w * 32)
    b2 = BitMatrix.from_packed(packed2[1:], m_bits=w * 32)
    t0 = time.perf_counter()
    got2 = pair_count(a2, b2, device=device)
    dt_warm = time.perf_counter() - t0
    assert got2 == int(np.bitwise_count(packed2[0] & packed2[1]).sum())
    log(f"[config1] |A∩B| = {got} exact; {dt_cold * 1e3:.1f} ms first call, "
        f"{dt_warm * 1e3:.1f} ms warm")
    return {"config": 1, "m_bits": m, "exact": True, "seconds": dt_warm,
            "seconds_cold": dt_cold}


def config2_allpairs_dense(full: bool, log, device) -> dict:
    """All pairs of 1,000 dense bitmaps of 65,536 bits, word-wise
    AND+popcount (K1, B:8) — at the spec size either way, checked in full."""
    from stormtpu_torch import BitMatrix, intersect_count_matrix
    from stormtpu_torch.config import default_config
    from stormtpu_torch.kernels.dense import count_tiles_pallas_dense, k1_tile_shape
    from stormtpu_torch.kernels.mxu import device_tile_ids
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.oracle import oracle_count_matrix
    from stormtpu_torch.utils import round_up, triangular_tile_ids
    from stormtpu_torch.utils.profiling import timeit_sustained_auto

    dev = torch.device(device)
    n, m = 1000, 65536
    packed = _random_packed(n, m // 32, seed=102)
    bm = BitMatrix.from_packed(packed, m_bits=m)
    warm = BitMatrix.from_packed(_random_packed(n, m // 32, seed=202), m_bits=m)
    intersect_count_matrix(warm, strategy="pallas_dense", device=dev)
    t0 = time.perf_counter()
    got = intersect_count_matrix(bm, strategy="pallas_dense", device=dev)
    dt = time.perf_counter() - t0
    assert np.array_equal(got, oracle_count_matrix(packed)), "config2 full verification failed"
    # the K1 tile walk alone, on operands already on the device
    ti, wk = k1_tile_shape(default_config(), n, m // 32)
    n_pad = round_up(n, ti)
    xds = []
    for s in range(3):
        xp = np.zeros((n_pad, round_up(m // 32, wk)), dtype=np.uint32)
        xp[:n, : m // 32] = packed if s == 0 else _random_packed(n, m // 32, seed=300 + s)
        xds.append(to_device_words(xp, dev))
    ids = device_tile_ids(*triangular_tile_ids(n_pad // ti), n_pad // ti, dev)
    dt_s = timeit_sustained_auto(
        lambda x: count_tiles_pallas_dense(x, *ids, tile_rows=ti, tile_words=wk, checked=ids),
        xds,
    )
    tri = n * (n + 1) / 2
    log(f"[config2] {n}×{m // 1024}Kbit all-pairs exact (full check); {dt:.4f} s wall "
        f"(upload, K1, assembly, download) → K1 alone {tri / dt_s / 1e6:.0f} M-pairs/s")
    return {"config": 2, "n": n, "m_bits": m, "exact": True, "seconds": dt,
            "pairs_per_s": n * n / dt, "sustained_pairs_per_s": tri / dt_s,
            "note": "seconds is the wall of one warm call (upload, K1, assembly on the "
            "device, download); sustained_pairs_per_s times the K1 tile walk alone"}


def config3_sparse(full: bool, log, device) -> dict:
    """Sparse (<1% density) scattered positions, 10k × 1M bits (B:9):
    ingest from positions, D1, K3 on a 256-row subset, and sampled pair
    counts at 2,000 rows; at full size (and on the card beside the scaled
    entry, under ``full``) the whole 10,000 × 10,000 triangle by K2 on the
    card with 4096 sampled entries checked."""
    dev = torch.device(device)
    if full:
        return _config3_body(10_000, log, dev)
    result = _config3_body(2_000, log, dev)
    if dev.type == "cuda":
        result["full"] = _config3_body(10_000, log, dev)
    return result


def _config3_body(n: int, log, dev: torch.device) -> dict:
    from stormtpu_torch import BitMatrix
    from stormtpu_torch.config import default_config
    from stormtpu_torch.dispatch import choose_strategy
    from stormtpu_torch.kernels.mxu import count_tiles_pallas_mxu, device_tile_ids
    from stormtpu_torch.kernels.sparse import count_block_sparse, padded_position_lists
    from stormtpu_torch.layout import to_device_words
    from stormtpu_torch.oracle import oracle_count_block
    from stormtpu_torch.utils import round_up, triangular_tile_ids

    full = n >= 10_000
    m = 1_000_000
    density = 0.008
    rng = np.random.default_rng(103)
    nnz_per_row = int(m * density)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, m, n * nnz_per_row).astype(np.int64)
    t0 = time.perf_counter()
    bm = BitMatrix.from_positions(rows, cols, n, m)
    ingest = time.perf_counter() - t0
    del rows, cols
    strat = choose_strategy(bm.n, bm.m_bits, bm.density, device=dev)
    log(f"[config3] ingest {n}×1M {bm.density * 100:.2f}%: {ingest:.2f} s; dispatch → {strat}")

    sub = 256
    bm_sub = BitMatrix.from_packed(bm.packed[:sub], m_bits=bm.m_bits)
    pos = torch.from_numpy(padded_position_lists(bm_sub)).to(dev)
    got_sub = count_block_sparse(pos, pos, sentinel=bm.m_bits).cpu().numpy()
    want_sub = oracle_count_block(bm.packed[:sub], bm.packed[:sub])
    assert np.array_equal(got_sub.astype(np.int64), want_sub), "config3 K3 positions path mismatch"
    log(f"[config3] K3 positions path exact on {sub}×{sub} subset")

    if not full:
        from stormtpu_torch.query import pair_counts

        t0 = time.perf_counter()
        _sample_verify(lambda ii, jj: pair_counts(bm, ii, jj, device=dev), bm.packed, n,
                       4096, seed=103)
        dt = time.perf_counter() - t0
        log(f"[config3] scaled: 4096 sampled pair counts exact; {dt:.2f} s")
        return {"config": 3, "n": n, "m_bits": m, "density": bm.density,
                "dispatch": strat, "exact_sampled": True, "ingest_seconds": ingest}

    cfg = default_config()
    ti, wk = cfg.k2_tile_rows, cfg.k2_tile_words
    n_pad, w_pad = round_up(n, ti), round_up(bm.n_words, wk)
    xp = np.zeros((n_pad, w_pad), dtype=np.uint32)
    xp[:n, : bm.n_words] = bm.packed
    xd = to_device_words(xp, dev)
    del xp
    nb = n_pad // ti
    ids = device_tile_ids(*triangular_tile_ids(nb), nb, dev)
    s_rng = np.random.default_rng(1003)
    ii = s_rng.integers(0, n, 4096)
    jj = s_rng.integers(0, n, 4096)
    lo, hi = np.minimum(ii, jj), np.maximum(ii, jj)
    ib, jb = lo // ti, hi // ti
    # i-major triangular enumeration: t = ib·nb − ib(ib−1)/2 + (jb − ib)
    tid = torch.from_numpy(ib * nb - (ib * (ib - 1)) // 2 + (jb - ib)).to(dev)
    lo_d = torch.from_numpy(lo % ti).to(dev)
    hi_d = torch.from_numpy(hi % ti).to(dev)

    def run() -> np.ndarray:
        tiles = count_tiles_pallas_mxu(xd, *ids, tile_rows=ti, tile_words=wk, checked=ids)
        return tiles[tid, lo_d, hi_d].cpu().numpy().astype(np.int64)

    run()
    _sync(dev)
    t0 = time.perf_counter()
    got = run()
    dt = time.perf_counter() - t0
    want = np.bitwise_count(bm.packed[lo] & bm.packed[hi]).sum(axis=1, dtype=np.int64)
    assert np.array_equal(got, want), "config3 full all-pairs mismatch"
    pairs = n * (n + 1) / 2
    log(f"[config3] full {n}×{n} all-pairs by K2 on {dev.type}, 4096 sampled exact; "
        f"{dt:.4f} s → {pairs / dt / 1e6:.0f} M-pairs/s")
    return {"config": 3, "n": n, "m_bits": m, "density": bm.density,
            "dispatch": strat, "exact_sampled": True,
            "ingest_seconds": ingest, "seconds": dt, "pairs_per_s": pairs / dt}


_C4_N, _C4_M, _C4_SB = 100_000, 1_000_000, 4096


def _config4_spec_rate(log, dev: torch.device) -> dict:
    """K2's rate at the full config-4 shape (100k × 1M bits) on the card:
    the padded operand is made on the card, and a random selection of 4096
    tile pairs of the triangle (the executable the streaming walk runs) is
    timed by CUDA events, three selections; one tile checked by numpy."""
    from stormtpu_torch.config import default_config
    from stormtpu_torch.kernels.mxu import count_tiles_pallas_mxu, device_tile_ids
    from stormtpu_torch.tuning import wgmma_b1_ops_per_s
    from stormtpu_torch.utils import round_up, triangular_tile_ids

    n, m = _C4_N, _C4_M
    cfg = default_config()
    ti, wk = cfg.k2_tile_rows, cfg.k2_tile_words
    w = m // 32
    n_pad, w_pad = round_up(n, ti), round_up(w, wk)
    t_sub = 4096
    xd = _device_panel(n, w, n_pad, w_pad, 0, dev)
    nb = n_pad // ti
    ibs_all, jbs_all = triangular_tile_ids(nb)

    def selection(seed):
        r = np.random.default_rng(seed)
        sel = np.sort(r.choice(len(ibs_all), size=t_sub, replace=False))
        return device_tile_ids(ibs_all[sel], jbs_all[sel], nb, dev), sel

    def run(ids):
        return count_tiles_pallas_mxu(xd, *ids, tile_rows=ti, tile_words=wk, checked=ids)

    ids0, sel0 = selection(0)
    tile0 = run(ids0)[0, :8, :8].cpu().numpy().astype(np.int64)
    ib0, jb0 = int(ibs_all[sel0[0]]), int(jbs_all[sel0[0]])
    rows_i = _host_words(xd[ib0 * ti : ib0 * ti + 8])
    rows_j = _host_words(xd[jb0 * ti : jb0 * ti + 8])
    want = np.bitwise_count(rows_i[:, None, :] & rows_j[None, :, :]).sum(axis=2, dtype=np.int64)
    assert np.array_equal(tile0, want), "config4 spec-shape tile INEXACT"
    dts = []
    for seed in (1, 2, 3):
        ids, _ = selection(seed)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(ids)
        stop.record()
        torch.cuda.synchronize(dev)
        dts.append(start.elapsed_time(stop) * 1e-3)
        del out
    del xd
    torch.cuda.empty_cache()
    dt = float(np.median(dts))
    rate = t_sub * ti * ti / dt
    peak = wgmma_b1_ops_per_s(dev)
    frac = rate * 2 * m / peak
    total_pairs = n * (n + 1) / 2
    log(f"[config4] spec-shape rate (100k×1M, {t_sub} tile pairs, one tile exact): "
        f"{rate / 1e6:.0f} M-pairs/s = {frac:.1%} of the b1 wgmma rate → full config "
        f"≈{total_pairs / rate:.2f} s of K2")
    return {"spec_rate_pairs_per_s": rate, "spec_wgmma_b1_frac": frac,
            "spec_full_config_seconds_est": total_pairs / rate}


def _config4_operand(seed: int, dev: torch.device) -> torch.Tensor:
    from stormtpu_torch.config import default_config
    from stormtpu_torch.utils import round_up

    w = -(-_C4_M // 32)
    return _device_panel(_C4_N, w, round_up(_C4_N, _C4_SB),
                         round_up(w, default_config().k2_tile_words), seed, dev)


def _config4_full_stream(log, dev: torch.device) -> dict:
    """The full 100k × 1M config through the streaming stripe walk (325
    superblock stripes) with the checksum sink, on an operand made on the
    card: the sampled entries are checked against the plain popcount of
    the same rows on the card, and 8 of them by numpy."""
    from stormtpu_torch.kernels import xla as kx
    from stormtpu_torch.stream import stream_count_checksums

    n, m, sb = _C4_N, _C4_M, _C4_SB
    xd = _config4_operand(4, dev)
    t0 = time.perf_counter()
    man = stream_count_checksums(
        xd, n, m, superblock_rows=sb, device=dev,
        progress=lambda d, t: (d % 50 == 0 or d == t)
        and log(f"  [config4/full] stripe {d}/{t}"),
    )
    _sync(dev)
    dt = time.perf_counter() - t0
    assert man["n_super"] == xd.shape[0] // sb
    ii = torch.from_numpy(man["sample_ii"].astype(np.int64)).to(dev)
    jj = torch.from_numpy(man["sample_jj"].astype(np.int64)).to(dev)
    want = torch.cat([kx.pair_count_batch_xla(xd[ii[s : s + 256]], xd[jj[s : s + 256]])
                      for s in range(0, ii.numel(), 256)]).cpu().numpy()
    assert np.array_equal(want, man["sample_vals"]), \
        "config4 full-stream sampled entries differ from the plain popcount"
    host = np.bitwise_count(_host_words(xd[ii[:8]]) & _host_words(xd[jj[:8]])).sum(
        axis=1, dtype=np.int64)
    assert np.array_equal(host, man["sample_vals"][:8].astype(np.int64)), \
        "config4 full-stream numpy anchor mismatch"
    del xd
    torch.cuda.empty_cache()
    pairs = n * (n + 1) / 2
    log(f"[config4] FULL 100k×1M stream: {man['n_super']} superblocks / "
        f"{len(man['stripes'])} stripes in {dt:.2f} s ({pairs / dt / 1e6:.0f} M-pairs/s "
        f"end to end), {ii.numel()} sampled entries exact")
    return {"full": True, "sink": "checksum", "n_super": man["n_super"],
            "stripes": len(man["stripes"]), "seconds": dt, "pairs_per_s": pairs / dt,
            "samples_verified": int(ii.numel()), "sampled_exact": True}


def _config4_aggregate_stats(log, dev: torch.device) -> dict:
    """The aggregate sinks at the spec shape on the card: the 100k × 1M
    histogram on the stripe walk, held by mass conservation, by a second
    walk at double the bin width (its bins equal the first's pairwise
    sums) and by the binomial location of uniform bits; and the row sums
    of an independent host panel of ``CONFIG4_ROW_SUM_ROWS`` rows, three
    rows brute-checked."""
    from stormtpu_torch import BitMatrix
    from stormtpu_torch.stats import count_row_sums
    from stormtpu_torch.stream import stream_count_histogram

    n, m, sb = _C4_N, _C4_M, _C4_SB
    xd = _config4_operand(4, dev)
    n_bins = 64
    t0 = time.perf_counter()
    man = stream_count_histogram(
        xd, n, m, n_bins=n_bins, superblock_rows=sb, device=dev,
        progress=lambda d, t: (d % 50 == 0 or d == t)
        and log(f"  [config4/hist] stripe {d}/{t}"),
    )
    dt_hist = time.perf_counter() - t0
    bw = man["bin_width"]
    t0 = time.perf_counter()
    man2 = stream_count_histogram(xd, n, m, n_bins=n_bins // 2, bin_width=2 * bw,
                                  superblock_rows=sb, device=dev)
    dt_hist2 = time.perf_counter() - t0
    del xd
    torch.cuda.empty_cache()
    np.testing.assert_array_equal(
        man2["hist"], man["hist"][0::2] + man["hist"][1::2],
        err_msg="doubled-bin-width cross-check: the two walks disagree",
    )
    # C[ij] ~ Binomial(m, 1/4) on uniform bits: the mass sits in the two
    # bins around 250k, split as the normal model says
    mu, sigma = m / 4, math.sqrt(m * 3 / 16)
    pairs = n * (n - 1) // 2

    def cdf(x):
        return 0.5 * (1 + math.erf((x - mu) / (sigma * math.sqrt(2))))

    for b in range(n_bins):
        p = cdf((b + 1) * bw) - cdf(b * bw)
        got = man["hist"][b] / pairs
        assert abs(got - p) < 0.02, (b, got, p)
    log(f"[config4] 100k×1M histogram on {dev.type}: {dt_hist:.2f} s "
        f"(+{dt_hist2:.2f} s doubled-width cross-check), mass + cross-sum + "
        f"binomial location verified")

    rs_n = CONFIG4_ROW_SUM_ROWS
    w = -(-m // 32)
    packed = _random_packed(rs_n, w, seed=104)
    bm = BitMatrix.from_packed(packed, m_bits=m)
    t0 = time.perf_counter()
    sums = count_row_sums(bm, device=dev)
    dt_rs = time.perf_counter() - t0
    rng = np.random.default_rng(41)
    for r in map(int, rng.integers(0, rs_n, 3)):
        acc = 0
        for c0 in range(0, rs_n, 8192):
            acc += int(np.bitwise_count(packed[c0 : c0 + 8192] & packed[r]).sum(dtype=np.int64))
        assert sums[r] == acc, r
    log(f"[config4] {rs_n}×1M row sums (column counts on {dev.type}, host bit planes): "
        f"{dt_rs:.2f} s, 3 rows brute-verified")
    return {"hist_seconds": dt_hist, "hist_crosscheck_seconds": dt_hist2,
            "hist_n_bins": n_bins,
            "hist_verified": "mass+doubled-width-cross-sum+binomial-location",
            "row_sums_rows": rs_n, "row_sums_seconds": dt_rs,
            "row_sums_verified": "3 rows brute popcount"}


def config4_mxu_stream(full: bool, log, device) -> dict:
    """Tiled XXᵀ on (100k if full else 8k) × 1M bits through the K2
    superblock stripes to disk (B:10), one stripe sampled against numpy;
    on the card also the full-scale rate, checksum walk and aggregate
    sinks at 100,000 × 1,000,000 bits."""
    from stormtpu_torch import BitMatrix
    from stormtpu_torch.stream import stream_count_matrix, stripe_path

    dev = torch.device(device)
    n = 100_000 if full else 8_192
    m = 1_000_000
    w = -(-m // 32)
    packed = _random_packed(n, w, seed=104)
    bm = BitMatrix.from_packed(packed, m_bits=w * 32)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        manifest = stream_count_matrix(bm, d, superblock_rows=4096, kernel="mxu", device=dev)
        dt = time.perf_counter() - t0
        with np.load(stripe_path(d, 0, manifest["n_super"] - 1)) as z:
            stripe = z["counts"]
        rng = np.random.default_rng(104)
        sb = manifest["superblock_rows"]
        base_j = (manifest["n_super"] - 1) * sb
        for _ in range(512):
            i = int(rng.integers(0, min(sb, n)))
            j = int(rng.integers(base_j, n))
            assert stripe[i, j - base_j] == int(np.bitwise_count(packed[i] & packed[j]).sum())
    del bm, packed, stripe
    pairs = n * (n + 1) / 2
    log(f"[config4] {n}×1M K2 streamed ({manifest['n_super']} superblocks) sampled exact; "
        f"{dt:.2f} s → {pairs / dt / 1e6:.2f} M-pairs/s (upload, K2, download, "
        f"compressed stripe files)")
    result = {"config": 4, "n": n, "m_bits": m, "exact_sampled": True,
              "seconds": dt, "pairs_per_s": pairs / dt}
    if dev.type == "cuda":
        result.update(_config4_spec_rate(log, dev))
        result["full_stream"] = _config4_full_stream(log, dev)
        result["aggregate_stats"] = _config4_aggregate_stats(log, dev)
    return result


#: config 5's scaled size, the JAX package's: rows × bits
CONFIG5_SCALED = (2_048, 65_536)


def config5_multihost(full: bool, log, device) -> dict:
    """Multi-host row-sharded all-pairs with a collective merge (B:11), over
    every rank of this process's group (scaled: ``CONFIG5_SCALED``; one card
    gives a one-rank ring)."""
    from stormtpu_torch.kernels import count_block_auto
    from stormtpu_torch.parallel import distributed_count_matrix, make_row_mesh
    from stormtpu_torch.parallel.allpairs import ring_count_rows
    from stormtpu_torch.parallel.mesh import local_shard
    from stormtpu_torch.utils import round_up
    from stormtpu_torch.utils.profiling import timeit_sustained_auto

    n = 1_000_000 if full else CONFIG5_SCALED[0]
    m = CONFIG5_SCALED[1]
    packed = _random_packed(n, m // 32, seed=105)
    mesh = make_row_mesh(device=device)
    t0 = time.perf_counter()
    got = distributed_count_matrix(packed, mesh=mesh)
    dt = time.perf_counter() - t0
    _sample_verify(lambda ii, jj: got[ii, jj], packed, n, 2048, seed=105)
    pairs = float(n) * n
    # the ring alone, on shards already on the device: the trend number
    axis = mesh.axis_names[0]
    r = mesh.shape[axis]
    n_loc = round_up(max(n, r), r * 8) // r
    i = mesh.axis_index(axis)
    rows = (i * n_loc, (i + 1) * n_loc)
    xs = [local_shard(packed if s == 0 else _random_packed(n, m // 32, seed=500 + s), rows,
                      (0, m // 32), mesh.device) for s in range(3)]
    ring = ring_count_rows(mesh, axis, n_loc, count_block_auto)
    dt_s = timeit_sustained_auto(ring, xs)
    log(f"[config5] {n} rows over a {r}-rank ring ({mesh.backend}) sampled-exact; "
        f"{dt:.3f} s → {pairs / dt / 1e6:.1f} M-pairs/s wall, sustained "
        f"{pairs / dt_s / 1e6:.1f} M-pairs/s")
    return {"config": 5, "n": n, "devices": mesh.size, "exact_sampled": True,
            "seconds": dt, "pairs_per_s": pairs / dt, "latency_bound": not full,
            "sustained_pairs_per_s": pairs / dt_s,
            "note": "seconds is one call (shards up, the ring, the gather to every "
            "rank); sustained_pairs_per_s times this rank's ring alone on shards "
            "already on its device; a scaling figure needs ranks on distinct cards "
            "(parallel.measure_scaling)"}


CONFIGS = {
    1: config1_single_pair,
    2: config2_allpairs_dense,
    3: config3_sparse,
    4: config4_mxu_stream,
    5: config5_multihost,
}


def _device_stamp(dev: torch.device) -> dict:
    """The device's name and power limit (``nvidia-smi``), which every
    time in an entry depends on."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={torch.cuda.current_device() if dev.index is None else dev.index}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = None
    return {"device": torch.cuda.get_device_name(dev), "power_limit": out}


def run_acceptance(
    configs: Optional[list[int]] = None,
    full: bool = False,
    log=print,
    out_path: str = "acceptance.json",
    *,
    device=None,
) -> list[dict]:
    """Run the requested configs (default 1–5) on ``device`` (``None``: the
    card; under ``torchrun`` this rank's card) and MERGE their entries into
    ``out_path``: entries of configs not run this time are kept. Returns the
    entries run this time."""
    from stormtpu_torch.parallel.mesh import rank_device

    dev = rank_device(device)
    unknown = [c for c in configs or () if c not in CONFIGS]
    if unknown:
        raise ValueError(f"unknown acceptance config(s) {unknown}; want 1-5")
    stamp = _device_stamp(dev)
    log(f"[accept] {stamp['device']}, power limit {stamp['power_limit']}")
    ran: dict[int, dict] = {}
    for cid in configs or sorted(CONFIGS):
        t0 = time.perf_counter()
        ran[cid] = {**CONFIGS[cid](full, log, dev), **stamp}
        ran[cid]["wall_seconds"] = time.perf_counter() - t0
    merged: dict[int, dict] = {}
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                for entry in json.load(f):
                    if isinstance(entry, dict) and "config" in entry:
                        merged[int(entry["config"])] = entry
        except (ValueError, OSError):  # unreadable: overwrite
            merged = {}
    merged.update(ran)
    with open(out_path, "w") as f:
        json.dump([merged[k] for k in sorted(merged)], f, indent=2)
    log(f"wrote {out_path}")
    return [ran[k] for k in sorted(ran)]
