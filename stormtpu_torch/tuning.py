"""Measured dispatch crossovers and the K4 cost model (port of
``stormtpu/tuning.py``).

``tune`` measures the four exact dense strategies on one device over a grid
of (N, M) buckets (the plain int8 product only up to
``kernels.plain_product_max_bits``, above which D1 never takes it) and
writes pairs/s per bucket to a JSON cache; D1
(``dispatch.dense_strategy``) and the streamed walks
(``stream._auto_stream_kernel``) then take the winner of the bucket nearest
in log space to the call's shape: the fastest, but K2 unless another is
faster by more than :data:`K2_MARGIN`, where the JAX package takes the
fastest. Tuning is explicit (``python -m stormtpu_torch tune``). Without a cache that names this device, both take
the untuned rule: the plain int8 product up to
``kernels.plain_product_max_bits`` (0 on a card, so K2 at every M; the JAX
package's static constant on the CPU). The choice never changes a count: every
strategy gives the same exact matrix.

The cache is the file named by ``$STORMTPU_TORCH_TUNING_CACHE``, else
``~/.cache/stormtpu_torch/tuning.json``, else (unless the variable pins a
path) the snapshot ``stormtpu_torch/data/tuning_snapshot.json`` that the
package ships. A cache applies only to the device whose name its ``device``
field holds (``torch.cuda.get_device_name`` for a card, ``"cpu"`` for the
CPU). The JSON layout is the JAX package's (``device``, ``grid``,
``buckets.*.dense_pairs_per_s``, ``latency_bound``, ``dispatch_floor_s``,
``k4_cost_model``).

The K4 cost model weighs K4 against the dense K2 walk on the card
(``dispatch.k4_estimates``, ``stream._SparseStripePlan``). Each constant
is that of K4's route on the device it is measured for: on a card K4's
CUDA kernels (``kernels/csrc/k4_sparse.cu``), on the CPU the C++ host
tier. :func:`refit_k4_constants` measures each as follows; without a cache
for the device, :data:`K4_DEFAULTS` (the same measurements, made once on
an NVIDIA H100 80GB HBM3 at 700 W and its host by
``scripts/torch_k4_constants.py``; PERF.md §6) stand, the CPU's cost model
included (it only picks a stripe's kind, never a count):

- ``c_sort_s_per_nnz``: the (column, row) list a nonzero, at 10,000 × 2²⁰
  bits, density 1e-3: on a card the COO's upload and the keys' sort,
  de-duplication and runs there (``kernels.sparse._k4_sorted_rows``); on
  the CPU the sort-based unique (``kernels.sparse.unique_int64``) of
  random int64 keys;
- ``c_n2_s_per_elem``: K4's N² int32 output at n = 10,000, an entry: on a
  card zeroed, mirrored (``kernels.sparse.k4_mirror``) and downloaded; on
  the CPU allocated and mirrored;
- ``c_stripe_n2_s_per_elem``: a streamed walk's K4 stripe kept on the card,
  an entry of the same N² output: zeroed, mirrored and compacted to its
  nonzeros (``torch.nonzero``), by CUDA events (least of three); on the CPU
  as ``c_n2_s_per_elem``, which the CPU's stripes read;
- ``c_emit_s_per_emission``: an emission at 10,000 × 2²⁰ bits, density
  1e-3: on a card the emission kernel alone (CUDA events, least of three);
  on the CPU an end-to-end host K4 run (least of two), its remainder after
  the sort and N² terms over its emissions;
- ``c_emit_host_s_per_emission``: that host rate, measured on either
  device and read on a card only: there the few-emission stripes
  (``_SparseStripePlan.stripe_coo``) and the streamed queries'
  zero-intersection staircases run on the host beside K4's kernels. On
  the CPU every emission is the host's and ``c_emit_s_per_emission``
  prices them all, as the JAX package's cost model does; without a CPU
  cache the card's constants price both sides there, K2 too, so the CPU
  picks the stripe kinds the card would;
- ``c_download_s_per_elem``: an N² int32 matrix's download into page-locked
  memory (``utils.download``), an entry (0 on the CPU); K2's estimate
  carries it as K4's does;
- ``c_k2_host_s_per_word``: the K2 call's host work on its operand, a
  packed word: the compaction scan (``packed.any(axis=0)``) and the upload;
- ``k2_int8_ops_per_s``: n²·M over the K2 triangular kernel's time, from
  the best ``pallas_mxu`` bucket;
- ``dispatch_floor_s``: the wall time of a warm ``pallas_mxu`` call whose
  kernel does almost nothing (256 × 2²⁰ bits);
- ``h2d_bytes_per_s``: one superblock slice (4096 × 32,768 words) through
  the streamed walk's ``_SliceBuffer`` (the copy into its pinned buffer
  and the upload).

The density order of the streamed queries (``stream._RowOrder``) prices
each stripe of a mixed-density panel with four more, measured on a panel
of four superblocks of ``slice_rows`` rows (two of 16 random set bits a
row, one of density 1/32, one of 1/2) in that order, each the least of
three walls with the device synchronised:

- ``c_k2_stripe_s_per_op``: an off-diagonal K2 stripe on the resident
  operand (``stream._compute_stripe``), a bit pair (sb²·M of them);
- ``c_k4_stripe_s``: K4's stripe between the two rare superblocks (its
  zeroed buffer, the columns they share, the launch; a few emissions);
- ``c_k4_gather_s_per_elem``: K4's stripe between a rare superblock and the
  one of density 1/32, less the above and its emissions, over the
  elements of the other side's bits it gathers at the rare side's columns
  (sb a column);
- ``c_k4_gather_s_per_position``: the same against the superblock of
  density 1/2, less the above, its emissions and its gathered elements,
  over the set bits found there.
"""

from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "CACHE_ENV",
    "DEFAULT_GRID",
    "K4_DEFAULTS",
    "cache_path",
    "device_name",
    "k4_constants",
    "k4_cost_model",
    "load_tuning",
    "measured_dense_winner",
    "refit_k4_constants",
    "tune",
    "tuned_variant",
]

CACHE_ENV = "STORMTPU_TORCH_TUNING_CACHE"
_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "stormtpu_torch", "tuning.json"
)
#: the last full-grid tune on the card, shipped with the package
_SNAPSHOT_CACHE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "tuning_snapshot.json"
)

_DENSE_PATHS = ("popcount", "mxu", "pallas_dense", "pallas_mxu")

# (N, m_bits) buckets: small N, tensor-core shapes and long K
DEFAULT_GRID: tuple[tuple[int, int], ...] = (
    (256, 8192), (256, 65536), (256, 1048576),
    (4096, 8192), (4096, 65536), (4096, 1048576),
    (16384, 8192), (16384, 65536), (16384, 1048576),
)

K4_DEFAULTS = {
    "c_sort_s_per_nnz": 3.42e-9,
    "c_n2_s_per_elem": 7.96e-11,
    "c_stripe_n2_s_per_elem": 1.46e-11,
    "c_emit_s_per_emission": 7.07e-11,
    "c_emit_host_s_per_emission": 1.55e-8,
    "c_download_s_per_elem": 7.84e-11,
    "c_k2_host_s_per_word": 1.44e-9,
    "k2_int8_ops_per_s": 6.56e15,
    "dispatch_floor_s": 0.00995,
    "h2d_bytes_per_s": 6.50e9,
    "c_k2_stripe_s_per_op": 3.48e-16,
    "c_k4_stripe_s": 6.23e-4,
    "c_k4_gather_s_per_elem": 2.13e-11,
    "c_k4_gather_s_per_position": 1.66e-10,
}


def cache_path() -> str:
    return os.environ.get(CACHE_ENV, _DEFAULT_CACHE)


def load_tuning() -> Optional[dict]:
    """The cache as a dict, or None when unreadable. A path pinned by
    ``$STORMTPU_TORCH_TUNING_CACHE`` opts out of the snapshot."""
    try:
        with open(cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        pass
    if os.environ.get(CACHE_ENV):
        return None
    try:
        with open(_SNAPSHOT_CACHE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_name(device=None) -> Optional[str]:
    """The name a cache's ``device`` field must hold to apply to ``device``
    (``None``: the card): the card's ``torch.cuda.get_device_name``, or
    ``"cpu"``; None when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return _cuda_name(torch.cuda.current_device() if dev.index is None else dev.index)


def _device_tuning(device=None) -> Optional[dict]:
    name = device_name(device)
    if name is None:
        return None
    t = load_tuning()
    if not isinstance(t, dict) or t.get("device") != name:
        return None
    return t


def tuned_variant(kernel: str, default: str) -> str:
    """``default``: the port has one tile body, so there is no variant to
    tune (the JAX package measures two Pallas bodies)."""
    del kernel
    return default


def _bucket_key(n: int, m_bits: int) -> str:
    return f"{n}x{m_bits}"


#: a strategy displaces K2 only when measured this much faster than it. K1
#: runs K2's tile body: in two tunes on an NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md §6) the two traded places at 16384 x 2^20 bits (K1 0.945x and
#: 1.046x K2), K1's own rate moving 11% between the runs.
K2_MARGIN = 1.2


def _winner(rates: dict) -> Optional[str]:
    """The fastest strategy of ``rates`` (pairs/s), K2 (``pallas_mxu``)
    where none beats it by more than :data:`K2_MARGIN`."""
    if not rates:
        return None
    best = max(rates, key=rates.get)
    k2 = rates.get("pallas_mxu", 0.0)
    return "pallas_mxu" if k2 > 0 and rates[best] <= K2_MARGIN * k2 else best


def measured_dense_winner(
    n: Optional[int] = None, m_bits: Optional[int] = None, device=None
) -> Optional[str]:
    """The winning dense strategy (:func:`_winner`) of the cached bucket
    nearest (n, m_bits) in log space, if ``device`` is tuned; None
    otherwise. Without a shape, of each strategy's best over every bucket;
    a single-shape cache of the JAX package's first format (top-level
    ``dense_pairs_per_s``) is read as it is."""
    t = _device_tuning(device)
    if not t:
        return None
    buckets = t.get("buckets")
    if not buckets:
        return _winner(t.get("dense_pairs_per_s", {}))
    if n is None or m_bits is None:
        agg: dict[str, float] = {}
        for b in buckets.values():
            for k, v in b.get("dense_pairs_per_s", {}).items():
                agg[k] = max(agg.get(k, 0.0), v)
        return _winner(agg)

    def dist(key: str) -> float:
        bn, bm = key.split("x")
        return abs(math.log(max(n, 1) / int(bn))) + abs(
            math.log(max(m_bits, 1) / int(bm))
        )

    keys = [k for k in buckets if buckets[k].get("dense_pairs_per_s")]
    if not keys:
        return None
    return _winner(buckets[min(keys, key=dist)]["dense_pairs_per_s"])


def k4_cost_model(device=None) -> Optional[dict]:
    """The cache's fitted K4 constants for ``device`` (``None``: the card),
    or None when it is not tuned."""
    t = _device_tuning(device)
    return t.get("k4_cost_model") if t else None


def k4_constants(device=None) -> dict:
    """K4 cost-model constants: the cache's for ``device`` where it has
    them, :data:`K4_DEFAULTS` elsewhere (a copy: callers may not change
    them)."""
    out = dict(K4_DEFAULTS)
    out.update(k4_cost_model(device) or {})
    return out


# ------------------------------------------------------------------ measuring
def _least(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wgmma_b1_ops_per_s(device) -> float:
    """Operations a second (2 a MAC) of the b1 ``wgmma`` that K2's tile
    body issues, measured back to back on every SM (``kernels.tc_rate``):
    the roofline the tuner holds every measured rate to."""
    from stormtpu_torch.kernels import tc_rate

    return 2.0 * tc_rate.issue_rate(tc_rate.KINDS["wgmma_b1_n256"], device)["macs_per_s"]


def _dispatch_floor(dev: torch.device, n: int, m_bits: int) -> float:
    """Least wall seconds of a warm ``pallas_mxu`` call of n × m_bits
    random bits (its kernel does almost nothing at n = 256)."""
    from stormtpu_torch.api import intersect_count_matrix
    from stormtpu_torch.layout import BitMatrix

    rng = np.random.default_rng(5)
    bm = BitMatrix.from_packed(
        rng.integers(0, 1 << 32, size=(n, -(-m_bits // 32)), dtype=np.uint32),
        -(-m_bits // 32) * 32)

    def call():
        intersect_count_matrix(bm, strategy="pallas_mxu", device=dev)
        _sync(dev)

    call()
    return _least(call, 5)


def _plain_product_fits(dev: torch.device, n: int, m_bits: int) -> bool:
    """Whether ``count_block_int8_xla``'s unpacked operands fit: on the card
    its transients (two int32 shift planes and the int8 operands, about
    10 bytes a bit of a row, and the int32 result) within 80% of free
    memory; on the CPU always (the tuner keeps it below the JAX package's
    static ceiling there)."""
    if dev.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(dev)
    return 10 * n * m_bits + 4 * n * n <= 0.8 * free


def _tune_shape(
    n: int, m_bits: int, reps: int, slow_path_budget_s: float, log, *,
    device, expect: Optional[dict] = None, peak_ops_per_s: Optional[float] = None,
) -> dict:
    """Measure every dense strategy at one shape on ``device``; check each
    against the NumPy oracle on its leading 128 × 128 block; return the
    bucket dict. ``expect`` maps a strategy to the best pair-bits a second
    measured so far: a candidate whose one call it puts above
    ``slow_path_budget_s`` is skipped before it is launched."""
    from stormtpu_torch.config import default_config
    from stormtpu_torch.kernels import plain_product_max_bits
    from stormtpu_torch.kernels import xla as kx
    from stormtpu_torch.kernels.dense import count_tiles_pallas_dense, k1_tile_shape
    from stormtpu_torch.kernels.mxu import (
        _pad,
        count_tiles_pallas_mxu,
        device_tile_ids,
        k2_tile_shape,
    )
    from stormtpu_torch.oracle import oracle_count_block
    from stormtpu_torch.utils import round_up, triangular_tile_ids
    from stormtpu_torch.utils.profiling import timeit_chain, timeit_sustained_auto

    dev = torch.device(device)
    expect = expect if expect is not None else {}
    cfg = default_config()
    w = -(-m_bits // 32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    xds = [torch.randint(-(1 << 31), 1 << 31, (n, w), dtype=torch.int32, device=dev,
                         generator=gen) for _ in range(reps + 1)]
    nc = min(n, 128)
    head = xds[0][:nc].cpu().numpy().view(np.uint32)
    want = oracle_count_block(head, head)
    # unique pairs a second for every candidate (the square paths compute
    # both halves for the same result)
    tri = n * (n + 1) / 2
    work = tri * m_bits

    rates: dict[str, float] = {}
    latency_bound: list[str] = []
    skipped: list[str] = []
    suspect: list[str] = []

    def roofline_ok(rate: float) -> bool:
        # 2·M operations a unique pair: every candidate does at least that
        return peak_ops_per_s is None or rate * 2.0 * m_bits <= peak_ops_per_s * 1.05

    def measure(name, f, xs, block):
        rate0 = expect.get(name)
        if rate0 and work / rate0 > slow_path_budget_s:
            skipped.append(name)
            log(f"  {name}: skipped (about {work / rate0:.1f} s a call at the best rate "
                f"measured so far)")
            return
        got = block(f(xs[0]))[:nc, :nc].cpu().numpy()
        if not np.array_equal(got.astype(np.int64), want):
            raise AssertionError(f"tuning candidate {name} is INEXACT at {n} x {m_bits}")
        t1 = timeit_chain(f, xs[:2], 1)
        if t1 > slow_path_budget_s:
            rates[name] = tri / t1
            latency_bound.append(name)
            log(f"  {name}: {rates[name]:,.0f} pairs/s (one call, {t1:.2f} s)")
        else:
            rate = tri / timeit_sustained_auto(f, xs)
            if not roofline_ok(rate):
                again = tri / timeit_sustained_auto(f, xs)
                log(f"  {name}: {rate:,.0f} pairs/s is above the b1 wgmma rate; "
                    f"re-measured {again:,.0f}")
                rate = min(rate, again)
                if not roofline_ok(rate):
                    suspect.append(name)
            rates[name] = rate
            log(f"  {name}: {rate:,.0f} pairs/s")
        expect[name] = max(expect.get(name, 0.0), rates[name] * m_bits)

    measure("popcount", lambda x: kx.count_block_popcount_xla(x, x, tile_rows=8), xds,
            lambda out: out)
    if m_bits > plain_product_max_bits(dev):
        # D1 turns an "mxu" winner above this ceiling into K2: never taken
        skipped.append("mxu")
        log(f"  mxu: skipped (above the plain product's ceiling, "
            f"{plain_product_max_bits(dev)} bits, on this device)")
    elif _plain_product_fits(dev, n, m_bits):
        measure("mxu", lambda x: kx.count_block_int8_xla(x, x), xds, lambda out: out)
    else:
        skipped.append("mxu")
        log("  mxu: skipped (its unpacked operands do not fit)")

    def tile_candidate(name, count_tiles, ti, wk):
        n_pad, w_pad = round_up(n, ti), round_up(w, wk)
        xps = [_pad(x, n_pad, w_pad) for x in xds]
        nb = n_pad // ti
        ids = device_tile_ids(*triangular_tile_ids(nb), nb, dev)
        measure(name, lambda x: count_tiles(x, *ids, tile_rows=ti, tile_words=wk,
                                            checked=ids), xps, lambda out: out[0])

    tile_candidate("pallas_dense", count_tiles_pallas_dense, *k1_tile_shape(cfg, n, w))
    tile_candidate("pallas_mxu", count_tiles_pallas_mxu, *k2_tile_shape(cfg, n, w))
    del xds
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"dense_pairs_per_s": rates, "latency_bound": latency_bound, "skipped": skipped}
    if suspect:
        out["roofline_suspect"] = suspect
    return out


#: the refit's probe sizes (the module docstring's)
K4_PROBE = {"sort_keys": 4_000_000, "n": 10_000, "m_bits": 1 << 20, "density": 1e-3,
            "slice_rows": 4096}
#: the dispatch-floor probe's (rows, bits)
FLOOR_SHAPE = (256, 1 << 20)


def refit_k4_constants(log=print, *, device=None, seed: int = 7) -> Optional[dict]:
    """Measure the K4 constants of the module docstring that belong to K4's
    route, the host and the transfers on ``device``, at the sizes of
    :data:`K4_PROBE`; None when the C++ host tier is not built (its host
    rate cannot be measured then). ``k2_int8_ops_per_s`` and
    ``dispatch_floor_s`` come from :func:`tune`."""
    from stormtpu_torch import native
    from stormtpu_torch.kernels import sparse as ksp
    from stormtpu_torch.layout import BitMatrix, to_device_words
    from stormtpu_torch.stream import _SliceBuffer
    from stormtpu_torch.utils import download, resolve_device

    if not native.have_native():
        return None
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sort_keys, n, m_bits, density, slice_rows = (
        K4_PROBE[k] for k in ("sort_keys", "n", "m_bits", "density", "slice_rows"))
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**62, sort_keys, dtype=np.int64)
    c_sort_host = _least(lambda: ksp.unique_int64(keys), 3) / keys.size
    del keys

    def n2_buffer():
        native.mirror_upper_native(np.zeros((n, n), dtype=np.int32))

    c_n2_host = _least(n2_buffer, 3) / (n * n)

    k = int(n * m_bits * density)
    rows, cols = rng.integers(0, n, k), rng.integers(0, m_bits, k)
    bm = BitMatrix.from_positions(rows, cols, n, m_bits)
    # exact emissions: a column with occ distinct rows emits occ·(occ+1)/2
    _, occ = ksp.unique_int64(ksp.unique_int64(cols * n + rows) // n, presorted=True,
                              return_counts=True)
    occ = occ.astype(np.int64)
    emissions = int((occ * (occ + 1) // 2).sum())
    host_s = _least(lambda: ksp.count_matrix_sparse_outer(bm, device="cpu"), 2)
    c_emit_host = max(host_s - c_sort_host * bm.nnz - c_n2_host * n * n, 0.0) / max(emissions, 1)
    probe = {"sort_keys": sort_keys, "n": n, "m_bits": m_bits, "density": density,
             "nnz": k, "emissions": emissions, "host_k4_s": host_s,
             "slice_bytes": slice_rows * (-(-m_bits // 32)) * 4}

    if on_card:
        def card_sort():
            cols_d, rows_d = ksp._k4_sorted_rows(bm, dev)
            ksp.k4_runs(cols_d)
            _sync(dev)

        card_sort()
        c_sort = _least(card_sort, 3) / bm.nnz
        cols_d, rows_d = ksp._k4_sorted_rows(bm, dev)
        off, lens = ksp.k4_runs(cols_d)
        pairs = int((lens * (lens - 1) // 2).sum())
        prefix = ksp._emission_prefix(lens * (lens - 1) // 2)
        diag = torch.from_numpy(bm.row_nnz.astype(np.int32)).to(dev)
        out = torch.zeros((n, n), dtype=torch.int32, device=dev)
        # a stripe's life on the card: zeroed, emitted into, mirrored and
        # compacted to its nonzeros; the emission and the rest timed apart
        emit_s = stripe_s = float("inf")
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            out.zero_()
            ev[1].record()
            ksp.k4_emit(rows_d, rows_d, off, lens, off, lens, prefix, out, triangle=True)
            ev[2].record()
            ksp.k4_mirror(out, diag)
            torch.nonzero(out)
            ev[3].record()
            torch.cuda.synchronize(dev)
            emit_s = min(emit_s, ev[1].elapsed_time(ev[2]) * 1e-3)
            rest_ms = ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3])
            stripe_s = min(stripe_s, rest_ms * 1e-3)
        c_emit = emit_s / max(pairs, 1)
        c_stripe_n2 = stripe_s / (n * n)
        del cols_d, rows_d, off, lens, prefix

        def n2_card():
            out.zero_()
            ksp.k4_mirror(out, diag)
            download(out)

        n2_card()
        c_n2 = _least(n2_card, 3) / (n * n)
        download(out)
        c_download = _least(lambda: download(out), 3) / (n * n)
        del out, diag
        probe.update(card_pairs=pairs, card_emit_s=emit_s)
    else:
        c_sort, c_n2, c_emit, c_download = c_sort_host, c_n2_host, c_emit_host, 0.0
        c_stripe_n2 = c_n2_host

    def k2_host():
        bm.packed.any(axis=0)
        to_device_words(bm.packed, dev)
        _sync(dev)

    c_k2_host = _least(k2_host, 2) / bm.packed.size
    del bm, rows, cols

    w_slice = -(-m_bits // 32)
    words = np.full((3 * slice_rows, w_slice), 0x5A5A5A5A, dtype=np.uint32)
    slices = _SliceBuffer(BitMatrix.from_packed(words, w_slice * 32), slice_rows, w_slice, dev)
    turn = iter([1, 2] * 4)

    def upload():
        slices.load(1, next(turn))
        _sync(dev)

    upload()
    h2d = slice_rows * w_slice * 4 / _least(upload, 4)
    del slices, words
    order_fit = _order_constants(dev, slice_rows, m_bits, rng, c_emit)
    probe.update(order_fit.pop("probe"))
    fitted = {
        "c_sort_s_per_nnz": c_sort,
        "c_n2_s_per_elem": c_n2,
        "c_stripe_n2_s_per_elem": c_stripe_n2,
        "c_emit_s_per_emission": c_emit,
        "c_emit_host_s_per_emission": c_emit_host,
        "c_download_s_per_elem": c_download,
        "c_k2_host_s_per_word": c_k2_host,
        "h2d_bytes_per_s": h2d,
        **order_fit,
        "probe": probe,
    }
    log(f"k4 refit on {dev.type}: sort {c_sort:.3e} s/nnz, n2 {c_n2:.3e} s/entry (a "
        f"stripe's {c_stripe_n2:.3e}), emit "
        f"{c_emit:.3e} s/emission; host emit {c_emit_host:.3e} s/emission ({emissions} "
        f"emissions in {host_s:.3f} s), download {c_download:.3e} s/entry, K2 host "
        f"{c_k2_host:.3e} s/word, upload {h2d / 1e9:.2f} GB/s; density order: K2 stripe "
        f"{order_fit['c_k2_stripe_s_per_op']:.3e} s/op, K4 stripe "
        f"{order_fit['c_k4_stripe_s']:.3e} s, gather "
        f"{order_fit['c_k4_gather_s_per_elem']:.3e} s/elem, "
        f"{order_fit['c_k4_gather_s_per_position']:.3e} s/bit found")
    return fitted


def _order_constants(dev: torch.device, sb: int, m_bits: int, rng, c_emit: float) -> dict:
    """The density order's constants (module docstring) at ``sb`` rows a
    superblock and ``m_bits`` bits, K4's emissions at ``c_emit`` a one."""
    from stormtpu_torch.config import default_config
    from stormtpu_torch.layout import BitMatrix
    from stormtpu_torch.stream import _auto_stream_kernel, _compute_stripe, _hold, _RowOrder
    from stormtpu_torch.utils import round_up

    cfg = default_config()
    ti, wk = cfg.k2_tile_rows, cfg.k2_tile_words
    sb = round_up(sb, ti)
    w = -(-m_bits // 32)
    packed = np.zeros((4 * sb, w), dtype=np.uint32)
    ones = rng.integers(0, m_bits, (2 * sb, 16))
    np.bitwise_or.at(packed, (np.arange(2 * sb)[:, None], ones >> 5),
                     np.left_shift(np.uint32(1), (ones & 31).astype(np.uint32)))
    for g, ands in ((2, 5), (3, 1)):  # densities 1/32 and 1/2
        words = rng.integers(0, 2**32, (ands, sb, w), dtype=np.uint64).astype(np.uint32)
        packed[g * sb : (g + 1) * sb] = np.bitwise_and.reduce(words, axis=0)
    del words
    bm = BitMatrix.from_packed(packed, w * 32)
    order_ids = np.arange(4 * sb)
    xp = bm.device_ordered2d(order_ids, 4 * sb, round_up(w, wk), device=dev)
    held, _ = _hold(xp, sb, bm.m_bits, w, 2)
    order = _RowOrder(bm, order_ids, xp, held, np.ones((4, 4), dtype=bool), sb)
    kernel = _auto_stream_kernel(bm.m_bits, bm.n, dev)

    def k2():
        _compute_stripe(xp, 0, 3, sb // ti, ti, wk, kernel)
        _sync(dev)

    def k4(j):
        order.stripe_counts(0, j)
        _sync(dev)

    def gathered(j):
        """(elements gathered, set bits found, emissions) of stripe (0, j)."""
        a = held[0]
        q = order._gathered(j, a.cols_u)[1]
        return sb * a.cols_u.numel(), int(q.sum()), int((a.runs_at(a.cols_u)[1] * q).sum())

    for f in (k2, lambda: k4(1), lambda: k4(2), lambda: k4(3)):
        f()
    k2_s = _least(k2, 3)
    k4_s = _least(lambda: k4(1), 3)
    sparse_s, dense_s = _least(lambda: k4(2), 3), _least(lambda: k4(3), 3)
    elems, found_s, emit_s = gathered(2)
    _, found_d, emit_d = gathered(3)
    c_gather = max(sparse_s - k4_s - c_emit * emit_s, 0.0) / elems
    c_found = max(dense_s - k4_s - c_emit * emit_d - c_gather * elems, 0.0) / found_d
    return {"c_k2_stripe_s_per_op": k2_s / (sb * sb * bm.m_bits),
            "c_k4_stripe_s": k4_s,
            "c_k4_gather_s_per_elem": c_gather,
            "c_k4_gather_s_per_position": c_found,
            "probe": {"order_k2_stripe_s": k2_s, "order_k4_stripe_s": k4_s,
                      "order_gather_stripe_s": [sparse_s, dense_s],
                      "order_gathered": elems, "order_found": [found_s, found_d],
                      "order_emissions": [emit_s, emit_d]}}


def tune(
    n: Optional[int] = None,
    m_bits: Optional[int] = None,
    reps: int = 3,
    log=print,
    shapes: Optional[Sequence[tuple[int, int]]] = None,
    slow_path_budget_s: float = 3.0,
    *,
    device=None,
    peak_ops_per_s: Optional[float] = None,
) -> dict:
    """Measure the dense strategies over the shape grid on ``device``
    (``None``: the card), re-fit the K4 constants, and write the cache
    after every bucket. An explicit ``(n, m_bits)`` tunes that shape only
    and merges it into a grid cache of the same device; the default is
    :data:`DEFAULT_GRID`. Buckets run from the least work up, so that each
    candidate's slow-path test reads the rates measured before it. On the
    card every rate is held to the b1 ``wgmma`` rate (``peak_ops_per_s``,
    measured when not given); a kernel that fails to build or launch
    raises."""
    from stormtpu_torch.utils import resolve_device

    if (n is None) != (m_bits is None):
        raise ValueError("tune: pass both n and m_bits, or neither (the full grid)")
    dev = resolve_device(device)
    name = device_name(dev)
    if shapes is not None:
        grid = [tuple(g) for g in shapes]
    elif n is not None:
        grid = [(n, m_bits)]
    else:
        grid = list(DEFAULT_GRID)
    if peak_ops_per_s is None and dev.type == "cuda":
        peak_ops_per_s = wgmma_b1_ops_per_s(dev)
    if peak_ops_per_s is not None:
        log(f"[tune] {name}: b1 wgmma rate {peak_ops_per_s:.4g} op/s")

    prev = load_tuning()
    same = prev if isinstance(prev, dict) and prev.get("device") == name else {}
    prev_k4 = same.get("k4_cost_model")
    prev_buckets = dict(same.get("buckets") or {})
    prev_grid = [tuple(g) for g in same.get("grid", [])]
    expect: dict[str, float] = {}
    for key, b in prev_buckets.items():
        bm_bits = int(key.split("x")[1])
        for k, v in b.get("dense_pairs_per_s", {}).items():
            expect[k] = max(expect.get(k, 0.0), v * bm_bits)

    floor_s = _dispatch_floor(dev, *FLOOR_SHAPE)
    log(f"[tune] warm pallas_mxu call at {FLOOR_SHAPE[0]} x {FLOOR_SHAPE[1]} bits: "
        f"{floor_s * 1e3:.3f} ms")
    buckets: dict[str, dict] = {}

    def assemble() -> dict:
        single = len(grid) == 1
        grid_out = list(grid) + [g for g in prev_grid if single and g not in grid]
        result = {
            "device": name,
            "grid": [list(g) for g in grid_out],
            "buckets": {**prev_buckets, **buckets} if single else dict(buckets),
            "dispatch_floor_s": floor_s,
            "torch": torch.__version__,
        }
        if peak_ops_per_s is not None:
            result["peak_ops_per_s"] = peak_ops_per_s
        if prev_k4 is not None:
            result["k4_cost_model"] = prev_k4
        if single and buckets:
            # a single-shape run keeps the first format's top-level fields
            only = buckets[_bucket_key(*grid[0])]
            result["dense_pairs_per_s"] = only["dense_pairs_per_s"]
            result["shape"] = {"n": grid[0][0], "m_bits": grid[0][1]}
        return result

    def write(result: dict) -> str:
        path = cache_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=2)
        os.replace(tmp, path)
        return path

    for gn, gm in sorted(grid, key=lambda g: g[0] * g[0] * g[1]):
        t0 = time.perf_counter()
        log(f"[tune] shape {gn} x {gm} bits")
        b = _tune_shape(gn, gm, reps, slow_path_budget_s, log, device=dev, expect=expect,
                        peak_ops_per_s=peak_ops_per_s)
        b["seconds"] = time.perf_counter() - t0
        buckets[_bucket_key(gn, gm)] = b
        log(f"[tune] {gn} x {gm}: winner {_winner(b['dense_pairs_per_s'])}; "
            f"{b['seconds']:.2f} s")
        write(assemble())

    result = assemble()
    k2_ops = max((b["dense_pairs_per_s"].get("pallas_mxu", 0.0) * 2 * int(key.split("x")[1])
                  for key, b in result["buckets"].items()), default=0.0)
    k4 = refit_k4_constants(log, device=dev)
    if k4 is not None:
        if k2_ops > 0:
            k4["k2_int8_ops_per_s"] = k2_ops
        k4["dispatch_floor_s"] = floor_s
        result["k4_cost_model"] = k4
    log(f"wrote {write(result)}")
    return result
