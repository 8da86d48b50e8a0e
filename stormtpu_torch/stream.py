"""Streaming all-pairs walk with checkpoint/resume (port of
``stormtpu/stream.py``).

For large N the N×N count matrix cannot be one array (100k rows → 40 GB of
int32), so results are produced as **superblock stripes** written to disk
one by one, keyed by (row superblock, column superblock). A re-run resumes
at stripe granularity by skipping the stripe files that exist.

Output format, shared with the JAX package file for file (a directory
half written by one package is resumed, loaded and extended by the other):
one ``stripe_{I:05d}_{J:05d}.npz`` per superblock pair (upper triangle
only; mirror at read time) plus ``manifest.json``. A dense stripe holds
``counts, i, j``; a clustered one its visited tiles ``tiles, loc_i,
loc_j, i, j``; a ``sparse_outer`` walk's K4 stripe its nonzero counts
``coo_i, coo_j, coo_v, i, j``.

On the card a stripe's tiles come from the hand-written kernels through
their wrappers (K2 for ``kernel="mxu"``, K1 for ``"dense"``, K5 for
``"clustered"``), the stripe is assembled there and downloaded once; the
tile ids and work lists are checked on the host before their upload, so
nothing is read back from the card between a stripe's launch and its
download. ``kernel="sparse_outer"`` decides each stripe between K4 on the
host (the C++ tier) and the K2 walk on the card. Every entry point takes ``device=None`` (the card;
``RuntimeError`` without one) or ``device="cpu"``, where each wrapper
takes its plain version.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import json
import os
import zlib
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from stormtpu_torch import native
from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels.sparse import unique_int64
from stormtpu_torch.layout import BitMatrix, to_device_words
from stormtpu_torch.utils import (
    assemble_stripe,
    assemble_stripe_torch,
    download,
    profiling,
    resolve_device,
    round_up,
    triangular_tile_ids,
)
from stormtpu_torch.utils.profiling import StageTimes, record_stages  # noqa: F401

__all__ = [
    "stream_count_matrix",
    "stream_count_checksums",
    "stream_count_checksums_clustered",
    "stream_count_histogram",
    "extend_streamed_matrix",
    "load_streamed_matrix",
    "stripe_path",
    "require_device_budget",
    "record_stages",
]

# Stripe files are written on background threads while the walk goes on
# (``_StripeWriter``): at most this many at once, holding at most this many
# bytes of finished stripes between them.
_WRITERS = 4
_WRITE_AHEAD_BYTES = 1 << 30

_STREAM_KERNELS = ("mxu", "dense", "xla_int8", "xla_popcount", "clustered", "sparse_outer")


def stripe_path(out_dir: str, i: int, j: int) -> str:
    return os.path.join(out_dir, f"stripe_{i:05d}_{j:05d}.npz")


def _content_fingerprint(bm: BitMatrix, n: Optional[int] = None) -> str:
    """Cheap content key for resume/extend directories: shape alone is
    not identity (a regenerated same-shape matrix must NOT silently
    reuse stale stripes). Row popcounts catch any bit-count change; the
    boundary-row CRCs catch same-popcount edits at the ends. Not
    cryptographic — a safety net, not a proof. ``n``: the key of the first
    ``n`` rows alone (an extend's head), read in place."""
    import zlib

    n = bm.n if n is None else n
    row_nnz = bm.row_nnz[:n]
    h = zlib.crc32(np.ascontiguousarray(row_nnz).tobytes())
    if n:
        h = zlib.crc32(np.ascontiguousarray(bm.packed[0]).tobytes(), h)
        h = zlib.crc32(np.ascontiguousarray(bm.packed[n - 1]).tobytes(), h)
    return f"{int(row_nnz.sum())}-{h:08x}"


# ------------------------------------------------------------ device budgets
def _device_refuse_budget(device) -> int:
    """Bytes a single-shot route may allocate on ``device``.

    On a card: what CUDA reports free plus what PyTorch's caching
    allocator holds but does not use (``torch.cuda.mem_get_info`` and the
    allocator's counters). On the CPU: the host's physical memory.
    ``STORMTPU_DEVICE_REFUSE_BUDGET_BYTES`` overrides both (the same
    variable the JAX package reads)."""
    env = os.environ.get("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES")
    if env:
        return int(env)
    dev = torch.device(device)
    if dev.type == "cuda":
        profiling.count("mem_queries")
        free, _total = torch.cuda.mem_get_info(dev)
        idle = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        return int(free + idle)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def require_device_budget(
    need_bytes: int, what: str, hint: str, device="cuda"
) -> None:
    """Refuse a device route whose footprint cannot fit on ``device``
    with ``ValueError`` (instead of an opaque mid-call out-of-memory)."""
    budget = _device_refuse_budget(device)
    if need_bytes > budget:
        raise ValueError(
            f"{what} (~{need_bytes / (1 << 30):.1f} GiB) exceeds the "
            f"device budget ({budget / (1 << 30):.1f} GiB); {hint}"
        )


def _device_operand_budget(device, working: int = 0) -> int:
    """Bytes a walk's whole padded operand may take on ``device`` before
    the walk keeps only two superblock slices there: what
    :func:`_device_refuse_budget` reads, less ``working`` (the bytes a
    stripe needs beside the operand). ``STORMTPU_DEVICE_OPERAND_BUDGET_BYTES``
    (the variable the JAX package reads) instead sets a ceiling for the
    operand alone."""
    env = os.environ.get("STORMTPU_DEVICE_OPERAND_BUDGET_BYTES")
    if env:
        return int(env)
    return _device_refuse_budget(device) - working


def _wants_operand_streaming(n_pad: int, w_pad: int, sb: int, device) -> bool:
    """Whether the walk should keep only two superblock slices on the
    device: when the padded operand and a stripe's working set (its tile
    stack, the assembled stripe, two slices) pass what the device has
    free."""
    working = 4 * (2 * sb * sb + 2 * sb * w_pad)
    return 4 * n_pad * w_pad > _device_operand_budget(device, working)


# ------------------------------------------------------------- stage timing
# The recorder lives in ``utils.profiling``; these are the names the walks
# and their callers use.
_stage = functools.partial(profiling.stage, "stream")
_span = profiling.span
_route = profiling.route
_count_stripe = profiling.count_stripe


# ------------------------------------------------------------- host helpers
def default_hist_bin_width(m_bits: int, n_bins: int) -> int:
    """Uniform bin width covering [0, m_bits] in ``n_bins`` (a pair
    count can equal m_bits)."""
    return max(1, -(-(m_bits + 1) // n_bins))


def cap_hist_superblock(sb: int, unit: int) -> int:
    """Largest multiple of ``unit`` ≤ ``sb`` whose square stays below
    2³¹ (the JAX package's histogram sinks hold a stripe's bin partials
    in int32, and the port keeps its geometry). Raises when ``unit``
    itself is too large to satisfy the bound."""
    cap = (46340 // unit) * unit  # floor(sqrt(2^31 − 1)) = 46340
    if cap <= 0:
        raise ValueError(
            f"histogram stripe unit {unit} already exceeds the int32 "
            f"pair-count bound (unit² ≥ 2³¹) — use fewer row shards or "
            f"the ring route"
        )
    return min(max(sb, unit), cap)


def _host_superblock(
    packed: np.ndarray, n: int, superblock_rows: int, w_pad: int, i: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Zero-padded host slice [superblock_rows, w_pad] of row-superblock
    ``i`` of a packed uint32 [n, W] matrix, written into ``out`` (every
    element of it) when given."""
    if out is None:
        out = np.empty((superblock_rows, w_pad), dtype=np.uint32)
    r0 = i * superblock_rows
    k = max(0, min(n, r0 + superblock_rows) - r0)
    w = packed.shape[1]
    out[:k, :w] = packed[r0 : r0 + k]
    out[:k, w:] = 0
    out[k:] = 0
    return out


def _superblock_pairs(n_super: int) -> Iterator[tuple[int, int]]:
    for i in range(n_super):
        for j in range(i, n_super):
            yield i, j


def _stripe_tile_ids(tps: int, diagonal: bool) -> tuple[np.ndarray, np.ndarray]:
    """Local tile coordinates int32 of a stripe's tile list: the upper
    triangle of a diagonal stripe, the whole tps × tps grid otherwise."""
    if diagonal:
        return triangular_tile_ids(tps)
    loc_i, loc_j = np.meshgrid(
        np.arange(tps, dtype=np.int32), np.arange(tps, dtype=np.int32), indexing="ij"
    )
    return loc_i.ravel(), loc_j.ravel()


def _auto_stream_kernel(m_bits: int, n: Optional[int] = None, device=None) -> str:
    """The dense stripe kernel ``auto`` starts from: the tuned dense winner
    of the bucket nearest (n, m_bits) on ``device`` (``None``: the card)
    mapped to a stripe kernel, else the untuned rule of
    ``dispatch.dense_strategy``. The plain forms unpack 8× operands or
    broadcast a whole stripe, so they serve small M only
    (``kernels.plain_product_max_bits``)."""
    from stormtpu_torch.kernels import plain_product_max_bits
    from stormtpu_torch.tuning import measured_dense_winner

    winner = measured_dense_winner(n, m_bits, device)
    small_m = m_bits <= plain_product_max_bits(device)
    if winner is None:
        return "xla_int8" if small_m else "mxu"
    if winner in ("mxu", "pallas_mxu"):
        return "xla_int8" if (winner == "mxu" and small_m) else "mxu"
    return "xla_popcount" if (winner == "popcount" and small_m) else "dense"


def _resolve_stream_kernel(bm: BitMatrix, kernel: str, cfg: EngineConfig,
                           device=None) -> str:
    """The streaming walk's kernel-resolution policy on ``device``,
    factored out so callers that must PREDICT the geometry
    (``extend_streamed_matrix``) resolve identically to the walk itself."""
    if kernel == "auto":
        if (bm.n >= 2 and bm.density < cfg.sparse_density_threshold
                and native.have_native()):
            # the per-superblock inverted-index walk; checked before the
            # clustered skip, as D1 checks it: a stripe where K4 loses
            # takes the dense walk anyway
            kernel = "sparse_outer"
        else:
            kernel = _auto_stream_kernel(bm.m_bits, bm.n, device)
            # summary-AND skip at streaming scale: when most (tile pair,
            # K-group) cells are co-empty the work-list stripes win by about
            # 1/fraction over any dense stripe walk — the single-matrix
            # dispatch's statistic
            from stormtpu_torch.kernels.clustered import clustered_work_fraction

            wf = clustered_work_fraction(bm, cfg)
            if wf is not None and wf < cfg.clustered_work_fraction_threshold:
                kernel = "clustered"
    if kernel not in _STREAM_KERNELS:
        # an unknown string would silently run the K1 branch
        raise ValueError(
            f"unknown kernel {kernel!r}; want 'auto' or one of "
            f"('mxu', 'dense', 'xla_int8', 'xla_popcount', 'clustered', "
            f"'sparse_outer')"
        )
    return kernel


def _stream_tile_modulus(kernel: str, cfg: EngineConfig) -> int:
    """The row modulus a resolved stream kernel rounds superblock_rows
    to (mxu/clustered/sparse_outer tile by k2 rows; dense and the xla_*
    whole-stripe forms by k1 rows)."""
    if kernel in ("mxu", "clustered", "sparse_outer"):
        return cfg.k2_tile_rows
    return cfg.k1_tile_rows


def _save_stripe(path: str, compress: bool, members: dict) -> None:
    """Write a stripe file so that it appears only complete."""
    tmp = path + ".tmp.npz"
    (np.savez_compressed if compress else np.savez)(tmp, **members)
    os.replace(tmp, path)


class _StripeWriter:
    """The walk's sink: saves stripe files on ``_WRITERS`` background
    threads, so that the next stripe's upload and kernel run while the last
    ones are written (the write, and zlib when ``compress`` is on, release
    the interpreter lock). Stripes complete in the walk's order: the
    manifest's ``completed`` list and the ``progress`` calls keep the order
    and the meaning they have in an in-order walk (a stripe counts once its
    file is in place). At most ``_WRITE_AHEAD_BYTES`` of finished stripes
    wait at a time; the walk blocks in :meth:`save` beyond that. Leaving
    the context waits for every write, so no thread outlives the walk."""

    def __init__(self, manifest: dict, total: int, compress: bool,
                 progress: Optional[Callable[[int, int], None]]):
        self.manifest, self.total, self.compress, self.progress = (
            manifest, total, compress, progress)
        self.done = 0
        self.held = 0       # bytes of the stripes waiting to be written
        self.writing = 0    # stripes handed to the threads and not yet completed
        self.pending: collections.deque = collections.deque()
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_WRITERS, thread_name_prefix="stripe-save")

    def __enter__(self) -> "_StripeWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            while self.pending:
                try:
                    self._complete_oldest()
                except Exception:
                    if exc_type is None:
                        raise
                    # the walk already failed: its error is the one reported
        finally:
            self.pool.shutdown(wait=True)

    def _complete_oldest(self) -> None:
        i, j, future, nbytes = self.pending.popleft()
        self.held -= nbytes
        if future is not None:
            self.writing -= 1
            future.result()
        self.manifest["completed"].append([i, j])
        self.done += 1
        if future is not None and self.progress is not None:
            self.progress(self.done, self.total)

    def _oldest_is_done(self) -> bool:
        future = self.pending[0][2]
        return future is None or future.done()

    def resumed(self, i: int, j: int) -> None:
        """Stripe (i, j) was found on disk: it completes in its turn."""
        self.pending.append((i, j, None, 0))
        while self.pending and self._oldest_is_done():
            self._complete_oldest()

    def save(self, path: str, **members) -> None:
        """Write stripe (``members["i"]``, ``members["j"]``) to ``path``."""
        nbytes = sum(getattr(m, "nbytes", 0) for m in members.values())
        while self.pending and (
            self.writing >= _WRITERS
            or self.held + nbytes > _WRITE_AHEAD_BYTES
            or self._oldest_is_done()
        ):
            self._complete_oldest()
        future = self.pool.submit(_save_stripe, path, self.compress, members)
        self.writing += 1
        self.pending.append((members["i"], members["j"], future, nbytes))
        self.held += nbytes
        if profiling.synchronised():  # a recorded walk takes its stages in order
            while self.pending:
                self._complete_oldest()


def _wrap_int32(x: int) -> int:
    """``x`` reduced to int32's range as two's-complement addition wraps
    it: the JAX package sums a stripe's checksum in int32."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


# --------------------------------------------------------- operand streaming
class _SliceBuffer:
    """The two superblock slices operand streaming keeps on the device,
    as ONE [2·SB, w_pad] buffer: the i slice lives in its first half
    across its row of stripes, the j slice is copied into the second, and
    an off-diagonal stripe's tile walk runs on the whole buffer with local
    ids (no concatenation a stripe). On the card each half has a pinned
    staging buffer, reused for the whole walk; a staging buffer is refilled
    only after its last copy to the card has completed."""

    def __init__(self, bm: BitMatrix, sb: int, w_pad: int, dev: torch.device):
        self.bm, self.sb, self.dev = bm, sb, dev
        self.buf = torch.zeros((2 * sb, w_pad), dtype=torch.int32, device=dev)
        self.loaded = [-1, -1]
        self.staging: list = [None, None]
        self.copied: list = [None, None]

    def load(self, half: int, i: int) -> None:
        """Row superblock ``i`` into half ``half`` (0: the i slice)."""
        if self.loaded[half] == i:
            return
        sb = self.sb
        dst = self.buf[half * sb : (half + 1) * sb]
        if self.dev.type == "cpu":
            host = dst
        else:
            if self.staging[half] is None:
                profiling.count("pinned_allocs")
                self.staging[half] = torch.empty(dst.shape, dtype=torch.int32, pin_memory=True)
            else:
                with profiling.wait("staging"):
                    self.copied[half].synchronize()
            host = self.staging[half]
        _host_superblock(self.bm.packed, self.bm.n, sb, dst.shape[1], i,
                         out=host.numpy().view(np.uint32))
        if host is not dst:
            profiling.count("h2d_bytes", dst.numel() * 4)
            dst.copy_(host, non_blocking=True)
            self.copied[half] = torch.cuda.Event()
            self.copied[half].record()
        self.loaded[half] = i

    def stripe_operand(self, i: int, j: int) -> torch.Tensor:
        """Upload what stripe (i, j) needs and return its operand: the
        first half for a diagonal stripe, else the whole buffer."""
        with _stage("upload", self.dev):
            self.load(0, i)
            if i != j:
                self.load(1, j)
        return self.buf[: self.sb] if i == j else self.buf


# ------------------------------------------------------------- dense stripes
def _tile_wrapper(kernel: str):
    if kernel == "mxu":
        from stormtpu_torch.kernels.mxu import count_tiles_pallas_mxu as count_tiles
    else:
        from stormtpu_torch.kernels.dense import count_tiles_pallas_dense as count_tiles
    return count_tiles


def _tile_stripe(
    x: torch.Tensor, ibs: np.ndarray, jbs: np.ndarray, loc_i: np.ndarray, loc_j: np.ndarray,
    tps: int, tile_rows: int, tile_words: int, kernel: str, diagonal: bool,
) -> torch.Tensor:
    """The [SB, SB] stripe on ``x``'s device from the tile kernel's tiles
    for row-block pairs (ibs, jbs) of ``x``, placed at (loc_i, loc_j)."""
    from stormtpu_torch.kernels.mxu import device_tile_ids

    dev = x.device
    with _stage("plan", dev):
        ids = device_tile_ids(ibs, jbs, x.shape[0] // tile_rows, dev)
    with _stage("kernel", dev):
        tiles = _tile_wrapper(kernel)(
            x, *ids, tile_rows=tile_rows, tile_words=tile_words, checked=ids
        )
    with _stage("assembly", dev):
        return assemble_stripe_torch(tiles, loc_i, loc_j, tps, tile_rows, diagonal)


def _block_stripe(xi: torch.Tensor, xj: torch.Tensor, kernel: str) -> torch.Tensor:
    from stormtpu_torch.kernels import xla as kx

    with _stage("kernel", xi.device):
        if kernel == "xla_int8":
            return kx.count_block_int8_xla(xi, xj)
        return kx.count_block_popcount_xla(xi, xj)


def _compute_stripe(
    xp: torch.Tensor,
    sb_i: int,
    sb_j: int,
    tiles_per_super: int,
    tile_rows: int,
    tile_words: int,
    kernel: str,
) -> torch.Tensor:
    """Counts int32 [SB, SB], on ``xp``'s device, for superblock pair
    (sb_i, sb_j) of the padded packed matrix, from the tile kernels' pair
    lists (or a whole-stripe plain form for the xla_* choices)."""
    if kernel in ("xla_int8", "xla_popcount"):
        sb = tiles_per_super * tile_rows
        return _block_stripe(
            xp[sb_i * sb : (sb_i + 1) * sb], xp[sb_j * sb : (sb_j + 1) * sb], kernel
        )
    loc_i, loc_j = _stripe_tile_ids(tiles_per_super, sb_i == sb_j)
    return _tile_stripe(
        xp, loc_i + sb_i * tiles_per_super, loc_j + sb_j * tiles_per_super, loc_i, loc_j,
        tiles_per_super, tile_rows, tile_words, kernel, sb_i == sb_j,
    )


def _compute_stripe_pair(
    x: torch.Tensor,
    tiles_per_super: int,
    tile_rows: int,
    tile_words: int,
    kernel: str,
) -> torch.Tensor:
    """Operand-streaming twin of ``_compute_stripe``: the stripe of what
    ``_SliceBuffer.stripe_operand`` returned — one slice [SB, w_pad] (its
    diagonal stripe) or the two-slice buffer [2·SB, w_pad] (first half
    against second, with local tile ids). Nothing else of the matrix is on
    the device."""
    tps = tiles_per_super
    sb = tps * tile_rows
    diagonal = x.shape[0] == sb
    if kernel in ("xla_int8", "xla_popcount"):
        return _block_stripe(x[:sb], x[:sb] if diagonal else x[sb:], kernel)
    loc_i, loc_j = _stripe_tile_ids(tps, diagonal)
    jbs = loc_j if diagonal else loc_j + tps
    return _tile_stripe(x, loc_i, jbs, loc_i, loc_j, tps, tile_rows, tile_words, kernel,
                        diagonal)


def stream_count_matrix(
    bm: BitMatrix,
    out_dir: str,
    *,
    superblock_rows: int = 4096,
    kernel: str = "mxu",
    config: Optional[EngineConfig] = None,
    resume: bool = True,
    compress: bool = True,
    operand_streaming: Optional[bool] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """Compute all upper-triangular superblock stripes of the count matrix,
    writing each to ``out_dir`` as it completes. Returns the manifest.

    ``resume=True`` skips stripes whose file already exists (resume at
    stripe granularity after interruption).

    ``kernel``: ``"mxu"`` (K2), ``"dense"`` (K1), ``"xla_int8"`` /
    ``"xla_popcount"`` (plain whole-stripe forms, small M), ``"clustered"``
    (K5 work lists; stripe files hold only the visited tiles),
    ``"sparse_outer"`` (K4 or the K2 walk, chosen per stripe;
    needs the C++ tier, else ``RuntimeError``) or ``"auto"``.

    ``operand_streaming`` (default auto): when the padded packed matrix and
    a stripe's working set do not fit the device, keep only two superblock
    slices there per stripe, so N is bounded by host memory. Upload volume
    is one row superblock per stripe (the i slice is reused across its row
    of stripes): about N²·W·4 / (2·superblock_rows) bytes in all — pick
    large superblocks to amortize.
    """
    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    kernel = _resolve_stream_kernel(bm, kernel, cfg, dev)
    if kernel == "sparse_outer":
        if not native.have_native():
            raise RuntimeError(
                "kernel='sparse_outer' needs the native C++ tier "
                f"(stormtpu_torch/native did not build: {native.native_build_error()})"
            )
        return _stream_sparse_outer(
            bm, out_dir, superblock_rows=superblock_rows, config=cfg,
            resume=resume, compress=compress, progress=progress, device=dev,
        )
    if kernel == "clustered":
        return _stream_clustered(
            bm, out_dir, superblock_rows=superblock_rows, config=cfg,
            resume=resume, compress=compress,
            operand_streaming=operand_streaming, progress=progress, device=dev,
        )
    tile_rows = cfg.k2_tile_rows if kernel == "mxu" else cfg.k1_tile_rows
    tile_words = cfg.k2_tile_words if kernel == "mxu" else cfg.k1_tile_words
    superblock_rows = round_up(superblock_rows, tile_rows)
    tiles_per_super = superblock_rows // tile_rows

    n_pad = round_up(bm.n, superblock_rows)
    w_pad = round_up(bm.n_words, tile_words)
    if operand_streaming is None:
        operand_streaming = _wants_operand_streaming(n_pad, w_pad, superblock_rows, dev)
    n_super = n_pad // superblock_rows

    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "n": bm.n,
        "content": _content_fingerprint(bm),
        "m_bits": bm.m_bits,
        "superblock_rows": superblock_rows,
        "n_super": n_super,
        "kernel": kernel,
        "operand_streaming": bool(operand_streaming),
        "completed": [],
    }
    total = n_super * (n_super + 1) // 2
    # the operand goes up lazily: a fully resumed run uploads nothing
    xp = slices = None
    with _StripeWriter(manifest, total, compress, progress) as writer:
        for i, j in _superblock_pairs(n_super):
            path = stripe_path(out_dir, i, j)
            if resume and os.path.exists(path):
                writer.resumed(i, j)
                continue
            if operand_streaming:
                if slices is None:
                    slices = _SliceBuffer(bm, superblock_rows, w_pad, dev)
                stripe_d = _compute_stripe_pair(
                    slices.stripe_operand(i, j), tiles_per_super, tile_rows, tile_words, kernel
                )
            else:
                if xp is None:
                    from stormtpu_torch.kernels.clustered import padded_operand

                    with _stage("upload", dev):
                        xp = padded_operand(bm, n_pad, w_pad, dev)
                stripe_d = _compute_stripe(
                    xp, i, j, tiles_per_super, tile_rows, tile_words, kernel
                )
            with _stage("download", dev):
                stripe = download(stripe_d)
            with _stage("save", dev):
                writer.save(path, counts=stripe, i=i, j=j)
            del stripe, stripe_d
            _count_stripe(True)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


# --------------------------------------------------------- clustered stripes
def _stripe_occupancy(bm: BitMatrix, cfg: EngineConfig, superblock_rows: int):
    """Geometry of the clustered stripe walks: the per-tile-block K-group
    occupancy padded to whole superblocks (padding rows have zero
    occupancy: never listed, their tiles exactly zero), or None for a
    single K-group."""
    from stormtpu_torch.kernels.clustered import _block_occupancy

    geo = _block_occupancy(bm, cfg)
    if geo is None:
        return None
    occ, ti, wk, _n_pad, nb, ng = geo
    superblock_rows = round_up(superblock_rows, ti)
    n_sb_pad = round_up(bm.n, superblock_rows)
    nb_sb = n_sb_pad // ti
    if nb_sb > nb:
        occ = np.concatenate([occ, np.zeros((nb_sb - nb, ng), dtype=bool)], axis=0)
    # w_pad: a trailing all-zero pad K-group, as the one-matrix K5 operand has
    return occ, ti, wk, ng, superblock_rows, n_sb_pad, (ng + 1) * wk


def _stream_clustered(
    bm: BitMatrix,
    out_dir: str,
    *,
    superblock_rows: int,
    config: EngineConfig,
    resume: bool,
    compress: bool,
    operand_streaming: Optional[bool],
    progress: Optional[Callable[[int, int], None]],
    device: torch.device,
) -> dict:
    """K5 at streaming scale: per-stripe summary-AND work lists over the
    global per-tile-block K-group occupancy. Stripes whose summaries
    co-occupy nothing never touch the device; the rest run only their
    co-occupied (tile pair, K-group) items, and their stripe files store
    only the visited tiles.

    Stripe format: ``tiles`` int32 [n_vis, ti, ti] + local tile coords
    (``loc_i``/``loc_j``); ``load_streamed_matrix`` scatter-assembles.
    Zero stripes write an n_vis=0 file, keeping the resume-by-file
    contract of the dense path.

    ``operand_streaming`` works as in the dense walk (the work list's
    row-block ids shift to the two-slice buffer's frame); summary-zero
    stripes skip the upload too.
    """
    from stormtpu_torch.kernels.clustered import (
        build_stripe_worklist,
        count_tiles_worklist,
        device_worklist,
        padded_operand,
    )

    cfg, dev = config, device
    geo = _stripe_occupancy(bm, cfg, superblock_rows)
    if geo is None:
        # single K-group: nothing to skip — the dense stripe walk is exact
        return stream_count_matrix(
            bm, out_dir, superblock_rows=superblock_rows, kernel="mxu",
            config=cfg, resume=resume, compress=compress,
            operand_streaming=operand_streaming, progress=progress, device=dev,
        )
    occ, ti, wk, ng, superblock_rows, n_sb_pad, w_pad = geo
    tps = superblock_rows // ti
    n_super = n_sb_pad // superblock_rows
    if operand_streaming is None:
        operand_streaming = _wants_operand_streaming(n_sb_pad, w_pad, superblock_rows, dev)

    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "n": bm.n,
        "content": _content_fingerprint(bm),
        "m_bits": bm.m_bits,
        "superblock_rows": superblock_rows,
        "n_super": n_super,
        "kernel": "clustered",
        "tile_rows": ti,
        "operand_streaming": bool(operand_streaming),
        "work_items": 0,
        "completed": [],
    }
    total = n_super * (n_super + 1) // 2
    packed_d = slices = None
    with _StripeWriter(manifest, total, compress, progress) as writer:
        for i, j in _superblock_pairs(n_super):
            path = stripe_path(out_dir, i, j)
            if resume and os.path.exists(path):
                writer.resumed(i, j)
                continue
            with _stage("plan", dev):
                wl = build_stripe_worklist(occ, i * tps, j * tps, tps, i == j)
            if wl is None:
                tiles = np.zeros((0, ti, ti), dtype=np.int32)
                loc_i = loc_j = np.zeros(0, dtype=np.int32)
            else:
                if operand_streaming:
                    # summary-zero stripes never reach this branch, so they
                    # cost no upload either; the i slice persists across its row
                    if slices is None:
                        slices = _SliceBuffer(bm, superblock_rows, w_pad, dev)
                    x = slices.stripe_operand(i, j)
                    shift = dict(ibs_shift=i * tps,
                                 jbs_shift=i * tps if i == j else (j - 1) * tps)
                else:
                    if packed_d is None:
                        with _stage("upload", dev):
                            packed_d = padded_operand(bm, n_sb_pad, w_pad, dev)
                    x, shift = packed_d, {}
                with _stage("plan", dev):
                    work = device_worklist(wl, dev, nb=x.shape[0] // ti, ng=ng + 1,
                                           tile_rows=ti, **shift)
                with _stage("kernel", dev):
                    out = count_tiles_worklist(
                        x, *work, n_slots=wl.n_vis, tile_rows=ti, tile_words=wk,
                        variant=cfg.k2_variant, checked=work,
                    )
                with _stage("download", dev):
                    tiles = download(out)
                loc_i, loc_j = wl.vis_loc_i, wl.vis_loc_j
                manifest["work_items"] += wl.n_work
            with _stage("save", dev):
                writer.save(path, tiles=tiles, loc_i=loc_i, loc_j=loc_j, i=i, j=j)
            del tiles
            _count_stripe(wl is not None)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


# ------------------------------------------------------------ sparse stripes
def _superblock_coo(
    bm: BitMatrix, superblock_rows: int, n_super: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per row superblock I, its set bits as (cols int64, local rows int32)
    sorted by (column, row): the order the C++ run walks need. Duplicates
    are dropped (packing ORs them, so counts must too). One sort of the
    keys (superblock, column, local row) orders every superblock at once;
    the keys come from the ingest-time COO, else from the CSR extraction
    (duplicate-free)."""
    sb, m = superblock_rows, bm.m_bits
    if bm.coo is not None:
        rows, cols = bm.coo
    else:
        indptr, indices = bm.positions_csr()
        rows = np.repeat(np.arange(bm.n, dtype=np.int64), np.diff(indptr))
        cols = indices.astype(np.int64)
    sup = rows // sb
    keys = (sup * m + cols) * sb + (rows - sup * sb)
    keys = unique_int64(keys) if bm.coo is not None else np.sort(keys)
    bounds = np.searchsorted(keys, np.arange(n_super + 1, dtype=np.int64) * m * sb)
    subs = []
    for i in range(n_super):
        k = keys[bounds[i] : bounds[i + 1]]
        subs.append(((k // sb) % m, (k % sb).astype(np.int32)))
    return subs


class _SparseStripePlan:
    """The per-superblock K4 machinery of the ``sparse_outer`` walk: the
    column-sorted sub-COO of each superblock, its column histogram (exact
    emission counts E(I, J)), the cost model's K4-or-dense choice a stripe,
    and K4's evaluation of a stripe into a tensor on the plan's device
    (:meth:`stripe_counts`): on a card by K4's CUDA kernels, on the CPU by
    the C++ run walks; with few emissions by :meth:`stripe_coo` on the
    host."""

    def __init__(self, bm: BitMatrix, superblock_rows: int, n_super: int, device=None):
        from stormtpu_torch.tuning import k4_constants

        self.bm = bm
        self.sb = superblock_rows
        self.dev = resolve_device(device)
        self.subs = _superblock_coo(bm, superblock_rows, n_super)
        self.hists = [unique_int64(cols, presorted=True, return_counts=True)
                      for cols, _ in self.subs]
        self._segment_cache: tuple = (None, None)
        # superblock → (rows int32, local nnz int32) on the card, the two
        # superblocks of the last stripe only
        self._dev_rows: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        fit = k4_constants(device)
        on_card = self.dev.type == "cuda"
        # the constants of K4's route on this device: on a card its kernels
        # (the stripe stays there: no sb² download) and the host's rate for
        # the few-emission path (stripe_coo); on the CPU every emission is
        # the host's, priced by one rate as in the JAX package
        self._c_n2 = fit["c_stripe_n2_s_per_elem" if on_card else "c_n2_s_per_elem"]
        self._c_emit = fit["c_emit_s_per_emission"]
        self._c_emit_host = fit["c_emit_host_s_per_emission" if on_card
                                else "c_emit_s_per_emission"]
        self._sb2 = superblock_rows * superblock_rows
        self._est_dense_s = (
            self._sb2 * bm.m_bits / fit["k2_int8_ops_per_s"] + fit["dispatch_floor_s"]
        )
        # an off-diagonal dense stripe also uploads its j slice (the i slice
        # serves its whole row of stripes)
        self._est_upload_s = superblock_rows * bm.n_words * 4 / fit["h2d_bytes_per_s"]

    def emissions(self, i: int, j: int) -> int:
        """K4's emissions for stripe (i, j) as the cost model counts them:
        Σ_c occ_I(c)·occ_J(c), on the diagonal occ·(occ+1)/2."""
        cu_i, cnt_i = self.hists[i]
        if i == j:
            return int((cnt_i.astype(np.int64) * (cnt_i + 1) // 2).sum())
        cu_j, cnt_j = self.hists[j]
        _, ia, ja = np.intersect1d(cu_i, cu_j, return_indices=True, assume_unique=True)
        return int(cnt_i[ia].astype(np.int64) @ cnt_j[ja])

    def _segments(self, i: int, j: int):
        """(off_a, p, off_b, q): start and length of each shared column's
        row run in the two sub-COO lists (i == j: every occupied column).
        The last stripe's are kept: the walk asks for them up to three
        times a stripe."""
        if self._segment_cache[0] != (i, j):
            self._segment_cache = ((i, j), self._find_segments(i, j))
        return self._segment_cache[1]

    def _find_segments(self, i: int, j: int):
        cols_i, _ = self.subs[i]
        cu_i, cnt_i = self.hists[i]
        off_i = np.searchsorted(cols_i, cu_i).astype(np.int64)
        if i == j:
            return off_i, cnt_i.astype(np.int64), off_i, cnt_i.astype(np.int64)
        cols_j, _ = self.subs[j]
        cu_j, cnt_j = self.hists[j]
        off_j = np.searchsorted(cols_j, cu_j).astype(np.int64)
        _, ia, ja = np.intersect1d(cu_i, cu_j, return_indices=True, assume_unique=True)
        return (off_i[ia], cnt_i[ia].astype(np.int64),
                off_j[ja], cnt_j[ja].astype(np.int64))

    def emissions_square(self, i: int, j: int) -> int:
        """Σ_c p_c·q_c with the diagonal not halved: what
        :meth:`stripe_coo` emits."""
        _, p, _, q = self._segments(i, j)
        return int(p @ q)

    def emission_eligible(self, i: int, j: int) -> bool:
        """Whether stripe (i, j) takes :meth:`stripe_coo` (no sb² buffer):
        its emissions are far below the buffer's size."""
        return self.emissions_square(i, j) * 8 <= self._sb2

    def use_k4(self, i: int, j: int, extra_emissions: int = 0,
               emission_path: bool = False) -> bool:
        """The cost model: K4 (its sb² buffer and its emissions, on the
        card where the walk runs there) against the K2 stripe on the card
        (with the j slice's upload off the diagonal). ``extra_emissions``
        charges the caller's host work a candidate (the streamed queries'
        zero-intersection staircase) at the host's emission rate.
        ``emission_path``: the caller takes :meth:`stripe_coo` for an
        eligible stripe, so no sb² buffer is charged, only the full
        square's emissions that it makes on the host."""
        if emission_path and self.emission_eligible(i, j):
            cost = self._c_emit_host * (self.emissions_square(i, j) + extra_emissions)
        else:
            cost = (self._c_n2 * self._sb2 + self._c_emit * self.emissions(i, j)
                    + self._c_emit_host * extra_emissions)
        return cost < self._est_dense_s + (self._est_upload_s if i != j else 0.0)

    def stripe_coo(self, i: int, j: int):
        """(coo_i, coo_j, coo_v) int32 of stripe (i, j) without the sb²
        buffer: every pair of each shared column's row runs, aggregated by
        one sort (``unique_int64``). A diagonal stripe is the full square
        with the self counts, as the mirrored C++ stripe is."""
        oa, p, ob, q = self._segments(i, j)
        _, rows_i = self.subs[i]
        rows_j = rows_i if i == j else self.subs[j][1]
        pq = p * q
        e_tot = int(pq.sum())
        if e_tot == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z, z
        estart = np.zeros(pq.size + 1, dtype=np.int64)
        np.cumsum(pq, out=estart[1:])
        cid = np.repeat(np.arange(pq.size), pq)
        e = np.arange(e_tot, dtype=np.int64) - estart[cid]
        qq = q[cid]
        a = rows_i[oa[cid] + e // qq].astype(np.int64)
        b = rows_j[ob[cid] + e % qq].astype(np.int64)
        key, counts = unique_int64(a * self.sb + b, return_counts=True)
        return ((key // self.sb).astype(np.int32), (key % self.sb).astype(np.int32),
                counts.astype(np.int32))

    def _rows_on_card(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows int32, per-row nnz int32 [sb]) of superblock i's sub-COO on
        the plan's device, kept for the superblocks of the last stripe."""
        got = self._dev_rows.get(i)
        if got is None:
            rows = self.subs[i][1]
            got = (torch.from_numpy(rows).to(self.dev),
                   torch.from_numpy(np.bincount(rows, minlength=self.sb).astype(np.int32)
                                    ).to(self.dev))
            self._dev_rows[i] = got
        return got

    def _stripe_counts_k4(self, i: int, j: int) -> torch.Tensor:
        """Stripe (i, j) by K4's kernel forms on the plan's device (their
        plain versions on the CPU): the triangle form over the runs of two
        rows or more, mirrored with the rows' nnz on the diagonal, or the
        rectangle form over the shared columns."""
        from stormtpu_torch.kernels.sparse import k4_rect, k4_square

        for k in [k for k in self._dev_rows if k not in (i, j)]:
            del self._dev_rows[k]
        oa, p, ob, q = (torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                        for a in self._segments(i, j))
        rows_i, nnz_i = self._rows_on_card(i)
        if i == j:
            keep = p >= 2
            return k4_square(rows_i, oa[keep].contiguous(), p[keep].contiguous(), self.sb,
                             nnz_i)
        rows_j, _ = self._rows_on_card(j)
        return k4_rect(rows_i, oa, p, rows_j, ob, q, self.sb, self.sb)

    def stripe_counts(self, i: int, j: int) -> torch.Tensor:
        """int32 [sb, sb] local counts of stripe (i, j) on the plan's
        device, a diagonal stripe mirrored to the full square with the rows'
        nnz on its diagonal: on a card from K4's kernels
        (``kernels.sparse.k4_square`` and ``k4_rect`` over
        :meth:`_segments`), on the CPU from the C++ run walks."""
        if self.dev.type == "cuda":
            return self._stripe_counts_k4(i, j)
        cols_i, rows_i = self.subs[i]
        if i == j:
            stripe = native.sparse_outer_runs_native(cols_i, rows_i, self.sb)
            native.mirror_upper_native(stripe)
        else:
            cols_j, rows_j = self.subs[j]
            stripe = native.sparse_outer_runs_cross_native(
                cols_i, rows_i, cols_j, rows_j, self.sb, self.sb)
        return torch.from_numpy(stripe)


def _stripe_nonzeros(stripe: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, values) of a K4 stripe's nonzero counts in row-major
    order, rows and columns int64 as ``np.nonzero`` gives them: the stripe
    is compacted on its device and only the nonzeros come back."""
    with profiling.wait("nonzero"):
        nz = torch.nonzero(stripe)
    vals = stripe[nz[:, 0], nz[:, 1]]
    nz = download(nz)
    return nz[:, 0], nz[:, 1], download(vals)


# ------------------------------------------------------------ density order
# The set bits the density order may hold on the device; the elements of a
# gathered block, and the nonzero words of a held superblock expanded to
# bits, made at a time (each bounds a transient buffer: 256 and 128 MB).
_ORDER_MAX_POSITIONS = 1 << 26
_GATHER_BLOCK = 1 << 26
_EXPAND_WORDS = 1 << 20


def _k2_stripe_s(fit: dict, sb: int, m_bits: int, tps: int, diagonal: bool) -> float:
    """The card's K2 stripe on a resident operand (``c_k2_stripe_s_per_op``
    a bit pair): a diagonal stripe runs the upper triangle of its tiles."""
    t = fit["c_k2_stripe_s_per_op"] * sb * sb * m_bits
    return t * (tps + 1) / (2 * tps) if diagonal else t


def _k4_stripe_s(fit: dict, emissions, gathered=0.0, positions=0.0):
    """K4's stripe on the card: its zeroed buffer, segments and launches
    (``c_k4_stripe_s``), its emissions, and, where the other side is read
    from the operand, the elements gathered at the held side's columns and
    the set bits found there."""
    return (fit["c_k4_stripe_s"] + fit["c_emit_s_per_emission"] * emissions
            + fit["c_k4_gather_s_per_elem"] * gathered
            + fit["c_k4_gather_s_per_position"] * positions)


def _superblock_coo_device(x: torch.Tensor, sb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(columns int64, local rows int32) of the set bits of a superblock's
    words ``x`` (int32 [sb, w] on its device), sorted by (column, row)."""
    r, w = torch.nonzero(x, as_tuple=True)
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    keys = []
    for s in range(0, r.numel(), _EXPAND_WORDS):
        rs, ws = r[s : s + _EXPAND_WORDS], w[s : s + _EXPAND_WORDS]
        k, b = torch.nonzero((x[rs, ws][:, None] >> shifts) & 1, as_tuple=True)
        keys.append((ws[k] * 32 + b) * sb + rs[k])
    key = torch.sort(torch.cat(keys)).values if keys else r
    cols = key // sb
    return cols, (key - cols * sb).to(torch.int32)


class _HeldGroup:
    """A rare superblock of the density order, held on the device as K4
    reads it: its rows in (column, row) order, each column's run (``cnt``
    and ``off``, int32 over every column), its occupied columns, the runs
    of two rows or more (its diagonal stripe), and its rows' counts."""

    def __init__(self, x: torch.Tensor, sb: int, m_bits: int):
        cols, self.rows = _superblock_coo_device(x, sb)
        self.positions = cols.numel()
        cnt = torch.bincount(cols, minlength=m_bits)
        del cols
        off = torch.cumsum(cnt, 0) - cnt
        self.cols_u = torch.nonzero(cnt).squeeze(1)
        runs = self.cols_u[cnt[self.cols_u] >= 2]
        self.run_off, self.run_len = off[runs].contiguous(), cnt[runs].contiguous()
        self.cnt, self.off = cnt.to(torch.int32), off.to(torch.int32)
        self.nnz = torch.bincount(self.rows, minlength=sb).to(torch.int32)

    def runs_at(self, cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(offsets, lengths) int64 of the runs of columns ``cols``."""
        return self.off[cols].long(), self.cnt[cols].long()


def _hold(xp: torch.Tensor, sb: int, m_bits: int, w: int, h: int):
    """The first ``h`` superblocks of the ordered operand ``xp`` held
    (:class:`_HeldGroup`), and K4's exact emissions between them, float64
    [h, h] on the host (a diagonal stripe's Σ p(p−1)/2 over its columns)."""
    held = [_HeldGroup(xp[g * sb : (g + 1) * sb, :w], sb, m_bits) for g in range(h)]
    if not held:
        return held, np.zeros((0, 0))
    hist = torch.stack([g.cnt for g in held]).to(torch.float64)
    exact = download(hist @ hist.T).copy()
    np.fill_diagonal(exact, (np.diag(exact) - [g.positions for g in held]) / 2)
    return held, exact


class _RowOrder:
    """The density order of a streamed query's walk on a mixed-density
    panel: rows sorted by their counts (``perm``: ordered position → the
    caller's row), walked in superblocks of that order on its resident
    operand, the stripes where K4 costs less than the K2 stripe (``k4``)
    answered by K4's kernels from the held rare superblocks (``held``).

    K4's stripe is dense ([sb, sb] int32 on the device, a diagonal one the
    mirrored square with the rows' counts on its diagonal, as a K2 stripe
    is), so the queries reduce it as they reduce a K2 stripe. The other
    side of an off-diagonal stripe is either held too (the runs of the
    columns both share) or read from the operand: its bits at the held
    side's columns, gathered column by column, whose nonzeros come out
    column-sorted."""

    def __init__(self, bm: BitMatrix, perm: np.ndarray, xp: torch.Tensor,
                 held: list, k4: np.ndarray, sb: int):
        self.bm, self.perm, self.xp, self.held, self.k4, self.sb = bm, perm, xp, held, k4, sb

    def stripe_counts(self, i: int, j: int) -> torch.Tensor:
        """int32 [sb, sb] counts of stripe (i, j) (i ≤ j, superblock i held)
        by K4's kernels on the operand's device (their plain versions on
        the CPU)."""
        from stormtpu_torch.kernels.sparse import _emission_prefix, k4_emit, k4_mirror

        sb, a = self.sb, self.held[i]
        out = torch.zeros((sb, sb), dtype=torch.int32, device=self.xp.device)
        if i == j:
            lens = a.run_len
            prefix = _emission_prefix(lens * (lens - 1) // 2)
            k4_emit(a.rows, a.rows, a.run_off, lens, a.run_off, lens, prefix, out,
                    triangle=True)
            k4_mirror(out, a.nnz)
        else:
            if j < len(self.held):
                b = self.held[j]
                with profiling.wait("nonzero"):
                    shared = torch.nonzero((a.cnt > 0) & (b.cnt > 0)).squeeze(1)
                rows_b, (off_b, q) = b.rows, b.runs_at(shared)
            else:
                rows_b, q = self._gathered(j, a.cols_u)
                with profiling.wait("nonzero"):
                    keep = torch.nonzero(q).squeeze(1)
                off_b = (torch.cumsum(q, 0) - q)[keep]
                shared, q = a.cols_u[keep], q[keep]
            off_a, p = a.runs_at(shared)
            prefix = _emission_prefix(p * q)
            k4_emit(a.rows, rows_b, off_a, p, off_b, q, prefix, out, triangle=False)
        if profiling.counting():
            with profiling.wait("read_back"):
                profiling.count("k4_emissions", int(prefix[-1]))
        return out

    def _gathered(self, j: int, cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows int32, run lengths int64 [len(cols)]) of superblock j's set
        bits at the columns ``cols``, column by column, read from the
        operand (its words gathered by column, a block of columns at a
        time)."""
        sb = self.sb
        xj_t = self.xp[j * sb : (j + 1) * sb].T
        words = cols >> 5
        masks = torch.bitwise_left_shift(torch.ones_like(words, dtype=torch.int32),
                                         (cols & 31).to(torch.int32))
        step = max(1, _GATHER_BLOCK // sb)
        rows, runs = [], []
        for u0 in range(0, cols.numel(), step):
            got = (xj_t.index_select(0, words[u0 : u0 + step])
                   & masks[u0 : u0 + step, None]) != 0
            with profiling.wait("nonzero"):
                k, r = torch.nonzero(got, as_tuple=True)
            rows.append(r.to(torch.int32))
            runs.append(torch.bincount(k, minlength=got.shape[0]))
        return torch.cat(rows), torch.cat(runs)


def _order_rows(bm: BitMatrix, sb: int, n_pad: int, w_pad: int, tps: int,
                dev: torch.device, resident: Callable[[], bool]) -> Optional[_RowOrder]:
    """The density order of a walk in superblocks of ``sb`` rows on ``dev``,
    or None where no stripe of it would go to K4, priced with the card's
    K2-stripe and K4 constants (``tuning.k4_constants``).

    The rarest superblocks of the order are held (their set bits taken from
    the ordered operand on the device, within ``_ORDER_MAX_POSITIONS``), in
    order while holding one wins a stripe: its diagonal stripe goes to K4,
    or a stripe with a rarer superblock goes to K4 from both sides' runs
    and would not from the bits gathered at the rarer side's columns; by
    the estimate S_I·S_J/M of the emissions between two superblocks of S_I
    and S_J set bits (S²/(2M) on a diagonal stripe). K4's emissions between
    held superblocks are then exact (their column runs' products); against
    a superblock not held, the estimate stands, with the bits K4 gathers
    from the operand charged. The held superblocks are cached on the matrix
    beside the ordered operand (a BitMatrix does not change once built).
    The first check prices the rarest superblock alone, from the row
    counts, so that a panel where K4 takes nothing pays no sort;
    ``resident`` is asked next (the order needs the whole operand on the
    device)."""
    from stormtpu_torch.tuning import k4_constants

    fit = k4_constants(dev)
    n, m = bm.n, bm.m_bits
    counts = bm.row_nnz
    s0 = float(np.partition(counts, sb - 1)[:sb].sum()) if n > sb else float(counts.sum())
    if not (_k4_stripe_s(fit, s0 * s0 / (2 * m)) < _k2_stripe_s(fit, sb, m, tps, True)
            or _k4_stripe_s(fit, s0 * s0 / m) < _k2_stripe_s(fit, sb, m, tps, False)):
        return None
    if not resident():
        return None
    n_super = n_pad // sb
    with _span("stpu.stream.order", n) as span:
        perm = np.argsort(counts, kind="stable")
        s = np.zeros(n_pad, dtype=np.float64)
        s[:n] = counts[perm]
        s = s.reshape(n_super, sb).sum(axis=1)
        dense = np.full((n_super, n_super), _k2_stripe_s(fit, sb, m, tps, False))
        np.fill_diagonal(dense, _k2_stripe_s(fit, sb, m, tps, True))
        est = np.outer(s, s) / m
        np.fill_diagonal(est, s * s / (2 * m))
        # the held side's occupied columns, at most its set bits, and the
        # other side's set bits found there
        cols = np.minimum(s, m)
        gather = _k4_stripe_s(fit, est, sb * cols[:, None], np.outer(cols, s) / m) < dense
        runs = _k4_stripe_s(fit, est) < dense
        h = 0
        while (h < n_super and s[: h + 1].sum() <= _ORDER_MAX_POSITIONS
               and (runs[h, h] or (runs[:h, h] & ~gather[:h, h]).any())):
            h += 1
        upper = np.triu(np.ones((n_super, n_super), dtype=bool))
        upper[h:] = False
        gathered = np.zeros((n_super, n_super))
        gathered[:h, h:] = sb * cols[:h, None]
        found = np.zeros((n_super, n_super))
        found[:h, h:] = np.outer(cols[:h], s[h:]) / m
        if not (upper & (_k4_stripe_s(fit, est, gathered, found) < dense)).any():
            span.add_ids(0, 0)
            return None
        xp = bm.device_ordered2d(perm, n_pad, w_pad, device=dev)
        key = ("order_held", sb, n_pad, w_pad, zlib.crc32(perm.tobytes()), h)
        held, exact = bm.device_cached(key, lambda: _hold(xp, sb, m, bm.n_words, h), dev)
        est[:h, :h] = exact
        cols = np.array([g.cols_u.numel() for g in held], dtype=np.float64)
        gathered[:h, h:] = sb * cols[:, None]
        found[:h, h:] = np.outer(cols, s[h:]) / m
        k4 = upper & (_k4_stripe_s(fit, est, gathered, found) < dense)
        positions = sum(g.positions for g in held)
        span.add_ids(h, positions)
        profiling.count("order_positions", positions)
    return _RowOrder(bm, perm, xp, held, k4, sb)


def _stripe_kind(path: str) -> str:
    """``"k4"`` or ``"dense"``: a stripe file's kind, from its member list
    (nothing is decompressed)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return "k4" if "coo_i.npy" in zf.namelist() else "dense"


def _stream_sparse_outer(
    bm: BitMatrix,
    out_dir: str,
    *,
    superblock_rows: int,
    config: EngineConfig,
    resume: bool,
    compress: bool,
    progress: Optional[Callable[[int, int], None]],
    device: torch.device,
) -> dict:
    """K4 at streaming scale: each stripe (I, J) is decided by the cost
    model (:class:`_SparseStripePlan`) from its exact emission count. A K4
    stripe is emitted into a superblock² buffer, by K4's kernels on a card
    (only its nonzeros come back) or by the C++ tier on the CPU, or, with
    few emissions, on the host without one, and stores its nonzero counts
    (``coo_i``/``coo_j``/``coo_v``); a dense stripe runs the K2 walk on the
    two superblock slices (``_SliceBuffer``: only they are on the device)
    and stores ``counts``. The single-shot K4's N ≤ 32768 limit does not
    apply: host memory bounds N, as in the other walks. The manifest's
    ``stripe_kernels`` counts the stripes of each kind, resumed ones by
    what their files hold."""
    cfg, dev = config, device
    tile_rows = cfg.k2_tile_rows
    tile_words = cfg.k2_tile_words
    superblock_rows = round_up(superblock_rows, tile_rows)
    tiles_per_super = superblock_rows // tile_rows
    n_super = round_up(bm.n, superblock_rows) // superblock_rows
    w_pad = round_up(bm.n_words, tile_words)
    # the K1 form never serves here: dense stripes share the walk's K2 tiles
    dense_kernel = _auto_stream_kernel(bm.m_bits, bm.n, dev)
    if dense_kernel == "dense":
        dense_kernel = "mxu"

    with _stage("plan", dev):
        plan = _SparseStripePlan(bm, superblock_rows, n_super, dev)

    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "n": bm.n,
        "content": _content_fingerprint(bm),
        "m_bits": bm.m_bits,
        "superblock_rows": superblock_rows,
        "n_super": n_super,
        "kernel": "sparse_outer",
        "stripe_kernels": {"k4": 0, "dense": 0},
        "completed": [],
    }
    total = n_super * (n_super + 1) // 2
    slices = None
    with _StripeWriter(manifest, total, compress, progress) as writer:
        for i, j in _superblock_pairs(n_super):
            path = stripe_path(out_dir, i, j)
            if resume and os.path.exists(path):
                manifest["stripe_kernels"][_stripe_kind(path)] += 1
                writer.resumed(i, j)
                continue
            with _stage("plan", dev):
                k4 = plan.use_k4(i, j, emission_path=True)
            if k4:
                with _stage("k4", dev):
                    if plan.emission_eligible(i, j):
                        nz_i, nz_j, nz_v = plan.stripe_coo(i, j)
                    else:
                        nz_i, nz_j, nz_v = _stripe_nonzeros(plan.stripe_counts(i, j))
                        nz_i, nz_j = nz_i.astype(np.int32), nz_j.astype(np.int32)
                with _stage("save", dev):
                    writer.save(path, coo_i=nz_i, coo_j=nz_j, coo_v=nz_v, i=i, j=j)
                del nz_i, nz_j, nz_v
            else:
                if slices is None:
                    slices = _SliceBuffer(bm, superblock_rows, w_pad, dev)
                stripe_d = _compute_stripe_pair(
                    slices.stripe_operand(i, j), tiles_per_super, tile_rows, tile_words,
                    dense_kernel,
                )
                with _stage("download", dev):
                    stripe = download(stripe_d)
                with _stage("save", dev):
                    writer.save(path, counts=stripe, i=i, j=j)
                del stripe, stripe_d
            manifest["stripe_kernels"]["k4" if k4 else "dense"] += 1
            _count_stripe(not k4)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


# ------------------------------------------------------------ reduced sinks
def _as_device_words(xd, dev: torch.device) -> torch.Tensor:
    """``xd`` as int32 words on ``dev``: a host uint32 array is uploaded,
    a tensor must already be there."""
    if isinstance(xd, np.ndarray):
        return to_device_words(xd, dev)
    if xd.dtype != torch.int32:
        raise TypeError(f"xd: want int32 bit-view words, got {xd.dtype}")
    if xd.device.type != dev.type:
        raise ValueError(f"xd lies on {xd.device}, the walk runs on {dev}")
    return xd


def _sink_geometry(xd: torch.Tensor, n: int, cfg: EngineConfig, superblock_rows: int,
                   histogram: bool = False):
    """Tile geometry of the K2 sinks, with ``xd`` re-padded to it. The
    tile-rows rule is the clustered sink's (``k2_tile_shape``): a stripe's
    checksum is a sum over the LISTED tiles, so the sinks compare only at
    identical tile geometry. The rule can shrink the tile below
    ``k2_tile_rows`` at small n, and the rounded superblock may then not
    divide the caller's padding: zero rows are appended (exact)."""
    tile_rows = min(cfg.k2_tile_rows, round_up(max(n, 32), 32))
    tile_words = cfg.k2_tile_words
    superblock_rows = round_up(superblock_rows, tile_rows)
    if histogram:
        superblock_rows = cap_hist_superblock(superblock_rows, tile_rows)
    n_pad, w_pad = xd.shape
    if w_pad % tile_words:
        raise ValueError("xd must be word-padded to a tile_words multiple")
    if n_pad % superblock_rows:
        grow = round_up(n_pad, superblock_rows) - n_pad
        with _span("stpu.kernels.pad"):
            xd = torch.cat([xd, torch.zeros((grow, w_pad), dtype=xd.dtype, device=xd.device)])
        profiling.count("pad_bytes", xd.numel() * xd.element_size())
        n_pad += grow
    return xd, tile_rows, tile_words, superblock_rows, n_pad // superblock_rows


def _read_back(t: torch.Tensor) -> np.ndarray:
    """A small device result on the host (a pageable copy the host waits
    for); counts ``d2h_bytes``."""
    profiling.count("d2h_bytes", t.numel() * t.element_size())
    with profiling.wait("read_back"):
        return t.cpu().numpy()


def _checksum_and_samples(tiles: torch.Tensor, st, sr, sc) -> tuple[int, np.ndarray]:
    """A stripe's checksum ``sum(tiles % 251)`` wrapped to int32, and the
    sampled entries ``tiles[st, sr, sc]``, in one read-back."""
    dev = tiles.device
    with _stage("reduce", dev):
        idx = profiling.upload(torch.from_numpy(np.stack([st, sr, sc]).astype(np.int64)), dev)
        chk = (tiles % 251).sum(dtype=torch.int64)
        both = torch.cat([chk.reshape(1), tiles[idx[0], idx[1], idx[2]].to(torch.int64)])
    with _stage("read_back", dev):
        host = _read_back(both)
    return _wrap_int32(int(host[0])), host[1:].astype(np.int32)


def stream_count_checksums(
    xd,
    n: int,
    m_bits: int,
    *,
    superblock_rows: int = 4096,
    config: Optional[EngineConfig] = None,
    samples_per_stripe: int = 8,
    sample_seed: int = 0,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """Drive EVERY superblock stripe of the count matrix through the K2
    tile walk on a DEVICE-RESIDENT padded packed matrix, fetching only a
    per-stripe nonlinear checksum plus sampled entries — never the stripes
    themselves: the full-scale validation mode. The compute path is
    ``stream_count_matrix(kernel="mxu")``'s; only the sink differs.
    Returns a manifest with per-stripe checksums and the sampled
    (i, j, count) triples for cross-path verification. A checksum is the
    sum of ``tiles % 251`` over the stripe's listed tiles, wrapped to
    int32 as the JAX package's int32 sum wraps.

    ``xd``: int32 bit-view words [n_pad, w_pad] on the device (or a host
    uint32 array, uploaded), rows ≥ n zero, words beyond ceil(m_bits/32)
    zero, n_pad a multiple of ``superblock_rows`` and w_pad a multiple of
    the K2 tile_words.
    """
    from stormtpu_torch.kernels.mxu import count_tiles_pallas_mxu, device_tile_ids

    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(m_bits)
    xd, tile_rows, tile_words, superblock_rows, n_super = _sink_geometry(
        _as_device_words(xd, dev), n, cfg, superblock_rows
    )
    tiles_per_super = superblock_rows // tile_rows
    nb = xd.shape[0] // tile_rows

    rng = np.random.default_rng(sample_seed)
    stripes = []
    sample_ii: list[np.ndarray] = []
    sample_jj: list[np.ndarray] = []
    sample_vals: list[np.ndarray] = []
    total = n_super * (n_super + 1) // 2
    done = 0
    for i, j in _superblock_pairs(n_super):
        loc_i, loc_j = _stripe_tile_ids(tiles_per_super, i == j)
        ibs = (loc_i + i * tiles_per_super).astype(np.int32)
        jbs = (loc_j + j * tiles_per_super).astype(np.int32)
        # three draws a stripe, in this order: the samples must equal the
        # JAX package's for the same seed
        st = rng.integers(0, ibs.size, samples_per_stripe).astype(np.int32)
        sr = rng.integers(0, tile_rows, samples_per_stripe).astype(np.int32)
        sc = rng.integers(0, tile_rows, samples_per_stripe).astype(np.int32)
        with _stage("plan", dev):
            ids = device_tile_ids(ibs, jbs, nb, dev)
        with _stage("kernel", dev):
            tiles = count_tiles_pallas_mxu(
                xd, *ids, tile_rows=tile_rows, tile_words=tile_words,
                variant=cfg.k2_variant, checked=ids,
            )
        chk, vals = _checksum_and_samples(tiles, st, sr, sc)
        del tiles
        _count_stripe(True)
        stripes.append({"i": i, "j": j, "checksum": chk})
        sample_ii.append(ibs[st] * tile_rows + sr)
        sample_jj.append(jbs[st] * tile_rows + sc)
        sample_vals.append(vals)
        done += 1
        if progress is not None:
            progress(done, total)
    return {
        "n": n,
        "m_bits": m_bits,
        "superblock_rows": superblock_rows,
        "n_super": n_super,
        "kernel": "mxu",
        "sink": "checksum",
        "stripes": stripes,
        "sample_ii": np.concatenate(sample_ii),
        "sample_jj": np.concatenate(sample_jj),
        "sample_vals": np.concatenate(sample_vals),
    }


def stream_count_checksums_clustered(
    bm: BitMatrix,
    *,
    superblock_rows: int = 4096,
    config: Optional[EngineConfig] = None,
    samples_per_stripe: int = 8,
    sample_seed: int = 0,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """The checksum sink for the CLUSTERED stripe walk: every stripe runs
    its summary-AND work list through K5, fetching only a per-stripe
    checksum plus sampled entries. Checksums are comparable to
    ``stream_count_checksums``'s on the same input and superblock size:
    skipped (co-empty) tiles are exactly zero, so they contribute 0 to
    ``sum(tiles % 251)`` either way. Samples are drawn over the FULL local
    tile grid — a sample landing on a skipped tile reports 0 without
    touching the device (that IS the skip's claim; the caller's oracle
    check validates it).
    """
    from stormtpu_torch.kernels.clustered import (
        build_stripe_worklist,
        count_tiles_worklist,
        device_worklist,
        padded_operand,
    )

    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(bm.m_bits)
    geo = _stripe_occupancy(bm, cfg, superblock_rows)
    if geo is None:
        raise ValueError(
            "clustered checksum sink needs >=2 K-groups; use "
            "stream_count_checksums for single-group shapes"
        )
    occ, ti, wk, ng, superblock_rows, n_sb_pad, w_pad = geo
    tps = superblock_rows // ti
    n_super = n_sb_pad // superblock_rows
    packed_d = padded_operand(bm, n_sb_pad, w_pad, dev)

    rng = np.random.default_rng(sample_seed)
    stripes = []
    sample_ii: list[np.ndarray] = []
    sample_jj: list[np.ndarray] = []
    sample_vals: list[np.ndarray] = []
    total = n_super * (n_super + 1) // 2
    done = 0
    work_items = 0
    for i, j in _superblock_pairs(n_super):
        if i == j:
            li, lj = np.triu_indices(tps)
        else:
            li, lj = np.meshgrid(np.arange(tps), np.arange(tps), indexing="ij")
            li, lj = li.ravel(), lj.ravel()
        # samples over the FULL local tile list (skipped tiles included),
        # drawn before the stripe is known to be skipped or not: the order
        # of draws must equal the JAX package's
        st = rng.integers(0, li.size, samples_per_stripe)
        sr = rng.integers(0, ti, samples_per_stripe).astype(np.int32)
        sc = rng.integers(0, ti, samples_per_stripe).astype(np.int32)
        sample_ii.append(((li[st] + i * tps) * ti + sr).astype(np.int64))
        sample_jj.append(((lj[st] + j * tps) * ti + sc).astype(np.int64))

        with _stage("plan", dev):
            wl = build_stripe_worklist(occ, i * tps, j * tps, tps, i == j)
        if wl is None:
            stripes.append({"i": i, "j": j, "checksum": 0, "skipped": True})
            sample_vals.append(np.zeros(samples_per_stripe, dtype=np.int32))
            _count_stripe(False)
            done += 1
            if progress is not None:
                progress(done, total)
            continue
        # map each sampled tile to its slot if visited, else it is an
        # exact zero by the summary argument — no device round trip
        vis_key = wl.vis_loc_i.astype(np.int64) * tps + wl.vis_loc_j
        smp_key = li[st].astype(np.int64) * tps + lj[st]
        slot_idx = np.searchsorted(vis_key, smp_key)
        slot_idx = np.clip(slot_idx, 0, wl.n_vis - 1)
        hit = vis_key[slot_idx] == smp_key
        with _stage("plan", dev):
            work = device_worklist(wl, dev, nb=n_sb_pad // ti, ng=ng + 1, tile_rows=ti)
        with _stage("kernel", dev):
            tiles = count_tiles_worklist(
                packed_d, *work, n_slots=wl.n_vis, tile_rows=ti, tile_words=wk,
                variant=cfg.k2_variant, checked=work,
            )
        chk, vals = _checksum_and_samples(tiles, slot_idx, sr, sc)
        del tiles
        _count_stripe(True)
        vals = np.where(hit, vals, 0).astype(np.int32)
        stripes.append({"i": i, "j": j, "checksum": chk, "skipped": False})
        sample_vals.append(vals)
        work_items += wl.n_work
        done += 1
        if progress is not None:
            progress(done, total)
    return {
        "n": bm.n,
        "m_bits": bm.m_bits,
        "superblock_rows": superblock_rows,
        "n_super": n_super,
        "kernel": "clustered",
        "sink": "checksum",
        "work_items": work_items,
        "stripes": stripes,
        "sample_ii": np.concatenate(sample_ii),
        "sample_jj": np.concatenate(sample_jj),
        "sample_vals": np.concatenate(sample_vals),
    }


def stream_count_histogram(
    xd,
    n: int,
    m_bits: int,
    *,
    n_bins: int = 64,
    bin_width: Optional[int] = None,
    superblock_rows: int = 4096,
    config: Optional[EngineConfig] = None,
    occupancy: Optional[np.ndarray] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """Exact histogram of the off-diagonal pair counts C[i<j] — the
    distribution sink for the K2 stripe walk: the aggregate a user wants
    at scales where C itself can never be materialized or fetched.

    Same stripe walk as :func:`stream_count_checksums` (each unordered
    pair visited exactly once: triangular tile list on diagonal
    superblocks, square off-diagonal). A stripe's reduction runs inside
    K2-hist (``kernels.mxu.count_tiles_hist``: the tiles are never stored)
    up to ``mxu.HIST_EPI_MAX_BINS`` bins, and above it as one masked bin
    count of the stored tiles (``stream_hist._bin_counts``): the rule is
    ``mxu.hist_route``. Either adds into a device total that is read back
    once, at the end. Bins are uniform: bin b
    counts pairs with ``b*bin_width <= C[ij] < (b+1)*bin_width``, with the
    last bin clamped to absorb the tail up to ``m_bits``. Integer binning
    of exact int32 counts — the result is exact, and mass conservation
    (``hist.sum() == n*(n-1)/2``) is asserted before returning.

    ``occupancy``: per-superblock K-group summary bool [n_super, G] — the
    summary skip for this sink: a co-empty stripe's counts are all exactly
    zero, so its entire valid-pair mass lands in bin 0 by arithmetic
    (``vi·vj`` pairs, ``vi·(vi−1)/2`` on the diagonal) with zero device
    work.

    ``xd`` contract is :func:`stream_count_checksums`'s.
    """
    from stormtpu_torch.kernels import mxu
    from stormtpu_torch.stream_hist import _bin_counts, _hist_manifest, _stripe_pair_mass

    dev = resolve_device(device)
    cfg = config or default_config()
    cfg.validate(m_bits)
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    if bin_width is None:
        bin_width = default_hist_bin_width(m_bits, n_bins)
    if bin_width < 1:
        raise ValueError("bin_width must be >= 1")
    xd, tile_rows, tile_words, superblock_rows, n_super = _sink_geometry(
        _as_device_words(xd, dev), n, cfg, superblock_rows, histogram=True
    )
    tiles_per_super = superblock_rows // tile_rows
    nb = xd.shape[0] // tile_rows
    if occupancy is not None and occupancy.shape[0] != n_super:
        raise ValueError(
            f"occupancy has {occupancy.shape[0]} superblocks, walk has "
            f"{n_super} — compute it with the same superblock_rows "
            f"({superblock_rows} after tile rounding)"
        )

    with _span("stpu.stream.job") as job:
        lane = torch.arange(tile_rows, dtype=torch.int32, device=dev)
        hist_d = torch.zeros(n_bins, dtype=torch.int64, device=dev)
        route = mxu.hist_route(n_bins)
        skipped_mass = 0
        total = n_super * (n_super + 1) // 2
        done = 0
        for i, j in _superblock_pairs(n_super):
            if occupancy is not None and not (occupancy[i] & occupancy[j]).any():
                # every pair in this stripe counts exactly 0 → its valid-pair
                # mass goes to bin 0 arithmetically
                skipped_mass += _stripe_pair_mass(n, superblock_rows, i, j)
                _count_stripe(False)
                done += 1
                if progress is not None:
                    progress(done, total)
                continue
            with _span("stpu.stream.stripe", job.number, i, j):
                loc_i, loc_j = _stripe_tile_ids(tiles_per_super, i == j)
                with _stage("plan", dev):
                    ids = mxu.device_tile_ids(
                        loc_i + i * tiles_per_super, loc_j + j * tiles_per_super, nb, dev
                    )
                _route(route)
                if route == mxu.ROUTE_HIST:
                    with _stage("kernel", dev):
                        hist_d += mxu.count_tiles_hist(
                            xd, *ids, tile_rows=tile_rows, tile_words=tile_words, n_real=n,
                            bin_width=bin_width, n_bins=n_bins, variant=cfg.k2_variant, checked=ids,
                        )
                else:
                    with _stage("kernel", dev):
                        tiles = mxu.count_tiles_pallas_mxu(
                            xd, *ids, tile_rows=tile_rows, tile_words=tile_words,
                            variant=cfg.k2_variant, checked=ids,
                        )
                    with _stage("reduce", dev):
                        rows_g = ids.ibs[:, None] * tile_rows + lane[None, :]
                        cols_g = ids.jbs[:, None] * tile_rows + lane[None, :]
                        # strict upper triangle within n: gi < gj < n (gi < n
                        # follows); zero-padding rows/tiles fail it, diagonal tiles
                        # keep r < c
                        valid = (rows_g[:, :, None] < cols_g[:, None, :]) & (cols_g[:, None, :] < n)
                        bins = torch.clamp(tiles // bin_width, max=n_bins - 1)
                        # invalid entries go to a spare bin past the last, then dropped
                        hist_d += _bin_counts(torch.where(valid, bins, n_bins), n_bins + 1)[:n_bins]
                    del tiles, valid, bins
                _count_stripe(True)
            done += 1
            if progress is not None:
                progress(done, total)
        with _stage("read_back", dev):
            hist_total = _read_back(hist_d)
        hist_total[0] += skipped_mass
    return _hist_manifest(n, m_bits, superblock_rows, n_super, "mxu",
                          n_bins, bin_width, hist_total)


# ------------------------------------------------------------- load, extend
def load_streamed_matrix(out_dir: str) -> np.ndarray:
    """Reassemble the full symmetric N×N matrix from stripes, on the host
    (moderate N only — intended for tests and downstream tooling). Reads
    the directories of both packages, all three stripe formats."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["n"]
    sb = manifest["superblock_rows"]
    n_super = manifest["n_super"]
    full = np.zeros((n_super * sb, n_super * sb), dtype=np.int32)
    for i in range(n_super):
        for j in range(i, n_super):
            with np.load(stripe_path(out_dir, i, j)) as z:
                if "tiles" in z.files:  # clustered sparse-tile stripes
                    ti = manifest["tile_rows"]
                    stripe = assemble_stripe(
                        z["tiles"], z["loc_i"], z["loc_j"], sb // ti, ti, i == j
                    )
                elif "coo_i" in z.files:  # sparse_outer nonzero stripes
                    stripe = np.zeros((sb, sb), dtype=np.int32)
                    stripe[z["coo_i"], z["coo_j"]] = z["coo_v"]
                else:
                    stripe = z["counts"]
            full[i * sb : (i + 1) * sb, j * sb : (j + 1) * sb] = stripe
            if i != j:
                full[j * sb : (j + 1) * sb, i * sb : (i + 1) * sb] = stripe.T
    return full[:n, :n]


def extend_streamed_matrix(
    bm: BitMatrix,
    out_dir: str,
    *,
    mesh=None,
    kernel: str = "auto",
    config: Optional[EngineConfig] = None,
    compress: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> dict:
    """Grow a completed streamed count-matrix directory to ``bm``'s larger
    row count WITHOUT recomputing the old quadratic work.

    A count stripe's content depends only on its two row superblocks, so
    appending rows (a panel gains samples or variants) invalidates nothing
    inside the unchanged row range:

    - stripes wholly inside the old COMPLETE superblocks are reused as-is
      (their files are not even opened);
    - stripes touching the old PARTIAL last superblock — whose zero-padded
      rows now hold data — are deleted and recomputed;
    - stripes involving new superblocks are computed fresh.

    Pair-work cost ≈ old·new + new²/2 instead of (old+new)²/2.

    Safety: ``bm``'s first ``old_n`` rows must be byte-identical to the
    original panel. The manifest's content fingerprint is checked against
    the head slice; directories written before the fingerprint existed are
    extended on the caller's word. ``m_bits`` must match exactly; the
    superblock geometry comes from the manifest and must be compatible
    with the active tile config (else stripes from the two runs would
    misalign under the same file names — refused up front).

    ``mesh``: extend through ``parallel.distributed_stream_count_matrix``
    instead of the single-device walk (same directory format; formats may
    mix — ``load_streamed_matrix`` reads file by file). Every rank of the
    mesh calls it; the mesh's first rank deletes and writes. Returns the
    new manifest.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    man_path = os.path.join(out_dir, "manifest.json")
    with open(man_path) as f:
        old = json.load(f)
    old_n = int(old["n"])
    sb = int(old["superblock_rows"])
    if bm.m_bits != old["m_bits"]:
        raise ValueError(
            f"extend: m_bits {bm.m_bits} != directory's {old['m_bits']} — "
            f"a changed universe invalidates every stripe"
        )
    if bm.n < old_n:
        raise ValueError(
            f"extend: N={bm.n} < directory's n={old_n} (rows can only be "
            f"appended; shrinking needs a fresh directory)"
        )
    cfg = config or default_config()
    resolved = None
    if mesh is None:
        # predict the walk's kernel with the walk's own policy so the
        # modulus check matches exactly what the resumed run will round by
        resolved = _resolve_stream_kernel(bm, kernel, cfg, device)
        mod = _stream_tile_modulus(resolved, cfg)
    else:
        # the distributed walk rounds by the ROW axis only, not by every
        # rank of a 2-D mesh
        mod = mesh.shape[mesh.axis_names[0]] * 8
    if sb % mod:
        raise ValueError(
            f"extend: superblock_rows={sb} is not a multiple of the "
            f"resumed walk's tile geometry ({mod}) — it would re-round "
            f"and misalign reused stripe files"
        )
    # stripe-FORMAT compatibility: 'tiles'-format stripe files assemble
    # under the manifest's tile_rows, so a grown panel that resolves to a
    # different kernel family must not drop (or silently change) that key
    # while old tiles files remain on disk
    old_ti = old.get("tile_rows")
    if resolved == "clustered":
        from stormtpu_torch.kernels.mxu import k2_tile_shape

        new_ti = k2_tile_shape(cfg, bm.n, bm.n_words)[0]
        # a 'distributed' directory of the JAX package only ever holds
        # EMPTY tiles records, which assemble identically under any ti —
        # only a genuine clustered→clustered ti change misassembles
        if (old_ti is not None and old_ti != new_ti
                and old.get("kernel") == "clustered"):
            raise ValueError(
                f"extend: the grown panel resolves to a clustered walk "
                f"with tile_rows={new_ti}, but the directory's existing "
                f"tiles-format stripes were written at tile_rows="
                f"{old_ti} — the two assemble differently under one "
                f"manifest; use a fresh directory (or match the config)"
            )
    old_fp = old.get("content")
    if old_fp is not None and old_n:
        if _content_fingerprint(bm, old_n) != old_fp:
            raise ValueError(
                "extend: the first rows differ from the panel this "
                "directory was computed from (content fingerprint "
                "mismatch) — reusing its stripes would splice two "
                "different matrices"
            )
    if old_n % sb and (mesh is None or mesh.is_writer()):
        # the old last superblock was partial: its zero-padded rows now
        # hold data, so every stripe touching it is stale
        last = old_n // sb
        n_super_old = int(old["n_super"])
        for i in range(n_super_old):
            for j in range(i, n_super_old):
                if i == last or j == last:
                    p = stripe_path(out_dir, i, j)
                    if os.path.exists(p):
                        os.remove(p)
    if mesh is not None:
        from stormtpu_torch.parallel.mesh import barrier
        from stormtpu_torch.parallel.multihost import distributed_stream_count_matrix

        barrier(mesh)  # no rank may see a stale stripe as done
        man = distributed_stream_count_matrix(
            bm, out_dir, superblock_rows=sb, mesh=mesh, config=cfg,
            resume=True, compress=compress, progress=progress,
        )
    else:
        man = stream_count_matrix(
            bm, out_dir, superblock_rows=sb, kernel=kernel, config=cfg,
            resume=True, compress=compress, progress=progress, device=dev,
        )
    carry = old_ti is not None and man.get("tile_rows") != old_ti and (
        man.get("tile_rows") is None  # new walk dropped the key entirely
        # clustered→clustered ti drift was refused above; over a clustered
        # directory the old NONZERO tiles' ti must win
        or old.get("kernel") == "clustered"
    )
    if carry:
        man["tile_rows"] = old_ti
        if mesh is None or mesh.is_writer():
            with open(man_path, "w") as f:
                json.dump(man, f, default=int)
        if mesh is not None:
            barrier(mesh)  # every rank returns after the manifest is in place
    return man
