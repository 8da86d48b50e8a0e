"""Bit-matrix layout: packing, containers, density statistics.

The port's copy of ``stormtpu/layout.py``. The primary representation is
the contiguous packed matrix ``uint32[N, W]`` on the host, with per-row
nnz and the global density that D1 dispatches on, and, for matrices built
from positions, the ingest-time COO (``BitMatrix.coo``) that K4 reads.
Packing, unpacking, row popcounts and CSR extraction go through the C++
host tier (``stormtpu_torch.native``) and fall back to NumPy with the same
result when it is unavailable.

Bit order: bit ``p`` of row ``i`` lives at ``packed[i, p >> 5]`` bit
``(p & 31)`` (LSB-first within a uint32 word).

On the device the words live as **int32 bit-views** of the uint32 words
(:func:`to_device_words`): torch implements neither ``>>`` nor most
bitwise ops for ``uint32`` on the CPU, so device code shifts the int32
view arithmetically and masks afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from stormtpu_torch import native as _native
from stormtpu_torch.config import WORD_BITS, EngineConfig, default_config
from stormtpu_torch.utils import profiling

# from_positions keeps its COO (for K4) only up to this many entries
# (about 512 MB of int64 pairs): above it the cache would pin more host
# memory than it saves.
_COO_CACHE_MAX_NNZ = 1 << 25

__all__ = [
    "BitMatrixBuilder",
    "BitMatrix",
    "from_reference",
    "pack_bits",
    "unpack_bits",
    "pack_positions",
    "pad_rows",
    "pad_words",
    "to_device_words",
    "words_for_bits",
]


def words_for_bits(m_bits: int) -> int:
    return -(-m_bits // WORD_BITS)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def to_device_words(packed: np.ndarray, device) -> torch.Tensor:
    """uint32 [N, W] host words → int32 bit-view tensor on ``device``."""
    arr = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
    return profiling.upload(torch.from_numpy(arr), device)


# rows a padded upload copies at a time: bounds the host staging copy
_UPLOAD_ROW_BYTES = 1 << 28


def _upload_padded(packed: np.ndarray, n_pad: int, w_pad: int, device) -> torch.Tensor:
    """uint32 [N, W] host words zero-padded to [n_pad, w_pad] as int32 on
    ``device``, zeroed and filled there in row chunks: no padded copy of
    the matrix is made on the host, and the device holds one buffer."""
    n, w = packed.shape
    out = torch.zeros((n_pad, w_pad), dtype=torch.int32, device=device)
    step = max(1, _UPLOAD_ROW_BYTES // max(4 * w, 1))
    for r in range(0, n, step):
        rows = packed[r : r + step]
        out[r : r + rows.shape[0], :w] = to_device_words(rows, device)
    return out


def pack_bits(dense01: np.ndarray) -> np.ndarray:
    """Pack a {0,1} matrix [N, M] into uint32 words [N, ceil(M/32)].

    LSB-first within each word (bit p → word p>>5, bit p&31).
    """
    dense01 = np.asarray(dense01)
    if dense01.ndim != 2:
        raise ValueError(f"expected 2-D {{0,1}} matrix, got shape {dense01.shape}")
    n, m = dense01.shape
    w = words_for_bits(m)
    out = _native.pack_bits_native(dense01, w)
    if out is not None:
        return out
    # np.packbits packs MSB-first per byte; request little bit order then
    # view 4 bytes as one little-endian uint32 → LSB-first per word.
    padded_bits = _round_up(m, WORD_BITS)
    buf = np.zeros((n, padded_bits), dtype=np.uint8)
    buf[:, :m] = dense01.astype(np.uint8)
    bytes_ = np.packbits(buf, axis=1, bitorder="little")
    return bytes_.reshape(n, w, 4).view("<u4").reshape(n, w)


def unpack_bits(packed: np.ndarray, m_bits: int) -> np.ndarray:
    """Inverse of :func:`pack_bits` → uint8 {0,1} matrix [N, m_bits]."""
    packed = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
    out = _native.unpack_bits_native(packed, m_bits)
    if out is not None:
        return out
    n, w = packed.shape
    bytes_ = packed.reshape(n, w, 1).view("<u1").reshape(n, w * 4)
    bits = np.unpackbits(bytes_, axis=1, bitorder="little")
    return bits[:, :m_bits]


def pack_positions(
    row_ids: np.ndarray, positions: np.ndarray, n: int, m_bits: int
) -> np.ndarray:
    """Pack COO set-bit coordinates into uint32 words [N, ceil(M/32)].

    O(total set bits). Duplicate positions are idempotent (bitwise OR).
    """
    row_ids = np.asarray(row_ids, dtype=np.int64)
    positions = np.asarray(positions, dtype=np.int64)
    if row_ids.shape != positions.shape:
        raise ValueError("row_ids and positions must have the same shape")
    if positions.size and (positions.min() < 0 or positions.max() >= m_bits):
        raise ValueError("position out of range")
    if row_ids.size and (row_ids.min() < 0 or row_ids.max() >= n):
        raise ValueError("row id out of range")
    w = words_for_bits(m_bits)
    out = _native.pack_positions_native(row_ids, positions, n, m_bits, w)
    if out is not None:
        return out
    packed = np.zeros((n, w), dtype=np.uint32)
    np.bitwise_or.at(
        packed,
        (row_ids, positions >> 5),
        (np.uint32(1) << (positions & 31).astype(np.uint32)),
    )
    return packed


def pad_rows(packed: np.ndarray, row_mult: int) -> np.ndarray:
    """Zero-pad rows to a multiple of ``row_mult`` (zero rows ⇒ zero counts)."""
    n = packed.shape[0]
    n_pad = _round_up(max(n, 1), row_mult)
    if n_pad == n:
        return packed
    out = np.zeros((n_pad,) + packed.shape[1:], dtype=packed.dtype)
    out[:n] = packed
    return out


def pad_words(packed: np.ndarray, word_mult: int) -> np.ndarray:
    """Zero-pad the word axis to a multiple of ``word_mult`` (exactness-safe)."""
    w = packed.shape[1]
    w_pad = _round_up(max(w, 1), word_mult)
    if w_pad == w:
        return packed
    out = np.zeros(packed.shape[:1] + (w_pad,) + packed.shape[2:], dtype=packed.dtype)
    out[:, :w] = packed
    return out


@dataclasses.dataclass
class BitMatrix:
    """N bitmaps over an M-bit universe, bit-packed row-major, with the
    ingest-time statistics D1 dispatches on."""

    packed: np.ndarray        # uint32 [N, W], W = ceil(m_bits / 32)
    n: int
    m_bits: int
    row_nnz: np.ndarray       # int64 [N] set-bit count per row
    # The ingest-time COO (row_ids, positions; int64, duplicates allowed)
    # that from_positions keeps: K4 then skips the O(N·W) packed scan. It
    # repeats what ``packed`` holds, so equality, the device cache and the
    # content fingerprint ignore it.
    coo: Optional[tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    # ------------------------------------------------------------------ build
    @classmethod
    def from_dense(cls, dense01: np.ndarray) -> "BitMatrix":
        dense01 = np.asarray(dense01)
        packed = pack_bits(dense01)
        return cls.from_packed(packed, m_bits=dense01.shape[1])

    @classmethod
    def from_packed(cls, packed: np.ndarray, m_bits: int) -> "BitMatrix":
        with profiling.span("stpu.layout.from_packed"):
            return cls._of_packed(packed, m_bits)

    @classmethod
    def _of_packed(cls, packed: np.ndarray, m_bits: int) -> "BitMatrix":
        """:meth:`from_packed`'s work, under its caller's span."""
        with profiling.span("stpu.layout.validate"):
            packed = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
            n, w = packed.shape
            if w != words_for_bits(m_bits):
                raise ValueError(
                    f"packed has {w} words but m_bits={m_bits} needs "
                    f"{words_for_bits(m_bits)}"
                )
            tail = m_bits % WORD_BITS
            if tail and n and np.any(packed[:, -1] >> tail):
                raise ValueError("set bits beyond m_bits in final word")
        with profiling.span("stpu.layout.row_counts"):
            row_nnz = _native.row_popcounts_native(packed)
            if row_nnz is None:
                row_nnz = np.bitwise_count(packed).sum(axis=1, dtype=np.int64)
            else:
                profiling.count(f"row_counts.{_native.popcount_path()}")
        return cls(packed=packed, n=n, m_bits=m_bits, row_nnz=row_nnz)

    @classmethod
    def from_positions(
        cls, row_ids: np.ndarray, positions: np.ndarray, n: int, m_bits: int
    ) -> "BitMatrix":
        with profiling.span("stpu.layout.from_positions"):
            with profiling.span("stpu.layout.pack"):
                packed = pack_positions(row_ids, positions, n, m_bits)
            bm = cls._of_packed(packed, m_bits)
            # copies, not views: the caller may change its arrays afterwards,
            # and K4 must see what was packed
            if np.size(positions) <= _COO_CACHE_MAX_NNZ:
                with profiling.span("stpu.layout.coo_copy"):
                    bm.coo = (
                        np.array(row_ids, dtype=np.int64, copy=True),
                        np.array(positions, dtype=np.int64, copy=True),
                    )
            return bm

    @classmethod
    def from_position_lists(
        cls, lists: Sequence[np.ndarray], m_bits: int
    ) -> "BitMatrix":
        n = len(lists)
        if n:
            row_ids = np.concatenate(
                [np.full(len(np.atleast_1d(l)), i, dtype=np.int64)
                 for i, l in enumerate(lists)]
            )
            positions = np.concatenate(
                [np.atleast_1d(np.asarray(l, dtype=np.int64)) for l in lists]
            ) if row_ids.size else np.zeros(0, dtype=np.int64)
        else:
            row_ids = positions = np.zeros(0, dtype=np.int64)
        return cls.from_positions(row_ids, positions, n, m_bits)

    # ------------------------------------------------------------------ views
    def to_dense(self) -> np.ndarray:
        return unpack_bits(self.packed, self.m_bits)

    def device_cached(self, key: tuple, build, device):
        """Cache a device tensor on this matrix under ``key`` and the
        device string, so a matrix used on the CPU and then on the card in
        one process never serves a tensor from the wrong device. The cache
        lives outside the dataclass fields.

        Contract: a BitMatrix is treated as IMMUTABLE once built. After an
        in-place mutation of ``packed``/``row_nnz`` call
        :meth:`clear_device_cache`."""
        cache = self.__dict__.setdefault("_device_cache", {})
        full_key = key + (str(torch.device(device)),)
        buf = cache.get(full_key)
        if buf is None:
            buf = build()
            cache[full_key] = buf
        return buf

    def _cached_row_padded(self, n_pad: int, device, w_pad: Optional[int] = None):
        """The smallest cached row-padded buffer ("padded" or "padded2d")
        on ``device`` with at least ``n_pad`` rows and, unless ``w_pad`` is
        None, exactly ``w_pad`` words a row; or None."""
        cache = self.__dict__.get("_device_cache", {})
        dev = str(torch.device(device))
        keys = [
            k for k in cache
            if k[-1] == dev and k[0] in ("padded", "padded2d") and k[1] >= n_pad
            and (w_pad is None or cache[k].shape[1] == w_pad)
        ]
        return cache[min(keys, key=lambda k: k[1])] if keys else None

    def device_padded(self, n_pad: int, *, device, reuse_larger: bool = False):
        """``packed`` zero-padded to ``n_pad`` rows as an int32 bit-view
        tensor on ``device``, cached per (``n_pad``, device): repeated
        queries on one matrix reuse the device copy instead of uploading
        O(N·W) bytes per call.

        ``reuse_larger``: return any cached row-padded buffer with at
        least ``n_pad`` rows instead of a new copy, the word-padded
        ("padded2d") ones included — for callers whose row indices are
        below N (gathers): extra zero rows are never read and extra zero
        words add 0 to every popcount, so a second full copy is never
        pinned beside the screen's."""
        if n_pad < self.n:
            raise ValueError(f"n_pad={n_pad} < N={self.n}")
        if reuse_larger:
            hit = self._cached_row_padded(n_pad, device)
            if hit is not None:
                return hit

        def build():
            if n_pad == self.n:
                return to_device_words(self.packed, device)
            return _upload_padded(self.packed, n_pad, self.n_words, device)

        return self.device_cached(("padded", int(n_pad)), build, device)

    def device_padded2d(self, n_pad: int, w_pad: int, *, device):
        """``packed`` zero-padded to [``n_pad``, ``w_pad``] on ``device``,
        cached under ("padded2d", n_pad, w_pad). A cached row-padded buffer
        of ``w_pad`` words a row and at least ``n_pad`` rows serves as its
        first ``n_pad`` rows (a contiguous view; the rows past N are zero
        either way), so the tile walks, the histogram walk and the count
        paths of one matrix share one device copy."""
        if n_pad < self.n or w_pad < self.n_words:
            raise ValueError(f"[{n_pad}, {w_pad}] is smaller than [{self.n}, {self.n_words}]")
        hit = self._cached_row_padded(n_pad, device, w_pad)
        if hit is not None:
            return hit[:n_pad]
        return self.device_cached(
            ("padded2d", int(n_pad), int(w_pad)),
            lambda: _upload_padded(self.packed, n_pad, w_pad, device), device)

    def device_ordered2d(self, perm: np.ndarray, n_pad: int, w_pad: int, *, device):
        """The rows ``packed[perm]`` (``perm`` a permutation of the rows)
        zero-padded to [``n_pad``, ``w_pad``] on ``device``, cached under
        ("ordered2d", n_pad, w_pad) and the order's checksum. The host rows
        go up in their own order, a chunk at a time, and are placed on the
        device: no reordered copy of the matrix is made on the host."""
        import zlib

        if n_pad < self.n or w_pad < self.n_words:
            raise ValueError(f"[{n_pad}, {w_pad}] is smaller than [{self.n}, {self.n_words}]")
        perm = np.ascontiguousarray(perm, dtype=np.int64)
        key = ("ordered2d", int(n_pad), int(w_pad), zlib.crc32(perm.tobytes()))

        def build():
            at = np.empty(self.n, dtype=np.int64)
            at[perm] = np.arange(self.n)
            out = torch.zeros((n_pad, w_pad), dtype=torch.int32, device=device)
            w = self.n_words
            step = max(1, _UPLOAD_ROW_BYTES // max(4 * w, 1))
            for r in range(0, self.n, step):
                rows = to_device_words(self.packed[r : r + step], device)
                out[profiling.upload(torch.from_numpy(at[r : r + step]), device), :w] = rows
            return out

        return self.device_cached(key, build, device)

    def device_nnz(self, n_pad: int, *, device):
        """int32 ``row_nnz`` zero-padded to ``n_pad`` rows on ``device``,
        cached per (``n_pad``, device), as :meth:`device_padded`."""
        if n_pad < self.n:
            raise ValueError(f"n_pad={n_pad} < N={self.n}")

        def build():
            nz = np.zeros(n_pad, dtype=np.int32)
            nz[: self.n] = self.row_nnz.astype(np.int32)
            return profiling.upload(torch.from_numpy(nz), device)

        return self.device_cached(("nnz", int(n_pad)), build, device)

    def clear_device_cache(self) -> None:
        """Drop cached device tensors (frees device memory; REQUIRED
        after any in-place mutation of ``packed``/``row_nnz``)."""
        self.__dict__.pop("_device_cache", None)

    def positions_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr int64 [N+1], indices int32 [nnz]) sorted per row: two
        passes of the C++ tier over the packed words. The NumPy fallback
        unpacks the whole matrix (N·M bytes)."""
        res = _native.positions_csr_native(self.packed, self.m_bits)
        if res is not None:
            return res
        dense = self.to_dense()
        rows, cols = np.nonzero(dense)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, cols.astype(np.int32)

    def block_summary(self, block_bits: int = 65536) -> np.ndarray:
        """Per-row non-empty-block summary, uint8 [N, ceil(M/block_bits)]:
        entry [i, b] is 1 iff row i has any set bit in block b. The
        clustered-sparsity signal D1 reads."""
        wpb = max(1, block_bits // WORD_BITS)
        w = self.packed.shape[1]
        if w == 0:
            return np.zeros((self.n, 0), dtype=np.uint8)
        starts = np.arange(0, w, wpb)
        grouped = np.bitwise_or.reduceat(self.packed, starts, axis=1)
        return (grouped != 0).astype(np.uint8)

    # ------------------------------------------------------------------ stats
    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())

    @property
    def density(self) -> float:
        if self.n == 0 or self.m_bits == 0:
            return 0.0
        return self.nnz / (self.n * self.m_bits)

    @property
    def n_words(self) -> int:
        return self.packed.shape[1]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"BitMatrix(n={self.n}, m_bits={self.m_bits}, "
            f"density={self.density:.4g})"
        )


def from_reference(
    packed: np.ndarray, m_bits: int, config: Optional[dict] = None
) -> tuple[BitMatrix, EngineConfig]:
    """Build the port's (BitMatrix, EngineConfig) from the JAX package's
    plain values: ``bm.packed`` (uint32 [N, W]) and
    ``dataclasses.asdict(cfg)``. An unknown config field raises
    ``TypeError``."""
    bm = BitMatrix.from_packed(np.asarray(packed, dtype=np.uint32), m_bits)
    cfg = default_config() if config is None else EngineConfig(**config)
    return bm, cfg


class BitMatrixBuilder:
    """Incremental ingest: ``add_row`` / ``add`` set-bit positions, then
    ``finalize()`` into an immutable :class:`BitMatrix`. Positions may
    arrive unsorted and with duplicates (idempotent OR)."""

    def __init__(self, m_bits: int):
        if m_bits <= 0:
            raise ValueError("m_bits must be positive")
        self.m_bits = int(m_bits)
        self._rows: list[np.ndarray] = []
        self._chunks_row: list[np.ndarray] = []
        self._chunks_pos: list[np.ndarray] = []

    @property
    def n(self) -> int:
        return len(self._rows)

    def add_row(self, positions=()) -> int:
        """Append a new bitmap with the given set-bit positions; returns
        its row id."""
        pos = np.atleast_1d(np.asarray(positions, dtype=np.int64)).ravel()
        if pos.size and (pos.min() < 0 or pos.max() >= self.m_bits):
            raise ValueError("position out of range")
        self._rows.append(pos)
        return len(self._rows) - 1

    def add(self, row_id: int, positions) -> None:
        """Add set-bit positions to an existing row."""
        if not 0 <= row_id < len(self._rows):
            raise ValueError(f"row {row_id} does not exist (n={self.n})")
        pos = np.atleast_1d(np.asarray(positions, dtype=np.int64)).ravel()
        if pos.size and (pos.min() < 0 or pos.max() >= self.m_bits):
            raise ValueError("position out of range")
        self._chunks_row.append(np.full(pos.size, row_id, dtype=np.int64))
        self._chunks_pos.append(pos)

    def finalize(self) -> BitMatrix:
        """Pack everything accumulated so far into a BitMatrix (the
        builder stays usable — finalize again after more adds)."""
        n = len(self._rows)
        parts_r = [
            np.full(r.size, i, dtype=np.int64) for i, r in enumerate(self._rows)
        ] + self._chunks_row
        parts_p = list(self._rows) + self._chunks_pos
        if parts_p:
            row_ids = np.concatenate(parts_r) if parts_r else np.zeros(0, np.int64)
            positions = np.concatenate(parts_p)
        else:
            row_ids = positions = np.zeros(0, dtype=np.int64)
        return BitMatrix.from_positions(row_ids, positions, n, self.m_bits)
