"""Triangular tile scheduling and result assembly.

Copies of the JAX package's host helpers (``stormtpu/utils/tiling.py``):
the (ib, jb ≥ ib) row-block pair walk that drives the K2 triangular
kernel, and the host-side mirror that turns its upper-triangular tiles
into the full symmetric N×N matrix. :func:`assemble_triangular_torch` is
the same mirror on the tiles' own device, so that the all-pairs paths
download one finished matrix instead of the tile stack.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from stormtpu_torch.utils import profiling

__all__ = [
    "round_up",
    "next_pow2",
    "quantize_bucket",
    "triangular_tile_ids",
    "assemble_triangular",
    "assemble_triangular_torch",
    "assemble_stripe",
    "assemble_stripe_torch",
    "triangular_assembly_bytes",
    "download",
    "MIRROR_CHUNK_TILES",
    "PINNED_RESULT_BYTES_MAX",
]


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ max(x, 8) — the coarse shape quantizer
    (log₂ distinct shapes; up to 2× padding)."""
    return 1 << max(3, (max(x, 1) - 1).bit_length())


def quantize_bucket(x: int, min_val: int = 8) -> int:
    """Smallest value ≥ max(x, min_val) of the form m·2^e with m ∈ [8, 16)
    (1/8-octave buckets): a bounded shape count (~8 per octave) with at
    most 12.5% padding."""
    x = max(x, min_val, 1)
    e = max(0, x.bit_length() - 4)
    return (-(-x >> e)) << e


def triangular_tile_ids(nb: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-block pair ids (ibs, jbs) int32 [T] for the upper triangle
    including the diagonal, T = nb·(nb+1)/2, ordered i-major."""
    ib, jb = np.triu_indices(nb)
    return ib.astype(np.int32), jb.astype(np.int32)


def assemble_triangular(
    tiles: np.ndarray, ibs: np.ndarray, jbs: np.ndarray, nb: int, n: int
) -> np.ndarray:
    """Scatter T upper-triangular [TI, TJ] count tiles into the full
    symmetric N×N matrix (C[i,j] = C[j,i]; mirror instead of recompute)."""
    t, ti, tj = tiles.shape
    grid = np.zeros((nb, nb, ti, tj), dtype=tiles.dtype)
    grid[ibs, jbs] = tiles
    full = grid.transpose(0, 2, 1, 3).reshape(nb * ti, nb * tj)
    upper = np.triu(full)
    out = upper + np.triu(full, 1).T
    return out[:n, :n]


# Tiles the mirror moves at a time: bounds its temporaries (the chunk's
# off-diagonal tiles and their transposed copy) beside the matrix.
MIRROR_CHUNK_TILES = 256

# Page-locked host bytes that live downloaded results may hold together; a
# result that would pass it is copied into pageable memory instead.
PINNED_RESULT_BYTES_MAX = 2 << 30

_pinned_live_bytes = 0
_pinned_lock = threading.Lock()


def assemble_triangular_torch(
    tiles: torch.Tensor, ibs, jbs, nb: int, n: int
) -> torch.Tensor:
    """:func:`assemble_triangular` on the tiles' device: T upper-triangular
    [TI, TI] count tiles (``ibs[t] <= jbs[t]``, each pair at most once)
    into the symmetric matrix, returned as the [:n, :n] view of a
    [nb·TI, nb·TI] tensor. Tile t is written at block (ibs[t], jbs[t])
    and, for ibs[t] != jbs[t], transposed at (jbs[t], ibs[t]); block pairs
    with no tile stay zero. Equal to the numpy form entry for entry as
    long as diagonal tiles are symmetric, which exact counts of a row
    block against itself are. The mirror goes ``MIRROR_CHUNK_TILES`` tiles
    at a time, so its temporaries stay small beside the matrix."""
    t, ti, tj = tiles.shape
    if ti != tj:
        raise ValueError(f"tiles must be square, got {ti} x {tj}")
    full = torch.zeros((nb * ti, nb * ti), dtype=tiles.dtype, device=tiles.device)
    grid = full.view(nb, ti, nb, ti)
    ib = torch.as_tensor(np.asarray(ibs), device=tiles.device).long()
    jb = torch.as_tensor(np.asarray(jbs), device=tiles.device).long()
    if ib.shape != (t,) or jb.shape != (t,):
        raise ValueError("ibs and jbs must hold one id per tile")
    for s in range(0, t, MIRROR_CHUNK_TILES):
        e = s + MIRROR_CHUNK_TILES
        i, j, part = ib[s:e], jb[s:e], tiles[s:e]
        grid[i, :, j, :] = part
        off = i != j
        grid[j[off], :, i[off], :] = part[off].transpose(1, 2)
    return full[:n, :n]


def assemble_stripe(
    tiles: np.ndarray,
    loc_i: np.ndarray,
    loc_j: np.ndarray,
    tps: int,
    tile_rows: int,
    diagonal: bool,
) -> np.ndarray:
    """Dense [SB, SB] stripe (SB = tps·tile_rows) of the streaming walk
    from count tiles at local tile coordinates, on the host. ``diagonal``
    mirrors the strictly upper tiles transposed (a diagonal stripe lists
    its upper triangle only). Unlisted tiles are zero, which the clustered
    stripes rely on."""
    grid = np.zeros((tps, tps, tile_rows, tile_rows), dtype=np.int32)
    if tiles.size:
        grid[loc_i, loc_j] = tiles
        if diagonal:
            off = loc_i != loc_j
            grid[loc_j[off], loc_i[off]] = tiles[off].transpose(0, 2, 1)
    sb = tps * tile_rows
    return grid.transpose(0, 2, 1, 3).reshape(sb, sb)


def assemble_stripe_torch(
    tiles: torch.Tensor, loc_i, loc_j, tps: int, tile_rows: int, diagonal: bool
) -> torch.Tensor:
    """:func:`assemble_stripe` on the tiles' device: the [SB, SB] stripe
    is written once, in place, and the mirror goes ``MIRROR_CHUNK_TILES``
    tiles at a time. ``loc_i`` / ``loc_j`` are host arrays: which tiles
    the mirror moves is decided on the host and uploaded with the
    coordinates in one copy, so nothing is read back from the device. To
    a card the copy goes from pinned memory without waiting: a blocking
    upload would hold the host until the tile kernel before it ends."""
    t = tiles.shape[0]
    loc_i = np.asarray(loc_i, dtype=np.int64)
    loc_j = np.asarray(loc_j, dtype=np.int64)
    if tiles.shape[1:] != (tile_rows, tile_rows) or loc_i.shape != (t,) or loc_j.shape != (t,):
        raise ValueError("want [T, tile_rows, tile_rows] tiles and one coordinate pair per tile")
    sb = tps * tile_rows
    full = torch.zeros((sb, sb), dtype=tiles.dtype, device=tiles.device)
    if t == 0:
        return full
    off = np.flatnonzero(loc_i != loc_j) if diagonal else np.zeros(0, dtype=np.int64)
    idx = torch.from_numpy(np.concatenate([loc_i, loc_j, off]))
    if tiles.device.type == "cuda":
        profiling.count("pinned_allocs")
        profiling.count("h2d_bytes", idx.numel() * idx.element_size())
        idx = idx.pin_memory().to(tiles.device, non_blocking=True)
    li, lj, off_d = idx[:t], idx[t : 2 * t], idx[2 * t :]
    grid = full.view(tps, tile_rows, tps, tile_rows)
    grid[li, :, lj, :] = tiles
    for s in range(0, off.size, MIRROR_CHUNK_TILES):
        sel = off_d[s : s + MIRROR_CHUNK_TILES]
        grid[lj[sel], :, li[sel], :] = tiles[sel].transpose(1, 2)
    return full


def triangular_assembly_bytes(n_tiles: int, ti: int, nb: int, n: int) -> int:
    """Device bytes of a triangular walk's results: the int32 tile stack
    and the assembled matrix together, the mirror's temporaries (one
    chunk's off-diagonal tiles and their transposed copy), and the
    contiguous copy of a ragged [:n, :n] view made for the download."""
    side = nb * ti
    chunk = 2 * min(n_tiles, MIRROR_CHUNK_TILES) * ti * ti
    return 4 * (n_tiles * ti * ti + side * side + chunk + (n * n if n != side else 0))


def _release_pinned(nbytes: int) -> None:
    global _pinned_live_bytes
    with _pinned_lock:
        _pinned_live_bytes -= nbytes


def download(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host, in one copy.

    A CUDA tensor goes into a page-locked buffer from PyTorch's caching
    host allocator, which the returned array keeps alive: at 16384 × 16384
    int32 that copy beats a pageable ``.cpu()`` even with the buffer's
    allocation counted, and by far once the cache holds a buffer
    (``scripts/torch_assembly_d2h.py`` times both). Page-locked memory is
    taken from what the host can swap, so it is bounded: the buffers of
    results alive at once (each rounded up to a power of two, as that
    allocator sizes them) hold at most ``PINNED_RESULT_BYTES_MAX``, and a
    result that would pass that goes through ``.cpu()`` into pageable
    memory. When a result dies its buffer returns to PyTorch's host cache,
    which keeps it page-locked for the next download of its size class."""
    profiling.count("d2h_bytes", t.numel() * t.element_size())
    with profiling.wait("download"):
        return _download(t)


def _download(t: torch.Tensor) -> np.ndarray:
    global _pinned_live_bytes
    if t.device.type != "cuda":
        return t.numpy()
    nbytes = 1 << max(0, t.numel() * t.element_size() - 1).bit_length()
    with _pinned_lock:
        pinned = _pinned_live_bytes + nbytes <= PINNED_RESULT_BYTES_MAX
        if pinned:
            _pinned_live_bytes += nbytes
    if not pinned:
        return t.cpu().numpy()
    try:
        profiling.count("pinned_allocs")
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        out = host.numpy()
    except BaseException:
        _release_pinned(nbytes)
        raise
    # on the array, not the tensor object: views of the array keep it, and
    # with it the buffer, alive
    weakref.finalize(out, _release_pinned, nbytes)
    return out
