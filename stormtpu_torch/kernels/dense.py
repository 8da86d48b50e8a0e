"""K1 and K0 — exact counts by AND and population count (port of
``stormtpu/kernels/dense.py``).

Two kernel wrappers, each with its plain PyTorch version beside it and a
launch counter (``LAUNCHES``):

- :func:`count_tiles_pallas_dense` — K1, the triangular tile list (CUDA
  entry ``k1_tri_launch`` in ``csrc/k1_dense.cu``);
- :func:`pair_count_stream_pallas` — K0, row-wise counts of a batch of
  pairs (``k0_stream_launch``).

A tensor on the CPU takes the plain version; a tensor on the card
launches the CUDA kernel, or raises. There is no fall back from one to
the other.

K1 runs on the tensor cores: AND + popcount of packed words is what their
binary product computes, so K1 launches the tile body K2 uses, two of its
tiles a block (:func:`pair_units` says which). D1 never picks K1 and it
stays an explicit strategy (``strategy="pallas_dense"``). K0 is bound by
the bytes of its two operands.

Exactness: a word's popcount is ≤ 32 and sums are int32, exact for
M < 2³¹ (``EngineConfig.validate``). ``variant`` ("rows"/"chunk") selects
between the JAX package's two K1 Pallas bodies, and ``block_rows`` /
``block_words`` set K0's Pallas blocks; they are accepted for parity and
have no effect here — every setting computes the same counts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels.mxu import (
    DeviceTileIds,
    _check_cuda_ids,
    _check_cuda_operand,
    _check_ids,
    _pad,
)
from stormtpu_torch.kernels.xla import popcount32
from stormtpu_torch.utils import (
    assemble_triangular_torch,
    download,
    round_up,
    triangular_tile_ids,
)

__all__ = [
    "LAUNCHES",
    "count_matrix_pallas_dense",
    "count_tiles_dense_plain",
    "count_tiles_pallas_dense",
    "k1_tile_shape",
    "pair_count_stream_pallas",
    "pair_count_stream_plain",
    "pair_units",
    "reset_launches",
]

_VARIANTS = ("rows", "chunk")

# CUDA launches per kernel wrapper; the plain versions do not count.
LAUNCHES = {"k1": 0, "k0": 0}

# elements of the plain K1's largest [pairs, rows, TI, WK] intermediate
_PLAIN_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _salt_bits(salt) -> int:
    """The uint32 ``salt`` as its int32 bit-view (what an int32 tensor
    XORs with, and what a C ``int`` can carry)."""
    salt = int(salt)
    if not 0 <= salt < 1 << 32:
        raise ValueError(f"salt={salt} must be a uint32")
    return salt - (1 << 32) if salt >= 1 << 31 else salt


# ----------------------------------------------------------------- plain forms
def count_tiles_dense_plain(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
) -> torch.Tensor:
    """Plain version of :func:`count_tiles_pallas_dense`: per K step, the
    popcount of the AND of every A row with every B row of each tile pair,
    added into the tile (a bounded batch of pairs and rows at a time)."""
    n_pad, w_pad = packed.shape
    ti = tile_rows
    t = ibs.shape[0]
    out = torch.zeros((t, ti, ti), dtype=torch.int32, device=packed.device)
    if t == 0:
        return out
    ib = ibs.to(device=packed.device, dtype=torch.int64)
    jb = jbs.to(device=packed.device, dtype=torch.int64)
    blocks = packed.view(n_pad // ti, ti, w_pad)
    per_row = ti * tile_words
    tb = max(1, _PLAIN_ELEMS // (ti * per_row))      # tile pairs a batch
    rc = ti if tb > 1 else max(1, min(ti, _PLAIN_ELEMS // per_row))
    for k0 in range(0, w_pad, tile_words):
        step = blocks[:, :, k0 : k0 + tile_words]
        for t0 in range(0, t, tb):
            a = step[ib[t0 : t0 + tb]]
            b = step[jb[t0 : t0 + tb]]
            for r0 in range(0, ti, rc):
                anded = a[:, r0 : r0 + rc, None, :] & b[:, None, :, :]
                out[t0 : t0 + tb, r0 : r0 + rc] += popcount32(anded).sum(
                    dim=3, dtype=torch.int32
                )
    return out


def pair_count_stream_plain(
    a_packed: torch.Tensor, b_packed: torch.Tensor, *, salt=0
) -> torch.Tensor:
    """Plain version of :func:`pair_count_stream_pallas`:
    popcount((A[r] ^ salt) & B[r]) summed per row, int32 [R]."""
    return popcount32((a_packed ^ _salt_bits(salt)) & b_packed).sum(
        dim=1, dtype=torch.int32
    )


# ------------------------------------------------------------- kernel wrappers
def pair_units(ibs: torch.Tensor) -> torch.Tensor:
    """Which tiles of a tile list lead a block of the K1 kernel, int32 [T]
    on ``ibs``'s device: the leading tiles' indices in ascending order,
    then -1. A block counts its leading tile t and, when ``ibs[t + 1] ==
    ibs[t]``, tile t + 1 with it (the two share their A rows). Tile t
    leads when the tiles before it that share its ``ibs``, back to back,
    are even in number: every run of equal ``ibs`` is cut into pairs from
    its start, and a run of odd length ends in a tile that runs alone. Any
    list is taken; a list sorted by ``ibs`` pairs best. Nothing is read
    back to the host."""
    t = ibs.numel()
    idx = torch.arange(t, device=ibs.device)
    starts_run = torch.ones(t, dtype=torch.bool, device=ibs.device)
    starts_run[1:] = ibs[1:] != ibs[:-1]
    run_start = torch.cummax(torch.where(starts_run, idx, 0), dim=0).values
    leads = (idx - run_start) % 2 == 0
    rank = torch.cumsum(leads, dim=0) - 1
    units = torch.full((t + 1,), -1, dtype=torch.int32, device=ibs.device)
    # a tile that does not lead writes into the spare last element
    units.scatter_(0, torch.where(leads, rank, t), idx.to(torch.int32))
    return units[:t]


def count_tiles_pallas_dense(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
    variant: str = "rows",
    checked: Optional[DeviceTileIds] = None,
) -> torch.Tensor:
    """T count tiles int32 [T, TI, TI] for row-block pairs (ibs[t], jbs[t])
    of a padded packed matrix int32 [N_pad, W_pad]. TI is any positive
    multiple of 8; WK a positive multiple of 4 words (the kernel reads
    16-byte vectors). ``checked`` (from ``mxu.device_tile_ids``) stands in
    for the id check, which otherwise reads back from the card."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown K1 variant {variant!r}; want one of {_VARIANTS}")
    n_pad, w_pad = packed.shape
    if tile_rows <= 0 or tile_rows % 8:
        raise ValueError(f"tile_rows={tile_rows} must be a positive multiple of 8")
    if tile_words <= 0 or tile_words % 4:
        raise ValueError(f"tile_words={tile_words} must be a positive multiple of 4")
    if n_pad % tile_rows or w_pad % tile_words:
        raise ValueError(
            f"shape {tuple(packed.shape)} is not a multiple of the tile "
            f"({tile_rows}, {tile_words})"
        )
    _check_ids("count_tiles_pallas_dense", ibs, jbs, n_pad // tile_rows, checked)
    if packed.device.type == "cpu":
        return count_tiles_dense_plain(
            packed, ibs, jbs, tile_rows=tile_rows, tile_words=tile_words
        )
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    _check_cuda_operand("count_tiles_pallas_dense", packed)
    _check_cuda_ids(packed.device, ibs=ibs, jbs=jbs)
    from stormtpu_torch.kernels._build import library

    lib = library("k1_dense")
    if (-(-tile_rows // lib.k1_block_rows())) ** 2 > 65535:
        raise ValueError(f"tile_rows={tile_rows} exceeds the grid limit")
    t = ibs.shape[0]
    out = torch.empty((t, tile_rows, tile_rows), dtype=torch.int32, device=packed.device)
    if t == 0:
        return out
    with torch.cuda.device(packed.device):
        units = pair_units(ibs)
        err = lib.k1_tri_launch(
            packed.data_ptr(), ibs.data_ptr(), jbs.data_ptr(), units.data_ptr(),
            out.data_ptr(), t, tile_rows, w_pad, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"k1_tri_launch failed: CUDA error {err}")
    LAUNCHES["k1"] += 1
    return out


def pair_count_stream_pallas(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    *,
    salt=0,
    block_rows: int = 512,
    block_words: int = 1024,
) -> torch.Tensor:
    """Row-wise counts int32 [R]: popcount((A[r] ^ salt) & B[r]) per row of
    two packed matrices int32 [R, W]. ``salt`` (a uint32, default 0 = no
    effect) lets a benchmark make repeated calls distinct without more
    bytes; production callers pass 0."""
    if a_packed.dim() != 2 or a_packed.shape != b_packed.shape:
        raise ValueError(
            f"want two [R, W] operands of one shape, got {tuple(a_packed.shape)} "
            f"and {tuple(b_packed.shape)}"
        )
    if a_packed.device != b_packed.device:
        raise ValueError("operands on different devices")
    bits = _salt_bits(salt)
    if a_packed.device.type == "cpu":
        return pair_count_stream_plain(a_packed, b_packed, salt=salt)
    if a_packed.device.type != "cuda":
        raise ValueError(f"unsupported device {a_packed.device}")
    for t in (a_packed, b_packed):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("pair_count_stream_pallas: want contiguous int32 operands")
    r, w = a_packed.shape
    out = torch.empty(r, dtype=torch.int32, device=a_packed.device)
    if r == 0:
        return out
    from stormtpu_torch.kernels._build import library

    lib = library("k1_dense")
    with torch.cuda.device(a_packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k0_stream_launch(
            a_packed.data_ptr(), b_packed.data_ptr(), out.data_ptr(), r, w, bits, stream
        )
    if err:
        raise RuntimeError(f"k0_stream_launch failed: CUDA error {err}")
    LAUNCHES["k0"] += 1
    return out


# ------------------------------------------------------------ tile walk
def k1_tile_shape(cfg: EngineConfig, n: int, w: int) -> tuple[int, int]:
    """(tile_rows, tile_words) for the K1 tile walk — the JAX package's
    geometry: TI a multiple of 8, WK a multiple of 128 words."""
    ti = min(cfg.k1_tile_rows, round_up(max(n, 8), 8))
    if w <= cfg.k1_tile_words:
        wk = round_up(max(w, 128), 128)
    else:
        wk = round_up(cfg.k1_tile_words, 128)
    return ti, wk


def count_matrix_pallas_dense(
    packed: torch.Tensor,
    *,
    config: Optional[EngineConfig] = None,
    variant: Optional[str] = None,
) -> np.ndarray:
    """Full N×N exact counts int32 (numpy) via the K1 triangular walk and
    the symmetric mirror on the tiles' device (one download of the
    finished matrix)."""
    cfg = config or default_config()
    variant = variant or cfg.k1_variant
    n, w = packed.shape
    ti, wk = k1_tile_shape(cfg, n, w)
    n_pad = round_up(n, ti)
    xp = _pad(packed, n_pad, round_up(w, wk))
    nb = n_pad // ti
    ibs, jbs = triangular_tile_ids(nb)
    tiles = count_tiles_pallas_dense(
        xp,
        torch.from_numpy(ibs).to(packed.device),
        torch.from_numpy(jbs).to(packed.device),
        tile_rows=ti,
        tile_words=wk,
        variant=variant,
    )
    return download(assemble_triangular_torch(tiles, ibs, jbs, nb, n))
