"""Exact intersection counts, computed plainly.

- :func:`row_counts`: counts of a few rows against a whole panel, as a
  float32 product of the unpacked bits (TF32 off), a block of panel rows
  at a time. Every partial sum is a whole number below 2**24, so float32
  holds it exactly in any order of summation.
- :func:`pair_counts`: NumPy popcount of listed pairs (``np.bitwise_count``).
- :func:`sparse_matrix`: the N×N matrix of a panel given as set-bit
  positions, by emitting every pair of rows that share a position.

``precision="bfloat16"`` computes :func:`row_counts` as a bfloat16 product
with a bfloat16 result instead: the control, the nearest precision below
exact that a faster path would tempt one to take.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_SHIFTS = {}


def unpack(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int32 [r, W] packed words → [r, 32·W] of 0/1 in ``dtype``. The bit
    order is the bytes' in memory; any fixed order gives the same counts."""
    key = str(words.device)
    if key not in _SHIFTS:
        _SHIFTS[key] = torch.arange(8, dtype=torch.uint8, device=words.device)
    b = words.contiguous().view(torch.uint8)
    bits = (b.unsqueeze(-1) >> _SHIFTS[key]) & 1
    return bits.reshape(words.shape[0], -1).to(dtype)


@contextlib.contextmanager
def _exact_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def row_counts(rows: torch.Tensor, panel_chunks, n: int, precision: str = "float32",
               block_rows: int = 1024) -> np.ndarray:
    """int64 [S, n]: popcount(rows[s] AND panel[j]) for every panel row j.

    ``rows``: int32 [S, W] on the device that computes; ``panel_chunks``:
    an iterable of (row0, int32 [r, W] on that device) covering the panel
    in order."""
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    out = np.empty((rows.shape[0], n), dtype=np.int64)
    a = unpack(rows, dtype)
    with _exact_float32():
        for r0, chunk in panel_chunks:
            for b0 in range(0, chunk.shape[0], block_rows):
                blk = unpack(chunk[b0 : b0 + block_rows], dtype)
                c = a @ blk.T
                out[:, r0 + b0 : r0 + b0 + blk.shape[0]] = (
                    c.float().round().to(torch.int64).cpu().numpy())
                del blk, c
    return out


def pair_counts(words: np.ndarray, i: np.ndarray, j: np.ndarray, block: int = 256) -> np.ndarray:
    """int64 popcount(words[i] AND words[j]) of each listed pair (host)."""
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    out = np.empty(i.size, dtype=np.int64)
    for s in range(0, i.size, block):
        out[s : s + block] = np.bitwise_count(words[i[s : s + block]] & words[j[s : s + block]]
                                              ).sum(axis=1, dtype=np.int64)
    return out


def sparse_matrix(row_ids: np.ndarray, positions: np.ndarray, n: int, device) -> torch.Tensor:
    """int32 [n, n] on ``device``: C[a, b] = the positions rows a and b
    share, from the (row, position) list (duplicates count once)."""
    r = torch.as_tensor(row_ids, dtype=torch.int64, device=device)
    p = torch.as_tensor(positions, dtype=torch.int64, device=device)
    key = torch.unique(p * n + r)  # sorted by position, then row
    r, p = key % n, key // n
    _, size = torch.unique_consecutive(p, return_counts=True)
    start = torch.cumsum(size, 0) - size
    # each set bit pairs with every set bit of its column, itself included
    reps = torch.repeat_interleave(size, size)
    first = torch.repeat_interleave(start, size)
    a = torch.repeat_interleave(torch.arange(r.numel(), device=device), reps)
    group_start = torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps)
    b = torch.repeat_interleave(first, reps) + torch.arange(a.numel(), device=device) - group_start
    c = torch.zeros(n * n, dtype=torch.int32, device=device)
    c.index_add_(0, r[a] * n + r[b], torch.ones(a.numel(), dtype=torch.int32, device=device))
    return c.view(n, n)
