"""Plain-torch compute paths (the port of ``stormtpu/kernels/xla.py``).

The JAX package leaves these to XLA outside any Pallas kernel, so the
port writes them as ordinary tensor code: word-wise AND + popcount, and
bit-unpack to int8 + an integer product. They are the small-shape
strategies (``popcount``, ``mxu``) and the CPU forms every parity test
runs.

Words are int32 bit-views of the packed uint32 words (see
``layout.to_device_words``): shifts are arithmetic, so every shift is
followed by a mask.

Exactness: counts are integers ≤ M < 2³¹ (``EngineConfig.validate``),
so int32 accumulation is exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stormtpu_torch.config import WORD_BITS

__all__ = [
    "popcount32",
    "pair_count_xla",
    "pair_count_batch_xla",
    "count_block_popcount_xla",
    "count_matrix_popcount_xla",
    "unpack_to_int8",
    "int8_dot_nt",
    "count_block_int8_xla",
    "count_matrix_int8_xla",
]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit-views, as int32 (SWAR; torch has
    no popcount op). Wrapping int32 subtraction gives the uint32 bit
    pattern, and each arithmetic shift is masked."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pair_count_xla(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """popcount(a AND b) over two packed vectors → int32 scalar tensor."""
    return popcount32(a_packed & b_packed).sum(dtype=torch.int32)


def pair_count_batch_xla(
    a_packed: torch.Tensor, b_packed: torch.Tensor
) -> torch.Tensor:
    """Row-wise counts int32 [R]: popcount(A[r] AND B[r]) per row."""
    return popcount32(a_packed & b_packed).sum(dim=1, dtype=torch.int32)


def count_block_popcount_xla(
    a_packed: torch.Tensor, b_packed: torch.Tensor, tile_rows: int = 8
) -> torch.Tensor:
    """Cross-block counts int32 [Na, Nb] via word-wise AND + popcount,
    ``tile_rows`` rows of A at a time (bounds the [tile_rows, Nb, W]
    intermediate)."""
    na = a_packed.shape[0]
    nb = b_packed.shape[0]
    out = torch.empty((na, nb), dtype=torch.int32, device=a_packed.device)
    for i in range(0, na, tile_rows):
        anded = a_packed[i : i + tile_rows, None, :] & b_packed[None, :, :]
        out[i : i + tile_rows] = popcount32(anded).sum(dim=2, dtype=torch.int32)
    return out


def count_matrix_popcount_xla(
    packed: torch.Tensor, tile_rows: int = 8
) -> torch.Tensor:
    """Full N×N counts via the word-popcount path."""
    return count_block_popcount_xla(packed, packed, tile_rows=tile_rows)


def unpack_to_int8(packed: torch.Tensor) -> torch.Tensor:
    """int32 words [N, W] → int8 {0,1} [N, 32·W], bit-major K order:
    K column ``b·W + w`` holds bit ``b`` of word ``w`` (the JAX package's
    order; any consistent K permutation leaves XXᵀ unchanged)."""
    n, w = packed.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=packed.device)
    bits = (packed[:, None, :] >> shifts[None, :, None]) & 1
    return bits.to(torch.int8).reshape(n, WORD_BITS * w)


def int8_dot_nt(ua: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """int32 [Na, Nb] = ua · ubᵀ for int8 {0,1} operands [Na, K], [Nb, K].

    On a card: ``torch._int_mm``, zero-padded to its shape rules (more
    than 16 rows; K and the column count multiples of 8) — zero rows and
    columns add nothing, so the padding is exact. On the CPU: an int64
    product."""
    m, k = ua.shape
    n = ub.shape[0]
    if ua.is_cuda:
        mp = _round_up(max(m, 17), 8)
        kp = _round_up(max(k, 8), 8)
        np_ = _round_up(max(n, 8), 8)
        a = F.pad(ua, (0, kp - k, 0, mp - m))
        b = F.pad(ub, (0, kp - k, 0, np_ - n))
        return torch._int_mm(a, b.t())[:m, :n]
    return (ua.to(torch.int64) @ ub.to(torch.int64).T).to(torch.int32)


def count_block_int8_xla(
    a_packed: torch.Tensor, b_packed: torch.Tensor
) -> torch.Tensor:
    """Cross-block counts int32 [Na, Nb] via an int8 product (materializes
    the 8× unpacked operands — small M only)."""
    return int8_dot_nt(unpack_to_int8(a_packed), unpack_to_int8(b_packed))


def count_matrix_int8_xla(packed: torch.Tensor) -> torch.Tensor:
    """Full N×N counts via the int8 path (materializes the unpacked
    operand — use the K2 kernel for large M)."""
    ua = unpack_to_int8(packed)
    return int8_dot_nt(ua, ua)
