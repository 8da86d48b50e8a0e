"""The streamed screen's compaction (``csrc/stripe_screen.cu``): the pairs
of one int32 count stripe whose float32 screen value reaches a threshold,
as (local row, local column, count) in a bounded int32 buffer.

No TPU kernel is replaced: the JAX package screens a stripe with jitted
reductions (``stormtpu/stream_query.py``, ``stream_pairs_above``). The
kernel is bound by one read of the stripe; its source says how it keeps to
that. :func:`stripe_screen` launches it for a CUDA tensor and takes the
plain form :func:`stripe_screen_plain` for a CPU one.

Buffer layout (:func:`hit_buffer`): int32 [1 + 3·cap]; element 0 is the
number of hits, all of them, past ``cap`` too, so that an overflow shows;
hit k, for k < min(total, cap), is elements 1 + 3k .. 3 + 3k. The kernel
writes its hits in the order of its atomics; the plain form row-major.
"""

from __future__ import annotations

import torch

__all__ = ["MEASURES", "hit_buffer", "reset_launches", "stripe_screen", "stripe_screen_plain"]

# the measures in the order of the kernel's ``Measure`` codes
MEASURES = ("count", "jaccard", "dice", "cosine", "overlap", "phi", "r2")

LAUNCHES = {"stripe_screen": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def hit_buffer(cap: int, device) -> torch.Tensor:
    """An int32 buffer of room for ``cap`` hits, uninitialised (the
    screen writes its total first)."""
    return torch.empty(1 + 3 * cap, dtype=torch.int32, device=device)


def _valid(row0: int, size: int, n: int) -> int:
    return max(0, min(size, n - row0))


def stripe_screen(counts: torch.Tensor, nnz_rows: torch.Tensor, nnz_cols: torch.Tensor,
                  row0: int, col0: int, n: int, thresh: float, m_f: float, measure: str,
                  out: torch.Tensor) -> None:
    """Screen ``counts`` (int32 [R, C], the global rows row0 + r and
    columns col0 + c) into ``out`` (:func:`hit_buffer`): the pairs with
    ``query._screen_vals(...) >= thresh`` (float32, the rows' and columns'
    set bits ``nnz_rows`` [R] and ``nnz_cols`` [C], int32) in the global
    strict upper triangle, rows and columns below ``n``."""
    if measure not in MEASURES:
        raise ValueError(f"stripe_screen: unknown measure {measure!r}")
    if counts.dtype != torch.int32 or counts.dim() != 2:
        raise ValueError(f"stripe_screen: counts must be a 2-D int32 stripe, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    r, c = counts.shape
    for name, t, size in (("nnz_rows", nnz_rows, r), ("nnz_cols", nnz_cols, c)):
        if t.dtype != torch.int32 or t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"stripe_screen: {name} must be contiguous int32 [{size}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out.dtype != torch.int32 or out.dim() != 1 or out.numel() < 1 or not out.is_contiguous():
        raise ValueError("stripe_screen: out must be a contiguous int32 hit buffer")
    for t in (nnz_rows, nnz_cols, out):
        if t.device != counts.device:
            raise ValueError(f"stripe_screen: operands on {t.device} and {counts.device}")
    if counts.device.type == "cpu":
        stripe_screen_plain(counts, nnz_rows, nnz_cols, row0, col0, n, thresh, m_f, measure,
                            out)
        return
    if counts.device.type != "cuda":
        raise ValueError(f"stripe_screen: unsupported device {counts.device}")
    if counts.stride(1) != 1:
        counts = counts.contiguous()
    from stormtpu_torch.kernels._build import library

    lib = library("stripe_screen")
    with torch.cuda.device(counts.device):
        err = lib.stripe_screen_launch(
            counts.data_ptr(), counts.stride(0), _valid(row0, r, n), _valid(col0, c, n),
            nnz_rows.data_ptr(), nnz_cols.data_ptr(), col0 - row0, MEASURES.index(measure),
            thresh, m_f, out.data_ptr(), (out.numel() - 1) // 3,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stripe_screen_launch failed: CUDA error {err}")
    LAUNCHES["stripe_screen"] += 1


def stripe_screen_plain(counts: torch.Tensor, nnz_rows: torch.Tensor, nnz_cols: torch.Tensor,
                        row0: int, col0: int, n: int, thresh: float, m_f: float, measure: str,
                        out: torch.Tensor) -> None:
    """:func:`stripe_screen` in plain PyTorch on the operands' device, its
    hits row-major."""
    from stormtpu_torch.query import _screen_vals

    vals = _screen_vals(counts, nnz_rows, nnz_cols, m_f, measure)
    rows = torch.arange(counts.shape[0], device=counts.device)[:, None] + row0
    cols = torch.arange(counts.shape[1], device=counts.device)[None, :] + col0
    li, lj = torch.nonzero((vals >= thresh) & (cols > rows) & (rows < n) & (cols < n),
                           as_tuple=True)
    k = min(li.numel(), (out.numel() - 1) // 3)
    out[0] = li.numel()
    li, lj = li[:k], lj[:k]
    out[1:1 + 3 * k] = torch.stack([li, lj, counts[li, lj].long()], dim=1).view(-1).to(torch.int32)
