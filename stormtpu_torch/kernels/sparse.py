"""K3 and K4: the sparse regime (port of ``stormtpu/kernels/sparse.py``).

- **K3** (``count_block_sparse``): from sorted int32 position lists padded
  to a common length with the sentinel ``m_bits``, the sizes of the lists'
  intersections. Each element of a row of A is looked up in a row of B
  with ``torch.searchsorted``; a hit counts when the element found equals
  it and it is not the sentinel. It runs with torch on the caller's device
  (the CPU form is the same code), rows of A in blocks whose intermediate
  fits a budget read from the device.
- **K4** (``count_matrix_sparse_outer``): the inverted index, on the host
  in C++ (``stormtpu_torch.native``): for each occupied column, every pair
  of its rows (a < b) adds 1 to C[a, b]; the diagonal is the row's nnz and
  the lower triangle is mirrored. Work is O(nnz + Σ_c occupancy²),
  independent of M. Without the C++ tier its NumPy form
  (``count_matrix_sparse_outer_plain``) takes its place, with the JAX
  package's refusals.

Layout of the K3 operands: position lists padded to a common length L (a
multiple of 128) with the sentinel ``m_bits``, which no position equals,
so each row stays sorted with its padding at the tail.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stormtpu_torch import native
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.layout import BitMatrix
from stormtpu_torch.utils import download, resolve_device, round_up

__all__ = [
    "K3_BYTES_PER_LOOKUP",
    "K4_MAX_N",
    "check_k4_rows",
    "padded_position_lists",
    "count_block_sparse",
    "count_matrix_sparse",
    "count_matrix_sparse_outer",
    "count_matrix_sparse_outer_plain",
    "k3_block_rows",
    "reset_launches",
    "unique_int64",
]

# Device bytes K3 holds per lookup of a row block: the repeated A values
# (int32), the insertion points (int64), the elements found (int32) and
# three boolean masks.
K3_BYTES_PER_LOOKUP = 19

# K4's single-shot count buffer is N² int32 on the host; above this N it
# passes 4 GB and the streamed walk is the route.
K4_MAX_N = 32768

# K3 blocks launched on a CUDA device since the last reset.
LAUNCHES = {"k3": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unique_int64(keys: np.ndarray, *, presorted: bool = False, return_counts: bool = False):
    """``np.unique`` of integer keys (sorted unique values, and their
    counts when asked), by one sort and a comparison of neighbours: the
    same values. ``np.unique`` itself took 1.06 µs a key on the card's host
    (NumPy 2.3.5; ``scripts/torch_k4_constants.py`` times both).
    ``presorted``: the keys are sorted already."""
    k = np.asarray(keys) if presorted else np.sort(keys)
    first = np.empty(k.size, dtype=bool)
    first[:1] = True
    np.not_equal(k[1:], k[:-1], out=first[1:])
    if not return_counts:
        return k[first]
    starts = np.flatnonzero(first)
    return k[starts], np.diff(np.append(starts, k.size))


def padded_position_lists(bm: BitMatrix, pad_mult: int = 128) -> np.ndarray:
    """int32 [N, L] sorted positions per row, tail-padded with m_bits."""
    indptr, indices = bm.positions_csr()
    lens = np.diff(indptr)
    lmax = int(lens.max(initial=0))
    out = np.full((bm.n, round_up(max(lmax, 1), pad_mult)), bm.m_bits, dtype=np.int32)
    rows = np.repeat(np.arange(bm.n), lens)
    out[rows, np.arange(indices.size) - indptr[rows]] = indices
    return out


def k3_block_rows(nb: int, l: int, device) -> int:
    """Rows of A a K3 block takes: as many as keep the block's
    [rows, Nb, L] intermediate (``K3_BYTES_PER_LOOKUP`` a lookup) within a
    quarter of what the device has free (``stream._device_refuse_budget``:
    the card's free memory, or the host's on the CPU)."""
    from stormtpu_torch.stream import _device_refuse_budget

    per_row = K3_BYTES_PER_LOOKUP * max(nb, 1) * max(l, 1)
    return max(1, _device_refuse_budget(device) // 4 // per_row)


def count_block_sparse(
    pos_a: torch.Tensor,
    pos_b: torch.Tensor,
    *,
    sentinel: int,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Cross counts int32 [Na, Nb], on the operands' device, from padded
    sorted int32 position lists ``pos_a`` [Na, La] and ``pos_b`` [Nb, Lb].

    Rows of A go through in blocks of ``block_rows`` (default:
    :func:`k3_block_rows`): a block's values are searched in every row of B
    at once, ``torch.searchsorted`` over the rows of ``pos_b`` as they lie.
    """
    if pos_a.device != pos_b.device:
        raise ValueError(f"pos_a lies on {pos_a.device}, pos_b on {pos_b.device}")
    if pos_a.dtype != torch.int32 or pos_b.dtype != torch.int32:
        raise TypeError(f"want int32 position lists, got {pos_a.dtype} and {pos_b.dtype}")
    dev = pos_a.device
    na, la = pos_a.shape
    nb, lb = pos_b.shape
    out = torch.zeros((na, nb), dtype=torch.int32, device=dev)
    if na == 0 or nb == 0 or la == 0 or lb == 0:
        return out
    if block_rows is None:
        block_rows = k3_block_rows(nb, la, dev)
    sorted_b = pos_b.contiguous()
    for r0 in range(0, na, block_rows):
        blk = pos_a[r0 : r0 + block_rows]
        rows = blk.shape[0]
        vals = blk.reshape(1, -1).expand(nb, -1).contiguous()       # [Nb, rows·La]
        idx = torch.searchsorted(sorted_b, vals).clamp_(max=lb - 1)
        hit = (torch.gather(sorted_b, 1, idx) == vals) & (vals != sentinel)
        out[r0 : r0 + rows] = hit.view(nb, rows, la).sum(dim=2, dtype=torch.int32).t()
        del vals, idx, hit
        if dev.type == "cuda":
            LAUNCHES["k3"] += 1
    return out


def count_matrix_sparse(
    bm: BitMatrix,
    *,
    config: Optional[EngineConfig] = None,
    device=None,
) -> np.ndarray:
    """Full N×N exact counts, numpy int32, by K3 on ``device`` (``None``:
    the card) from the padded position lists of every row."""
    del config  # the block size comes from the device; kept for dispatch symmetry
    dev = resolve_device(device)
    pos = torch.from_numpy(padded_position_lists(bm)).to(dev)
    out = count_block_sparse(pos, pos, sentinel=bm.m_bits)
    del pos
    return download(out)


def check_k4_rows(n: int) -> None:
    """Raise ``ValueError`` when K4's N² int32 buffer would pass 4 GB."""
    if n > K4_MAX_N:
        raise ValueError(
            f"K4's N²-int32 count buffer is impractical at n={n} "
            f"(> 4 GB); use a dense or streaming strategy"
        )


def _sorted_coo(bm: BitMatrix) -> tuple[np.ndarray, np.ndarray]:
    """(columns int64, rows int32) of every set bit, deduplicated and
    sorted by (column, row), from the ingest-time COO."""
    rows_c, cols_c = bm.coo
    keys = unique_int64(cols_c * np.int64(bm.n) + rows_c)
    return keys // bm.n, (keys % bm.n).astype(np.int32)


def count_matrix_sparse_outer(
    bm: BitMatrix,
    *,
    config: Optional[EngineConfig] = None,
    max_col_occupancy_factor: float = 8.0,
) -> np.ndarray:
    """Full N×N exact counts, numpy int32, by K4 on the host.

    With the ingest-time COO (``bm.coo``) the positions are sorted by
    column with one sort (:func:`unique_int64`) and the C++ run walk emits the pairs:
    no O(N·W) scan and no O(M) arrays. Without it, the C++ tier sorts by
    column from the packed words itself (two scans). Without the C++
    tier, a NumPy emission over per-column row lists padded to the
    longest; it refuses (``ValueError``) when it would densify the matrix
    (no COO and M > 2²²), when a column is far fuller than the mean, and
    when its emission matrix would pass 2²⁸ entries.
    """
    del config
    n = bm.n
    check_k4_rows(n)
    if n < 2:
        out = np.zeros((n, n), dtype=np.int32)
        if n == 1:
            out[0, 0] = int(bm.row_nnz[0])
        return out

    upper = None
    if bm.coo is not None and native.have_native():
        upper = native.sparse_outer_runs_native(*_sorted_coo(bm), n)
    if upper is None:
        upper = native.sparse_outer_from_packed_native(bm.packed, bm.m_bits)
    if upper is not None:
        # the C++ tier filled the diagonal and the strict upper triangle
        native.mirror_upper_native(upper)
        return upper
    return count_matrix_sparse_outer_plain(
        bm, max_col_occupancy_factor=max_col_occupancy_factor)


def count_matrix_sparse_outer_plain(
    bm: BitMatrix, *, max_col_occupancy_factor: float = 8.0
) -> np.ndarray:
    """K4's NumPy form, its fallback without the C++ tier: the per-column
    row lists padded to the longest, every pair emitted at once,
    ``np.add.at``. The COO cache comes first (``positions_csr``'s own
    fallback unpacks the matrix). Refuses with ``ValueError`` where its
    buffers would be unreasonable (see :func:`count_matrix_sparse_outer`)."""
    n = bm.n
    if n < 2:
        return count_matrix_sparse_outer(bm)
    if bm.coo is not None:
        cols_s, rows_s = _sorted_coo(bm)
        nnz = rows_s.size
    else:
        if bm.m_bits > 1 << 22:
            raise ValueError(
                "K4 NumPy fallback without a COO cache would densify the "
                f"matrix to extract positions (N×{bm.m_bits} bytes) — "
                "build stormtpu_torch/native or use a dense strategy"
            )
        indptr, indices = bm.positions_csr()
        nnz = int(indptr[-1])
        rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
        order = np.argsort(indices, kind="stable")
        cols_s = indices[order]
        rows_s = rows[order]
    if nnz == 0:
        return np.zeros((n, n), dtype=np.int32)
    col_starts = np.flatnonzero(np.r_[True, cols_s[1:] != cols_s[:-1]])
    col_counts = np.diff(np.r_[col_starts, nnz])
    rmax = int(col_counts.max())
    mean_occ = nnz / len(col_starts)
    if rmax > max(8.0, max_col_occupancy_factor * mean_occ):
        raise ValueError(
            f"clustered column occupancy (max {rmax} vs mean {mean_occ:.1f}) "
            f"would pad the fallback emission matrix {rmax / mean_occ:.0f}× "
            f"— build stormtpu_torch/native or use a dense strategy"
        )
    if len(col_starts) * rmax * rmax > 1 << 28:
        raise ValueError(
            f"fallback emission matrix would be "
            f"{len(col_starts) * rmax * rmax * 8 / 2**30:.1f} GiB — build "
            f"stormtpu_torch/native or use a dense strategy"
        )
    colrows = np.full((len(col_starts), rmax), n, dtype=np.int32)
    offsets = np.arange(nnz) - np.repeat(col_starts, col_counts)
    colrows[np.repeat(np.arange(len(col_starts)), col_counts), offsets] = rows_s
    ii = colrows[:, :, None]
    jj = colrows[:, None, :]
    valid = (ii < jj) & (jj < n)
    keys = np.where(valid, ii.astype(np.int64) * n + jj, n * n).ravel()
    buf = np.zeros(n * n + 1, dtype=np.int32)
    np.add.at(buf, keys, 1)
    upper = buf[: n * n].reshape(n, n)
    out = upper + upper.T
    out[np.arange(n), np.arange(n)] = bm.row_nnz.astype(np.int32)
    return out
