"""K3 and K4: the sparse regime (port of ``stormtpu/kernels/sparse.py``).

- **K3** (``count_block_sparse``): from sorted int32 position lists padded
  to a common length with the sentinel ``m_bits``, the sizes of the lists'
  intersections. Each element of a row of A is looked up in a row of B
  with ``torch.searchsorted``; a hit counts when the element found equals
  it and it is not the sentinel. It runs with torch on the caller's device
  (the CPU form is the same code), rows of A in blocks whose intermediate
  fits a budget read from the device.
- **K4** (``count_matrix_sparse_outer``): the inverted index: for each
  occupied column, every pair of its rows (a < b) adds 1 to C[a, b]; the
  diagonal is the row's nnz and the lower triangle is mirrored. Work is
  O(nnz + Σ_c occupancy²), independent of M. On a card it runs in the
  hand-written CUDA kernels of ``csrc/k4_sparse.cu`` (:func:`k4_emit`,
  :func:`k4_mirror`), and a build or launch failure raises. On the CPU it
  runs on the host in C++ (``stormtpu_torch.native``); without the C++
  tier its NumPy form (``count_matrix_sparse_outer_plain``) takes its
  place, with the JAX package's refusals. The kernels' plain PyTorch
  versions (:func:`k4_emit_plain`, :func:`k4_mirror_plain`) serve CPU
  tensors.

Layout of the K3 operands: position lists padded to a common length L (a
multiple of 128) with the sentinel ``m_bits``, which no position equals,
so each row stays sorted with its padding at the tail.

Layout of the K4 operands: rows (int32) of a column-sorted, de-duplicated
(column, row) list, rows ascending within a column, and its segments: the
shared columns, each with the offset and length of its row run on each
side (int64), and the exclusive prefix of their emission counts (int64,
one longer). The triangle form (one list) emits every x < y of a run,
p(p−1)/2 of them; the rectangle form (two lists) every (x, y), p·q.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from stormtpu_torch import native
from stormtpu_torch.config import EngineConfig
from stormtpu_torch.layout import BitMatrix
from stormtpu_torch.utils import download, profiling, resolve_device, round_up

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
    "k4_emit",
    "k4_emit_plain",
    "k4_mirror",
    "k4_mirror_plain",
    "k4_rect",
    "k4_runs",
    "k4_square",
    "reset_launches",
    "unique_int64",
]

_stage = functools.partial(profiling.stage, "kernels")

# Device bytes K3 holds per lookup of a row block: the repeated A values
# (int32), the insertion points (int64), the elements found (int32) and
# three boolean masks.
K3_BYTES_PER_LOOKUP = 19

# K4's single-shot count matrix is N² int32 (on the card, and on the host
# it is downloaded to); above this N it passes 4 GB and the streamed walk
# is the route.
K4_MAX_N = 32768

# Emissions the plain K4 version decodes at once: its int64 intermediates
# stay near 2 GiB however many emissions a call has.
K4_PLAIN_CHUNK = 1 << 26

# Launches on a CUDA device since the last reset: K3 blocks, K4's emission
# kernel and K4's mirror kernel.
LAUNCHES = {"k3": 0, "k4": 0, "k4_mirror": 0}


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


# ------------------------------------------------------------------ K4
def k4_runs(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(offsets, lengths), int64, of the runs of equal values in the sorted
    ``cols`` that are two or more long (a run of one emits no pair), on
    its device."""
    if cols.numel() == 0:
        z = torch.zeros(0, dtype=torch.int64, device=cols.device)
        return z, z
    _, lens = torch.unique_consecutive(cols, return_counts=True)
    offs = torch.cumsum(lens, 0) - lens
    keep = lens >= 2
    return offs[keep].contiguous(), lens[keep].contiguous()


def _emission_prefix(per_segment: torch.Tensor) -> torch.Tensor:
    """int64 [S + 1]: the exclusive prefix of the segments' emission counts."""
    prefix = torch.zeros(per_segment.numel() + 1, dtype=torch.int64, device=per_segment.device)
    torch.cumsum(per_segment, 0, out=prefix[1:])
    return prefix


def _check_k4_operands(rows_a, rows_b, segments, prefix, out) -> None:
    names = ("rows_a", "rows_b", "off_a", "len_a", "off_b", "len_b", "prefix")
    for name, t in zip(names, (rows_a, rows_b, *segments, prefix)):
        want = torch.int32 if name.startswith("rows") else torch.int64
        if t.dtype != want or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"k4_emit: {name} must be contiguous 1-D {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != out.device:
            raise ValueError(f"k4_emit: {name} lies on {t.device}, out on {out.device}")
    n_seg = prefix.numel() - 1
    if n_seg < 0:
        raise ValueError("k4_emit: prefix must hold at least one entry")
    for name, t in zip(names[2:6], segments):
        if t.numel() != n_seg:
            raise ValueError(f"k4_emit: {name} has {t.numel()} segments, prefix {n_seg}")
    if out.dtype != torch.int32 or out.dim() != 2 or not out.is_contiguous():
        raise ValueError(f"k4_emit: out must be a contiguous 2-D int32 matrix, got "
                         f"{out.dtype} {tuple(out.shape)}")


def k4_emit(
    rows_a: torch.Tensor,
    rows_b: torch.Tensor,
    off_a: torch.Tensor,
    len_a: torch.Tensor,
    off_b: torch.Tensor,
    len_b: torch.Tensor,
    prefix: torch.Tensor,
    out: torch.Tensor,
    *,
    triangle: bool,
) -> None:
    """Add K4's emissions into ``out`` (int32 [na, ld], in place) from the
    segments (``off_*``, ``len_*``: int64 [S]) over the row lists
    ``rows_a`` / ``rows_b`` (int32) with their emission prefix ``prefix``
    (int64 [S + 1], every segment's count at least 1). ``triangle``: one
    list (``rows_b``, ``off_b`` and ``len_b`` are not read), every x < y
    of a run into out[rows[x], rows[y]]; else every (x, y) into
    out[rows_a[x], rows_b[y]].

    A CUDA tensor runs the kernel ``k4_emit_launch`` of
    ``csrc/k4_sparse.cu`` (no launch at no emissions); a CPU tensor takes
    :func:`k4_emit_plain`."""
    _check_k4_operands(rows_a, rows_b, (off_a, len_a, off_b, len_b), prefix, out)
    if out.device.type == "cpu":
        k4_emit_plain(rows_a, rows_b, off_a, len_a, off_b, len_b, prefix, out,
                      triangle=triangle)
        return
    if out.device.type != "cuda":
        raise ValueError(f"k4_emit: unsupported device {out.device}")
    n_seg = prefix.numel() - 1
    total = int(prefix[-1]) if n_seg else 0
    if total == 0:
        return
    from stormtpu_torch.kernels._build import library

    lib = library("k4_sparse")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k4_emit_launch(
            rows_a.data_ptr(), rows_b.data_ptr(), off_a.data_ptr(), len_a.data_ptr(),
            off_b.data_ptr(), len_b.data_ptr(), prefix.data_ptr(), n_seg, total,
            int(triangle), out.data_ptr(), out.shape[1], stream,
        )
    if err:
        raise RuntimeError(f"k4_emit_launch failed: CUDA error {err}")
    LAUNCHES["k4"] += 1


def k4_emit_plain(
    rows_a: torch.Tensor,
    rows_b: torch.Tensor,
    off_a: torch.Tensor,
    len_a: torch.Tensor,
    off_b: torch.Tensor,
    len_b: torch.Tensor,
    prefix: torch.Tensor,
    out: torch.Tensor,
    *,
    triangle: bool,
) -> None:
    """:func:`k4_emit` in plain PyTorch, on the operands' device: the flat
    emission range in chunks of ``K4_PLAIN_CHUNK``, each emission's segment
    by ``torch.searchsorted`` over the prefix, its (x, y) decoded from its
    index as the kernel decodes it, accumulated by ``index_put_``."""
    total = int(prefix[-1]) if prefix.numel() > 1 else 0
    flat = out.view(-1)
    ld = out.shape[1]
    for e0 in range(0, total, K4_PLAIN_CHUNK):
        e = torch.arange(e0, min(e0 + K4_PLAIN_CHUNK, total), dtype=torch.int64,
                         device=out.device)
        s = torch.searchsorted(prefix, e, right=True) - 1
        t = e - prefix[s]
        if triangle:
            p = len_a[s]
            b = (2 * p - 1).double()
            x = ((b - torch.sqrt(b * b - 8.0 * t.double())) * 0.5).long()
            x = torch.minimum(torch.clamp(x, min=0), p - 2)
            # the square root is exact to a few ulps: step to the true row
            x = torch.where(x * (2 * p - 1 - x) // 2 > t, x - 1, x)
            x = torch.where((x + 1) * (2 * p - 2 - x) // 2 <= t, x + 1, x)
            y = x + 1 + t - x * (2 * p - 1 - x) // 2
            a = rows_a[off_a[s] + x]
            bb = rows_a[off_a[s] + y]
        else:
            q = len_b[s]
            a = rows_a[off_a[s] + t // q]
            bb = rows_b[off_b[s] + t % q]
        key = a.long() * ld + bb.long()
        flat.index_put_((key,), torch.ones(key.numel(), dtype=out.dtype, device=out.device),
                        accumulate=True)
        del e, s, t, a, bb, key


def k4_mirror(out: torch.Tensor, diag: Optional[torch.Tensor] = None) -> None:
    """Copy the strict upper triangle of ``out`` (int32 [n, n], in place)
    into the lower one, and write ``diag`` (int32 [n]) on the diagonal
    (``None``: the diagonal stays). A CUDA tensor runs the kernel
    ``k4_mirror_launch`` of ``csrc/k4_sparse.cu``; a CPU tensor takes
    :func:`k4_mirror_plain`."""
    if out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != out.shape[1] \
            or not out.is_contiguous():
        raise ValueError(f"k4_mirror: want a contiguous square int32 matrix, got "
                         f"{out.dtype} {tuple(out.shape)}")
    n = out.shape[0]
    if diag is not None:
        if diag.dtype != torch.int32 or diag.shape != (n,) or not diag.is_contiguous():
            raise ValueError(f"k4_mirror: diag must be contiguous int32 [{n}], got "
                             f"{diag.dtype} {tuple(diag.shape)}")
        if diag.device != out.device:
            raise ValueError(f"k4_mirror: diag lies on {diag.device}, out on {out.device}")
    if out.device.type == "cpu":
        k4_mirror_plain(out, diag)
        return
    if out.device.type != "cuda":
        raise ValueError(f"k4_mirror: unsupported device {out.device}")
    if n == 0:
        return
    from stormtpu_torch.kernels._build import library

    lib = library("k4_sparse")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k4_mirror_launch(out.data_ptr(), 0 if diag is None else diag.data_ptr(),
                                   n, n, stream)
    if err:
        raise RuntimeError(f"k4_mirror_launch failed: CUDA error {err}")
    LAUNCHES["k4_mirror"] += 1


def k4_mirror_plain(out: torch.Tensor, diag: Optional[torch.Tensor] = None) -> None:
    """:func:`k4_mirror` in plain PyTorch, in place."""
    upper = torch.triu(out, 1)
    keep = out.diagonal().clone() if diag is None else diag
    out.copy_(upper + upper.T)
    out.diagonal().copy_(keep)


def k4_square(rows: torch.Tensor, off: torch.Tensor, lens: torch.Tensor, n: int,
              diag: torch.Tensor) -> torch.Tensor:
    """int32 [n, n] on ``rows``' device: the triangle form over the runs
    (``off``, ``lens``: int64, every run at least 2 long) of the row list
    ``rows``, mirrored, with ``diag`` on the diagonal. The output is
    allocated and zeroed here."""
    out = torch.zeros((n, n), dtype=torch.int32, device=rows.device)
    prefix = _emission_prefix(lens * (lens - 1) // 2)
    k4_emit(rows, rows, off, lens, off, lens, prefix, out, triangle=True)
    k4_mirror(out, diag)
    return out


def k4_rect(rows_a: torch.Tensor, off_a: torch.Tensor, len_a: torch.Tensor,
            rows_b: torch.Tensor, off_b: torch.Tensor, len_b: torch.Tensor,
            na: int, nb: int) -> torch.Tensor:
    """int32 [na, nb] on ``rows_a``' device: the rectangle form over the
    shared columns' runs (``off_a``/``len_a`` into ``rows_a``,
    ``off_b``/``len_b`` into ``rows_b``). The output is allocated and
    zeroed here."""
    out = torch.zeros((na, nb), dtype=torch.int32, device=rows_a.device)
    prefix = _emission_prefix(len_a * len_b)
    k4_emit(rows_a, rows_b, off_a, len_a, off_b, len_b, prefix, out, triangle=False)
    return out


def _k4_sorted_rows(bm: BitMatrix, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(columns int64, rows int32) of every set bit on ``dev``, de-duplicated
    and sorted by (column, row): from the ingest-time COO where it is kept,
    else from ``positions_csr`` (the C++ tier's extraction). The keys are
    made and sorted on ``dev``."""
    n = bm.n
    with _stage("upload", dev):
        if bm.coo is not None:
            rows_c, cols_c = (torch.from_numpy(a).to(dev) for a in bm.coo)
        else:
            indptr, indices = bm.positions_csr()
            cols_c = torch.from_numpy(indices).to(dev)
            rows_c = torch.repeat_interleave(
                torch.arange(n, device=dev), torch.from_numpy(np.diff(indptr)).to(dev))
    with _stage("sort", dev):
        keys = torch.unique(cols_c.long() * n + rows_c.long())  # sorted
        del rows_c, cols_c
        cols = keys // n
        rows = (keys - cols * n).int()
    return cols, rows


def _k4_matrix(bm: BitMatrix, dev: torch.device) -> torch.Tensor:
    """K4's N×N int32 counts (N ≥ 2) as a tensor on ``dev``: the sorted
    list (:func:`_k4_sorted_rows`), its runs of two rows or more, the
    triangle form, and the mirror with the rows' nnz on the diagonal. On
    the CPU every step is the kernels' plain version (the tests' route)."""
    cols, rows = _k4_sorted_rows(bm, dev)
    with _stage("upload", dev):
        diag = torch.from_numpy(bm.row_nnz.astype(np.int32)).to(dev)
    with _stage("sort", dev):
        off, lens = k4_runs(cols)
        del cols
    with _stage("emit", dev):
        out = torch.zeros((bm.n, bm.n), dtype=torch.int32, device=dev)
        k4_emit(rows, rows, off, lens, off, lens, _emission_prefix(lens * (lens - 1) // 2),
                out, triangle=True)
    with _stage("mirror", dev):
        k4_mirror(out, diag)
    return out


def count_matrix_sparse_outer(
    bm: BitMatrix,
    *,
    config: Optional[EngineConfig] = None,
    max_col_occupancy_factor: float = 8.0,
    device=None,
) -> np.ndarray:
    """Full N×N exact counts, numpy int32, by K4 on ``device`` (``None``:
    the card).

    On a card the (column, row) keys are made, sorted and de-duplicated
    there (:func:`_k4_sorted_rows`), the triangle form (:func:`k4_emit`)
    runs over the columns shared by two rows or more, the mirror
    (:func:`k4_mirror`) writes the lower triangle and the diagonal from the
    rows' nnz, and the matrix is downloaded (``utils.download``). A build or
    launch failure raises. On the CPU: with the ingest-time COO
    (``bm.coo``) the positions are sorted by column with one sort
    (:func:`unique_int64`) and the C++ run walk emits the pairs; without
    it, the C++ tier sorts by column from the packed words itself (two
    scans). Without the C++ tier, a NumPy emission over per-column row
    lists padded to the longest; it refuses (``ValueError``) when it would
    densify the matrix (no COO and M > 2²²), when a column is far fuller
    than the mean, and when its emission matrix would pass 2²⁸ entries.
    """
    del config
    n = bm.n
    check_k4_rows(n)
    if n < 2:
        out = np.zeros((n, n), dtype=np.int32)
        if n == 1:
            out[0, 0] = int(bm.row_nnz[0])
        return out

    dev = resolve_device(device)
    if dev.type == "cuda":
        out = _k4_matrix(bm, dev)
        with _stage("download", dev):
            return download(out)

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
        return count_matrix_sparse_outer(bm, device="cpu")
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
