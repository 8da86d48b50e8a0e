"""K2 — exact all-pairs counts on the tensor cores, straight from the
packed words (port of ``stormtpu/kernels/mxu.py``).

Four kernel wrappers, each with its plain PyTorch version beside it and a
launch counter (``LAUNCHES``):

- :func:`count_tiles_pallas_mxu` — the triangular tile list (CUDA entry
  ``k2_tri_launch`` in ``csrc/k2_mxu.cu``);
- :func:`count_block_pallas_mxu` — the rectangular grid
  (``k2_rect_tma_launch``);
- :func:`count_tiles_topk` — K2-topk: the tile list's per-row and
  per-column top-k candidate sets, the tiles never stored
  (``k2_topk_launch`` in ``csrc/k2_epilogue.cu``);
- :func:`count_tiles_hist` — K2-hist: the bin counts of the tile list's
  valid pairs (``k2_hist_launch``).

What is padded, and why. The JAX package pads every operand to whole
tiles, rows and words, and the plain versions keep that geometry: they
unpack whole K steps of ``tile_words`` words. The CUDA kernels mask the
ragged row edges themselves and load a row as 16-byte vectors of 4 words.
So K2-rect's card route (:func:`count_block_pallas_mxu` on card operands)
pads no rows: an operand that is contiguous, 16-byte aligned int32 with
W % 4 == 0 goes in as it is, any other is copied with its words padded to a
multiple of 4 (:func:`rect_operand`). CPU operands are padded to the tile
for the plain version (:func:`_count_block_padded`). The tile walks'
operands (K2-tri, K2-topk, K2-hist) are padded to the tile by their
callers, which index tiles by row block.

The callers choose between the two epilogue kernels and storing the tiles
by dispatch rules named here (:func:`topk_route`, :func:`hist_route`).

A tensor on the CPU takes the plain version; a tensor on the card
launches the CUDA kernel, or raises. There is no fall back from one to
the other.

The JAX kernels unpack bits to int8 {0,1} and take an int8 product. The
CUDA kernel takes the tensor cores' binary product (AND + popcount over
256 bits a step) of the packed words as they are, so nothing is unpacked
anywhere. The plain versions keep the int8 form and unpack one K step
(``tile_words`` words) at a time.

Each wrapper launches one kernel body. K2-tri's tile body
(``csrc/tile_body.cuh``) is fed by the threads' ``cp.async``. K2-topk,
K2-hist and K2-rect run on the TMA body (``csrc/tile_body_tma.cuh``: TMA
loads, a producer warpgroup, and clusters of two blocks sharing their B
rows by multicast where the shape lets them pair: :func:`epilogue_cluster`,
:func:`rect_cluster`).

Exactness: products are 0/1 and sums are int32, exact for M < 2³¹
(``EngineConfig.validate``). ``variant`` ("concat" or "planes") selects
between the JAX package's two Pallas bodies; it is accepted for parity
and has no effect here — both compute the same counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from stormtpu_torch.config import EngineConfig, default_config
from stormtpu_torch.kernels.xla import int8_dot_nt, unpack_to_int8
from stormtpu_torch.utils import (
    profiling,
    assemble_triangular_torch,
    download,
    round_up,
    triangular_tile_ids,
)

__all__ = [
    "LAUNCHES",
    "DeviceTileIds",
    "device_tile_ids",
    "k2_tile_shape",
    "count_tiles_pallas_mxu",
    "count_tiles_plain",
    "count_tiles_topk",
    "count_tiles_topk_plain",
    "count_tiles_hist",
    "count_tiles_hist_plain",
    "TileTopk",
    "TOPK_EPI_MAX",
    "HIST_EPI_MAX_BINS",
    "ROUTE_TOPK",
    "ROUTE_HIST",
    "topk_route",
    "hist_route",
    "count_block_plain",
    "count_block_pallas_mxu",
    "rect_operand",
    "rect_cluster",
    "count_matrix_pallas_mxu",
    "reset_launches",
]

_VARIANTS = ("concat", "planes")

# CUDA launches per kernel wrapper; the plain versions do not count.
LAUNCHES = {"k2_tri": 0, "k2_rect": 0, "k2_topk": 0, "k2_hist": 0}

# The epilogue kernels' limits, which the dispatch rules read at call time:
# K2-topk keeps rank r of a set in lane r of a warp (k ≤ 32), K2-hist a
# sub-histogram of HIST_EPI_MAX_BINS bins a warp in the kernel's shared memory.
TOPK_EPI_MAX = 32
HIST_EPI_MAX_BINS = 4096
# The sub-tile (rows, columns) one block of K2-tri reduces: K2-topk gives
# one candidate set a row and a column of each, and the plain versions lay
# their sets out the same way.
EPI_BLOCK = (128, 256)

# K2-rect loads a row's words as whole 16-byte vectors, so its card route
# (count_block_pallas_mxu) takes rows of a multiple of 4 words; its output
# pitch is the same multiple, which keeps the int2 stores aligned and gives
# an odd Nb's last store a column to spare.
RECT_WORD_ALIGN = 4
# The A rows (a sub-tile row) and the B rows of one K2-rect block: the shape
# rule (:func:`rect_cluster`) and the launch's limits count in them.
RECT_BLOCK_ROWS = 128
RECT_BLOCK_COLS = 256
# K2-rect's TMA coordinates (rows, words) and its count of blocks are int32.
_RECT_INT_LIMIT = 1 << 31

# Dispatch routes of a reduction over K2-tri's tiles, by the names that
# ``utils.profiling.record_stages`` records (and ``routes.<name>`` counts)
# and the ``[breakdown]`` lines print.
ROUTE_TOPK = "k2_topk"
ROUTE_HIST = "k2_hist"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in _VARIANTS:
        raise ValueError(f"unknown K2 variant {variant!r}; want one of {_VARIANTS}")


def _check_geometry(name, t: torch.Tensor, tile_rows: int, tile_words: int) -> None:
    rows, w_pad = t.shape
    if tile_rows <= 0 or tile_rows % 32:
        raise ValueError(f"{name}: tile_rows={tile_rows} must be a positive multiple of 32")
    if tile_words <= 0 or tile_words % 8:
        raise ValueError(f"{name}: tile_words={tile_words} must be a positive multiple of 8")
    if rows % tile_rows or w_pad % tile_words:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} is not a multiple of the tile "
            f"({tile_rows}, {tile_words})"
        )


def _check_cuda_operand(name, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: want int32 bit-view words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: operand must be 16-byte aligned")


def _check_tile_ids(name, ibs: torch.Tensor, jbs: torch.Tensor, nb: int) -> None:
    if ibs.shape != jbs.shape or ibs.dim() != 1:
        raise ValueError(f"{name}: ibs and jbs must be 1-D of equal length")
    if ibs.numel() and not (
        0 <= min(int(ibs.min()), int(jbs.min()))
        and max(int(ibs.max()), int(jbs.max())) < nb
    ):
        raise ValueError(f"{name}: tile ids must lie in [0, {nb})")


@dataclasses.dataclass(frozen=True)
class DeviceTileIds:
    """A tile list (ibs, jbs) on a device whose ids were checked on the
    host before the upload, with the row-block count they were checked
    against. The K2 and K1 tile wrappers take it as ``checked=`` in place
    of their own check, which reads four values back from the device."""

    ibs: torch.Tensor
    jbs: torch.Tensor
    versions: tuple         # each tensor's in-place version when checked
    nb: int                 # row blocks the ids were checked against

    def __iter__(self):
        return iter((self.ibs, self.jbs))

    def vouch(self, name, ibs: torch.Tensor, jbs: torch.Tensor, nb: int) -> None:
        """Raise unless ``ibs`` and ``jbs`` are the tensors that were
        checked, unchanged since, and ``nb`` the count they were checked
        against."""
        if ibs is not self.ibs or jbs is not self.jbs:
            raise ValueError(f"{name}: checked= belongs to other tile-id tensors")
        if (ibs._version, jbs._version) != self.versions:
            raise ValueError(f"{name}: a tile-id tensor was written to after its check")
        if nb != self.nb:
            raise ValueError(
                f"{name}: checked= was made for {self.nb} row blocks, the operand has {nb}"
            )


def device_tile_ids(ibs: np.ndarray, jbs: np.ndarray, nb: int, device) -> DeviceTileIds:
    """Check a tile list on the host (1-D, equal length, ids in
    ``[0, nb)``; raises ``ValueError`` otherwise) and upload it to
    ``device`` in one copy, as int32."""
    ibs = np.ascontiguousarray(ibs, dtype=np.int32)
    jbs = np.ascontiguousarray(jbs, dtype=np.int32)
    if ibs.shape != jbs.shape or ibs.ndim != 1:
        raise ValueError("device_tile_ids: ibs and jbs must be 1-D of equal length")
    if ibs.size and not (
        0 <= min(ibs.min(), jbs.min()) and max(ibs.max(), jbs.max()) < nb
    ):
        raise ValueError(f"device_tile_ids: tile ids must lie in [0, {nb})")
    both = profiling.upload(torch.from_numpy(np.stack([ibs, jbs])), device)
    return DeviceTileIds(
        ibs=both[0], jbs=both[1], versions=(both[0]._version, both[1]._version), nb=nb
    )


def _check_ids(name, ibs, jbs, nb: int, checked: Optional[DeviceTileIds]) -> None:
    """The tile wrappers' id check: ``checked`` vouches for ids that were
    checked on the host; bare tensors are checked here, with a read-back
    when they lie on the card."""
    if checked is None:
        _check_tile_ids(name, ibs, jbs, nb)
    else:
        checked.vouch(name, ibs, jbs, nb)


def _check_cuda_ids(device: torch.device, **ids: torch.Tensor) -> None:
    for name, t in ids.items():
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {device}")


def _launch(source: str, entry: str, device: torch.device, *args) -> None:
    """Launch C function ``entry`` of ``csrc/<source>.cu`` on ``device``'s
    current stream; raises on a CUDA error."""
    from stormtpu_torch.kernels._build import library

    with torch.cuda.device(device):
        err = getattr(library(source), entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def _launch_epilogue(entry: str, device: torch.device, *args) -> None:
    """:func:`_launch` of ``csrc/k2_epilogue.cu``'s ``entry``; raises first
    when the library's sub-tile is not the one the wrappers lay their
    outputs out by, or its limits are below the dispatch rules'."""
    from stormtpu_torch.kernels._build import library

    lib = library("k2_epilogue")
    block = (lib.k2_epi_block_rows(), lib.k2_epi_block_cols())
    if block != EPI_BLOCK or lib.k2_topk_max_k() < TOPK_EPI_MAX \
            or lib.k2_hist_max_bins() < HIST_EPI_MAX_BINS:
        raise RuntimeError(f"k2_epilogue was built for sub-tiles {block}, k up to "
                           f"{lib.k2_topk_max_k()}, {lib.k2_hist_max_bins()} bins")
    _launch("k2_epilogue", entry, device, *args)


def _unpack_step(packed: torch.Tensor, k0: int, tile_words: int) -> torch.Tensor:
    return unpack_to_int8(packed[:, k0 : k0 + tile_words].contiguous())


# ----------------------------------------------------------------- plain forms
def count_tiles_plain(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
) -> torch.Tensor:
    """Plain version of :func:`count_tiles_pallas_mxu`: per K step, unpack
    the step's words of every row block that a tile touches and add the
    int8 products of each tile pair."""
    n_pad, w_pad = packed.shape
    ti = tile_rows
    t = ibs.shape[0]
    out = torch.zeros((t, ti, ti), dtype=torch.int32, device=packed.device)
    if t == 0:
        return out
    ib = ibs.cpu().numpy()
    jb = jbs.cpu().numpy()
    # tiles grouped by their A row block: one product per (group, K step)
    groups = []
    for i0 in np.unique(ib):
        sel = np.flatnonzero(ib == i0)
        groups.append((
            int(i0),
            torch.from_numpy(sel).to(packed.device),
            torch.from_numpy(jb[sel].astype(np.int64)).to(packed.device),
        ))
    rows = packed.reshape(n_pad // ti, ti, w_pad)
    for k0 in range(0, w_pad, tile_words):
        step = rows[:, :, k0 : k0 + tile_words]
        for i0, sel, jsel in groups:
            ua = unpack_to_int8(step[i0].contiguous())
            ub = unpack_to_int8(step[jsel].reshape(-1, step.shape[2]))
            prod = int8_dot_nt(ua, ub).view(ti, sel.numel(), ti).permute(1, 0, 2)
            out.index_add_(0, sel, prod)
    return out


def count_block_plain(
    a_pad: torch.Tensor, b_pad: torch.Tensor, *, tile_words: int
) -> torch.Tensor:
    """Plain version of :func:`count_block_pallas_mxu` on operands whose
    words are a multiple of ``tile_words``: per K step, unpack both
    operands' words and add their int8 product."""
    na = a_pad.shape[0]
    nb, w_pad = b_pad.shape
    out = torch.zeros((na, nb), dtype=torch.int32, device=a_pad.device)
    for k0 in range(0, w_pad, tile_words):
        out += int8_dot_nt(
            _unpack_step(a_pad, k0, tile_words), _unpack_step(b_pad, k0, tile_words)
        )
    return out


# ------------------------------------------------- the epilogue kernels' forms
class TileTopk(NamedTuple):
    """K2-topk's candidate sets for T tiles of ``ti`` rows, ``kk`` a set,
    int32: ``row_v`` / ``row_i`` [T, nsub_n, ti, kk], each row's best
    (value, global column) over sub-tile column block s; ``col_v`` /
    ``col_i`` [T, nsub_m, ti, kk], each column's best (value, global row)
    over sub-tile row block s, all (−1, −1) in a diagonal tile. Sub-tiles
    are ``EPI_BLOCK`` (rows, columns); a set is sorted by value descending,
    ties to the lower index, and invalid cells (the self pair, a global row
    or column ≥ ``n_real``) rank as −1."""

    row_v: torch.Tensor
    row_i: torch.Tensor
    col_v: torch.Tensor
    col_i: torch.Tensor


def topk_route(k: int, partial: bool = False) -> str:
    """The route of a count top-k over K2-tri's tiles: ``ROUTE_TOPK``
    (K2-topk) for k ≤ ``TOPK_EPI_MAX`` on exact tiles; else the tiles are
    stored and ranked by torch, a route named by its rule (``partial``:
    K-partial tiles, summed across ranks before any ranking)."""
    if partial:
        return "store (K-partial tiles)"
    if k > TOPK_EPI_MAX:
        return f"store (k > {TOPK_EPI_MAX})"
    return ROUTE_TOPK


def hist_route(n_bins: int) -> str:
    """The route of a histogram of K2-tri's tiles: ``ROUTE_HIST`` (K2-hist)
    for n_bins ≤ ``HIST_EPI_MAX_BINS``; else the tiles are stored and
    binned by torch."""
    if n_bins > HIST_EPI_MAX_BINS:
        return f"store (n_bins > {HIST_EPI_MAX_BINS})"
    return ROUTE_HIST


def _global_lanes(ibs, jbs, ti: int, row_off: int, col_off: int):
    """Global rows and columns int64 [T, ti] of each tile's lanes."""
    lane = torch.arange(ti, device=ibs.device)
    rows = row_off + ibs.long()[:, None] * ti + lane
    cols = col_off + jbs.long()[:, None] * ti + lane
    return rows, cols


def _best_along(v: torch.Tensor, kk: int, dim: int):
    """The kk best of int32 ``v`` along ``dim`` by value descending, ties to
    the lower position: (values int32, positions int64), one torch.topk of a
    unique int64 key (value + 1, then the position reversed)."""
    n = v.shape[dim]
    shape = [1] * v.dim()
    shape[dim] = n
    rev = ((1 << 32) - 1 - torch.arange(n, device=v.device)).view(shape)
    top = torch.topk(((v.to(torch.int64) + 1) << 32) | rev, kk, dim=dim).values
    return ((top >> 32) - 1).to(torch.int32), (1 << 32) - 1 - (top & 0xFFFFFFFF)


def tile_topk_sets(tiles: torch.Tensor, ibs, jbs, *, k: int, n_real: int,
                   row_off: int = 0, col_off: int = 0) -> TileTopk:
    """K2-topk's reduction of stored count tiles int32 [T, ti, ti] at tile
    ids (ibs, jbs) (tensors on the tiles' device): the masks and the
    per-sub-tile top-min(k, ti) of both sides (:class:`TileTopk`)."""
    t, ti = tiles.shape[0], tiles.shape[1]
    kk = min(k, ti)
    bm, bn = EPI_BLOCK
    rows, cols = _global_lanes(ibs, jbs, ti, row_off, col_off)
    bad = ((rows[:, :, None] == cols[:, None, :]) | (rows >= n_real)[:, :, None]
           | (cols >= n_real)[:, None, :])
    v = tiles.masked_fill(bad, -1)
    row_v, row_i, col_v, col_i = [], [], [], []
    for c0 in range(0, ti, bn):
        val, pos = _best_along(v[:, :, c0 : c0 + bn], kk, 2)
        row_v.append(val)
        row_i.append((cols[:, c0, None, None] + pos).to(torch.int32))
    diag = (rows[:, 0] == cols[:, 0])[:, None, None]
    for r0 in range(0, ti, bm):
        val, pos = _best_along(v[:, r0 : r0 + bm, :], kk, 1)
        idx = (rows[:, r0, None, None] + pos).to(torch.int32)
        col_v.append(val.transpose(1, 2).masked_fill(diag, -1))
        col_i.append(idx.transpose(1, 2).masked_fill(diag, -1))
    return TileTopk(*(torch.stack(x, dim=1).contiguous() for x in (row_v, row_i, col_v, col_i)))


def tile_hist(tiles: torch.Tensor, ibs, jbs, *, n_real: int, bin_width: int, n_bins: int,
              row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """K2-hist's reduction of stored count tiles int32 [T, ti, ti]: the
    bin counts int64 [n_bins] of the valid pairs (global row < global
    column < ``n_real``), bin min(count // bin_width, n_bins − 1)."""
    rows, cols = _global_lanes(ibs, jbs, tiles.shape[1], row_off, col_off)
    valid = (rows[:, :, None] < cols[:, None, :]) & (cols < n_real)[:, None, :]
    bins = torch.clamp(tiles[valid] // bin_width, max=n_bins - 1)
    return torch.bincount(bins.long(), minlength=n_bins)


def count_tiles_topk_plain(packed, ibs, jbs, *, tile_rows: int, tile_words: int, k: int,
                           n_real: int, row_off: int = 0, col_off: int = 0) -> TileTopk:
    """Plain version of :func:`count_tiles_topk`: the plain tiles, then
    :func:`tile_topk_sets`."""
    tiles = count_tiles_plain(packed, ibs, jbs, tile_rows=tile_rows, tile_words=tile_words)
    return tile_topk_sets(tiles, ibs, jbs, k=k, n_real=n_real, row_off=row_off,
                          col_off=col_off)


def count_tiles_hist_plain(packed, ibs, jbs, *, tile_rows: int, tile_words: int,
                           n_real: int, bin_width: int, n_bins: int, row_off: int = 0,
                           col_off: int = 0) -> torch.Tensor:
    """Plain version of :func:`count_tiles_hist`: the plain tiles, then
    :func:`tile_hist`."""
    tiles = count_tiles_plain(packed, ibs, jbs, tile_rows=tile_rows, tile_words=tile_words)
    return tile_hist(tiles, ibs, jbs, n_real=n_real, bin_width=bin_width, n_bins=n_bins,
                     row_off=row_off, col_off=col_off)


# ------------------------------------------------------------- kernel wrappers
def count_tiles_pallas_mxu(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
    variant: str = "concat",
    checked: Optional[DeviceTileIds] = None,
) -> torch.Tensor:
    """T count tiles int32 [T, TI, TI] for row-block pairs (ibs[t], jbs[t])
    of a padded packed matrix int32 [N_pad, W_pad]. The ids are checked on
    every call, after a read-back when they lie on the card, unless
    ``checked`` (from :func:`device_tile_ids`) says that these very tensors
    were checked on the host before their upload."""
    _check_variant(variant)
    _check_geometry("count_tiles_pallas_mxu", packed, tile_rows, tile_words)
    _check_ids("count_tiles_pallas_mxu", ibs, jbs, packed.shape[0] // tile_rows, checked)
    if packed.device.type == "cpu":
        return count_tiles_plain(
            packed, ibs, jbs, tile_rows=tile_rows, tile_words=tile_words
        )
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    _check_cuda_operand("count_tiles_pallas_mxu", packed)
    _check_cuda_ids(packed.device, ibs=ibs, jbs=jbs)
    t = ibs.shape[0]
    out = torch.empty((t, tile_rows, tile_rows), dtype=torch.int32, device=packed.device)
    if t == 0:
        return out
    _launch(
        "k2_mxu", "k2_tri_launch", packed.device,
        packed.data_ptr(), ibs.data_ptr(), jbs.data_ptr(), out.data_ptr(),
        t, tile_rows, packed.shape[1],
    )
    LAUNCHES["k2_tri"] += 1
    return out


def rect_cluster(na: int) -> int:
    """K2-rect's shape rule, by the A operand's row count alone: the blocks
    a cluster of ``k2_rect_tma_launch`` holds. 2 when A has an even number
    of sub-tile rows of ``RECT_BLOCK_ROWS`` (rows 2q, 2q + 1 load each B
    tile once, multicast into both), else 1 (Na ≤ 128 among them: one
    sub-tile row, nothing to share)."""
    return 2 if -(-na // RECT_BLOCK_ROWS) % 2 == 0 else 1


def _rect_launch(name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K2-rect: counts of card operands a [Na, W] and b [Nb, W]
    (contiguous, 16-byte aligned int32, W a positive multiple of 4) into
    ``out``'s first Nb columns; ``out`` is int32 [Na, ldo], contiguous, ldo
    even and past Nb when Nb is odd (the kernel's int2 stores). Raises
    ``ValueError`` or ``TypeError``, before any launch, on what
    ``k2_rect_tma_launch`` does not take. The cluster is
    :func:`rect_cluster`'s; a launch in clusters of two counts
    ``rect_shared_b``."""
    na, w = a.shape
    nb, wb = b.shape
    if (na + RECT_BLOCK_ROWS >= _RECT_INT_LIMIT or nb + RECT_BLOCK_COLS >= _RECT_INT_LIMIT
            or -(-na // RECT_BLOCK_ROWS) * -(-nb // RECT_BLOCK_COLS) >= _RECT_INT_LIMIT):
        raise ValueError(f"{name}: Na={na} x Nb={nb} exceeds the grid limit (int32 row "
                         f"coordinates and block count)")
    for x in (a, b):
        _check_cuda_operand(name, x)
    if wb != w or w % RECT_WORD_ALIGN or not 0 < w < _RECT_INT_LIMIT - 32:
        raise ValueError(f"{name}: rows of {w} and {wb} words; K2-rect takes equal positive "
                         f"multiples of {RECT_WORD_ALIGN} (rect_operand copies others)")
    ldo = out.shape[1]
    if (na < 1 or nb < 1 or out.dtype != torch.int32 or not out.is_contiguous()
            or out.shape[0] != na or ldo % 2 or ldo < nb + nb % 2):
        raise ValueError(f"{name}: want Na, Nb >= 1 and a contiguous int32 output [{na}, ldo] "
                         f"with ldo even and >= {nb + nb % 2}; got {na} x {nb} into "
                         f"{out.dtype} {tuple(out.shape)}")
    cluster = rect_cluster(na)
    _launch("k2_mxu", "k2_rect_tma_launch", a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), na, nb, w, ldo, cluster)
    LAUNCHES["k2_rect"] += 1
    if cluster == 2:
        profiling.count("rect_shared_b")


def _count_block_padded(
    a_pad: torch.Tensor,
    b_pad: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
    variant: str,
) -> torch.Tensor:
    """Rectangular counts int32 [Na_pad, Nb_pad] of two padded packed CPU
    matrices int32 [Na_pad, W_pad] and [Nb_pad, W_pad], rows and words
    multiples of the tile (``tile_rows``, ``tile_words``): the JAX
    package's geometry, which the plain version keeps, since it unpacks
    whole K steps of ``tile_words`` words. Card operands take
    :func:`count_block_pallas_mxu`, which pads nothing; this raises
    ``ValueError`` for them."""
    _check_variant(variant)
    _check_geometry("_count_block_padded", a_pad, tile_rows, tile_words)
    _check_geometry("_count_block_padded", b_pad, tile_rows, tile_words)
    if a_pad.shape[1] != b_pad.shape[1]:
        raise ValueError("word-count mismatch")
    if a_pad.device != b_pad.device:
        raise ValueError("operands on different devices")
    if a_pad.device.type != "cpu":
        raise ValueError(f"_count_block_padded takes CPU operands, got {a_pad.device}; "
                         f"card operands take count_block_pallas_mxu")
    return count_block_plain(a_pad, b_pad, tile_words=tile_words)


def _epilogue_checks(name, packed, ibs, jbs, tile_rows, tile_words, variant, checked):
    _check_variant(variant)
    _check_geometry(name, packed, tile_rows, tile_words)
    _check_ids(name, ibs, jbs, packed.shape[0] // tile_rows, checked)
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")
    if packed.device.type == "cuda":
        # TMA's base and row stride (csrc/tile_body_tma.cuh): 16-byte aligned,
        # and rows of a multiple of 8 words (the geometry check above)
        _check_cuda_operand(name, packed)
        _check_cuda_ids(packed.device, ibs=ibs, jbs=jbs)


def epilogue_cluster(tile_rows: int) -> int:
    """The blocks a cluster of K2-topk / K2-hist holds at tiles of
    ``tile_rows`` rows, by the kernels' shape rule: 2 (a pair of sub-tile
    rows sharing their B rows) when a tile has an even number of sub-tile
    rows, else 1. Asks the built library."""
    from stormtpu_torch.kernels._build import library

    return library("k2_epilogue").k2_epi_cluster(tile_rows)


def count_tiles_topk(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
    k: int,
    n_real: int,
    row_off: int = 0,
    col_off: int = 0,
    variant: str = "concat",
    checked: Optional[DeviceTileIds] = None,
) -> TileTopk:
    """K2-topk: the count tiles of :func:`count_tiles_pallas_mxu` reduced,
    inside the kernel, to each row's and each column's top-min(k,
    tile_rows) candidates a sub-tile (:class:`TileTopk`). Global row and
    column of tile t's element (r, c) are ``row_off + ibs[t]·ti + r`` and
    ``col_off + jbs[t]·ti + c``. 1 ≤ k ≤ ``TOPK_EPI_MAX``."""
    _epilogue_checks("count_tiles_topk", packed, ibs, jbs, tile_rows, tile_words, variant,
                     checked)
    if not 1 <= k <= TOPK_EPI_MAX:
        raise ValueError(f"count_tiles_topk: k={k} must lie in [1, {TOPK_EPI_MAX}]")
    if packed.device.type == "cpu":
        return count_tiles_topk_plain(packed, ibs, jbs, tile_rows=tile_rows,
                                      tile_words=tile_words, k=k, n_real=n_real,
                                      row_off=row_off, col_off=col_off)
    ti, t = tile_rows, ibs.shape[0]
    kk = min(k, ti)
    nsub_m, nsub_n = -(-ti // EPI_BLOCK[0]), -(-ti // EPI_BLOCK[1])
    out = [torch.empty((t, s, ti, kk), dtype=torch.int32, device=packed.device)
           for s in (nsub_n, nsub_n, nsub_m, nsub_m)]
    if t == 0:
        return TileTopk(*out)
    _launch_epilogue(
        "k2_topk_launch", packed.device,
        packed.data_ptr(), ibs.data_ptr(), jbs.data_ptr(), *(o.data_ptr() for o in out),
        t, ti, *packed.shape, row_off, col_off, n_real, kk,
    )
    LAUNCHES["k2_topk"] += 1
    return TileTopk(*out)


def count_tiles_hist(
    packed: torch.Tensor,
    ibs: torch.Tensor,
    jbs: torch.Tensor,
    *,
    tile_rows: int,
    tile_words: int,
    n_real: int,
    bin_width: int,
    n_bins: int,
    row_off: int = 0,
    col_off: int = 0,
    variant: str = "concat",
    checked: Optional[DeviceTileIds] = None,
) -> torch.Tensor:
    """K2-hist: the bin counts int64 [n_bins] of the valid pairs (global
    row < global column < ``n_real``; coordinates as in
    :func:`count_tiles_topk`) of the count tiles of
    :func:`count_tiles_pallas_mxu`, binned inside the kernel: bin
    min(count // bin_width, n_bins − 1). 1 ≤ n_bins ≤ ``HIST_EPI_MAX_BINS``."""
    _epilogue_checks("count_tiles_hist", packed, ibs, jbs, tile_rows, tile_words, variant,
                     checked)
    if not 1 <= n_bins <= HIST_EPI_MAX_BINS:
        raise ValueError(f"count_tiles_hist: n_bins={n_bins} must lie in "
                         f"[1, {HIST_EPI_MAX_BINS}]")
    if bin_width < 1:
        raise ValueError("count_tiles_hist: bin_width must be >= 1")
    if packed.device.type == "cpu":
        return count_tiles_hist_plain(packed, ibs, jbs, tile_rows=tile_rows,
                                      tile_words=tile_words, n_real=n_real,
                                      bin_width=bin_width, n_bins=n_bins, row_off=row_off,
                                      col_off=col_off)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=packed.device)
    if ibs.shape[0] == 0:
        return hist
    _launch_epilogue(
        "k2_hist_launch", packed.device,
        packed.data_ptr(), ibs.data_ptr(), jbs.data_ptr(), hist.data_ptr(),
        ibs.shape[0], tile_rows, *packed.shape, row_off, col_off, n_real, bin_width, n_bins,
    )
    LAUNCHES["k2_hist"] += 1
    return hist


# ------------------------------------------------------------ tile walks
def k2_tile_shape(cfg: EngineConfig, n: int, w: int) -> tuple[int, int]:
    """(tile_rows, tile_words) for the K2 tile walk — the JAX package's
    geometry rule (small W collapses to a single K step), kept so the
    port's tile stack has the same layout."""
    ti = min(cfg.k2_tile_rows, round_up(max(n, 32), 32))
    if w <= cfg.k2_tile_words:
        wk = round_up(max(w, 8), 8)
    else:
        wk = round_up(cfg.k2_tile_words, 128)
    return ti, wk


def _pad(x: torch.Tensor, rows: int, words: int) -> torch.Tensor:
    n, w = x.shape
    if (n, w) == (rows, words) and x.is_contiguous():
        return x
    with profiling.span("stpu.kernels.pad"):
        xp = torch.zeros((rows, words), dtype=torch.int32, device=x.device)
        xp[:n, :w] = x
    profiling.count("pad_bytes", 4 * rows * words)
    return xp


def rect_operand(x: torch.Tensor) -> torch.Tensor:
    """Operand ``x`` [n, W] as K2-rect's card route takes it: ``x`` itself
    when it is a contiguous, 16-byte aligned int32 tensor with W % 4 == 0,
    else a copy int32 [n, round_up(W, 4)] whose words past W are zero (the
    kernel loads a row's words as whole 16-byte vectors). Rows are never
    padded: the kernel masks the ragged row edges."""
    n, w = x.shape
    words = round_up(w, RECT_WORD_ALIGN)
    if (w == words and x.dtype == torch.int32 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    with profiling.span("stpu.kernels.pad"):
        xp = torch.empty((n, words), dtype=torch.int32, device=x.device)
        xp[:, :w] = x
        xp[:, w:] = 0
    profiling.count("pad_bytes", 4 * n * words)
    return xp


def count_block_pallas_mxu(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    *,
    config: Optional[EngineConfig] = None,
    variant: Optional[str] = None,
) -> torch.Tensor:
    """Rectangular cross counts int32 [Na, Nb] on the operands' device (a
    view, not always contiguous).

    Card operands go to K2-rect with their true Na and Nb: the kernel
    masks the ragged row edges, and the blocks of each B tile run together
    (in pairs sharing its rows where :func:`rect_cluster` says), so B
    streams once at any Na. An operand is copied only when
    :func:`rect_operand` cannot take it as it is, and then with its words
    padded to a multiple of 4, never its rows; with no copy ``pad_bytes``
    counts 0 and ``rect_unpadded`` one. CPU operands, whose plain version
    unpacks whole K steps, are padded to the K2 tile, rows and words, and
    take :func:`_count_block_padded`."""
    cfg = config or default_config()
    variant = variant or cfg.k2_variant
    na, w = a_packed.shape
    nb_rows, wb = b_packed.shape
    if w != wb:
        raise ValueError("word-count mismatch")
    _check_variant(variant)
    if a_packed.device.type == "cuda":
        if b_packed.device != a_packed.device:
            raise ValueError("operands on different devices")
        return _count_block_card(a_packed, b_packed)
    ti, wk = k2_tile_shape(cfg, max(na, nb_rows), w)
    w_pad = round_up(w, wk)
    out = _count_block_padded(
        _pad(a_packed, round_up(na, ti), w_pad),
        _pad(b_packed, round_up(nb_rows, ti), w_pad),
        tile_rows=ti,
        tile_words=wk,
        variant=variant,
    )
    return out[:na, :nb_rows]


def _count_block_card(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2-rect on card operands [Na, W] and [Nb, W], each as
    :func:`rect_operand` gives it: counts int32 [Na, Nb], a view of
    [Na, round_up(Nb, 4)] whose spare columns take the odd int2 half.
    Rows of no words count 0 without a launch."""
    na, nb = a.shape[0], b.shape[0]
    ka, kb = rect_operand(a), rect_operand(b)
    unpadded = ka is a and kb is b
    if unpadded:
        profiling.count("pad_bytes", 0)
    out = (torch.empty if ka.shape[1] else torch.zeros)(
        (na, round_up(nb, RECT_WORD_ALIGN)), dtype=torch.int32, device=a.device)
    if na and nb and ka.shape[1]:
        _rect_launch("count_block_pallas_mxu", ka, kb, out)
        if unpadded:
            profiling.count("rect_unpadded")
    return out[:, :nb]


def count_matrix_pallas_mxu(
    packed: torch.Tensor,
    *,
    config: Optional[EngineConfig] = None,
    variant: Optional[str] = None,
) -> np.ndarray:
    """Full N×N exact counts int32 (numpy) via the K2 triangular walk and
    the symmetric mirror on the tiles' device (one download of the
    finished matrix)."""
    cfg = config or default_config()
    variant = variant or cfg.k2_variant
    n, w = packed.shape
    ti, wk = k2_tile_shape(cfg, n, w)
    n_pad = round_up(n, ti)
    xp = _pad(packed, n_pad, round_up(w, wk))
    nb = n_pad // ti
    ibs, jbs = triangular_tile_ids(nb)
    tiles = count_tiles_pallas_mxu(
        xp,
        torch.from_numpy(ibs).to(packed.device),
        torch.from_numpy(jbs).to(packed.device),
        tile_rows=ti,
        tile_words=wk,
        variant=variant,
    )
    return download(assemble_triangular_torch(tiles, ibs, jbs, nb, n))
