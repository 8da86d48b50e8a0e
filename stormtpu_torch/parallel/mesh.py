"""Meshes over a ``torch.distributed`` process group (port of
``stormtpu/parallel/mesh.py``).

The JAX package runs one program over a mesh of devices (``shard_map``).
The port runs one process a device: every rank of the group calls the same
``distributed_*`` function with the same host arrays, takes its own shard,
computes on its own device with the port's kernels, and joins the
collectives. A :class:`Mesh` names the ranks the way the JAX mesh names
devices: ``axis_names``, ``shape[axis]``, ``devices`` (the grid of global
ranks), plus what one rank needs: its ``rank``, its ``device``, the group's
``backend`` and one process group for each line of the grid it lies on.

The JAX collectives map onto these helpers, the only code that knows the
backend:

- ``lax.psum`` → :func:`psum` (``all_reduce``, exact for int32);
- ``lax.ppermute`` by a shift → :func:`ppermute` (``batch_isend_irecv``),
  and :func:`ring_shift_`, the same rotation written into the buffer it
  sends from, a chunk at a time through one staging buffer
  (:func:`shift_stage`): a shard too large to be held three times shifts
  beside two;
- ``fetch_global`` → :func:`fetch_global` (an all-gather of row shards).

gloo has no send or receive of CUDA tensors, so on gloo a CUDA tensor goes
through page-locked host memory; the computing stays on the card. NCCL
takes CUDA tensors as they are.

With no process group, :func:`make_row_mesh` joins the ``torchrun`` group
described by the environment, or else starts a one-rank group on a
``FileStore`` in a temporary directory (NCCL for a card, gloo for the CPU).
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from stormtpu_torch.config import default_config
from stormtpu_torch.utils import download, profiling, resolve_device

__all__ = [
    "Mesh",
    "barrier",
    "bit_axis_of",
    "fetch_global",
    "join_group",
    "local_shard",
    "make_grid_mesh",
    "make_row_mesh",
    "ppermute",
    "psum",
    "rank_device",
    "ring_shift_",
    "shift_stage",
]

#: timeout of the groups this module starts itself
GROUP_TIMEOUT_S = 600

#: the largest staging buffer :func:`shift_stage` makes; it takes at most
#: an eighth of the device memory free beside the buffer it shifts
SHIFT_STAGE_MAX_BYTES = 1 << 30


def rank_device(device=None) -> torch.device:
    """This rank's device: ``None`` → its card, ``cuda:{LOCAL_RANK %
    device_count}`` (raises without a card, as every entry point does);
    otherwise ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def join_group(device=None) -> None:
    """Make sure this process is in a process group: nothing when one
    exists; the ``torchrun`` group when its environment is set
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); else a
    one-rank group of its own (NCCL for a card, gloo for the CPU)."""
    if dist.is_initialized():
        return
    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
        return
    tmp = tempfile.mkdtemp(prefix="stormtpu_torch_group_")
    atexit.register(shutil.rmtree, tmp, True)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=timeout)
    # the group is this module's: it ends with the process (atexit runs
    # this before the directory's removal above)
    atexit.register(_end_own_group, dist.group.WORLD)


def _end_own_group(group) -> None:
    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()


# process groups by their ranks, for the world group they were made in
_GROUPS: dict = {}


def _group(ranks: tuple):
    """The process group of ``ranks`` (every rank of the world must ask
    for the same groups in the same order: ``new_group`` is collective).
    None for a single rank, the world group for all of them."""
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        _GROUPS.clear()
        _GROUPS["world"] = world
    if len(ranks) == 1:
        return None
    if len(ranks) == dist.get_world_size():
        return world
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a 1-D ``[rows]`` or 2-D ``[rows × bits]`` grid, as one
    rank sees them."""

    axis_names: tuple
    devices: np.ndarray     # global ranks, shaped like the grid
    rank: int               # this process's global rank
    device: torch.device    # this rank's device
    backend: str            # "nccl" or "gloo"
    lines: dict             # axis → (ranks of this rank's line along it, group)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        where = np.argwhere(self.devices == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for
        a line of one rank)."""
        return self.lines[axis][1]

    def is_writer(self) -> bool:
        """Whether this rank is the mesh's first (the one that writes)."""
        return self.rank == int(self.devices.flat[0])


def _make_mesh(grid: np.ndarray, axes: tuple, device) -> Optional[Mesh]:
    """Every rank makes every line's group (in the same order); the ranks
    of the grid get their :class:`Mesh`, the others ``None``."""
    dev = rank_device(device)
    lines_of: dict = {}
    for k, axis in enumerate(axes):
        moved = np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k])
        for line in moved:
            ranks = tuple(int(x) for x in line)
            group = _group(ranks)
            for rk in ranks:
                lines_of.setdefault(rk, {})[axis] = (ranks, group)
    rank = dist.get_rank()
    if rank not in lines_of:
        return None
    return Mesh(axis_names=tuple(axes), devices=grid, rank=rank, device=dev,
                backend=dist.get_backend(), lines=lines_of[rank])


def _ranks(devices: Optional[Sequence[int]]) -> np.ndarray:
    """The ranks a mesh may take, in order: ``devices`` (distinct ranks of
    the group), else every rank."""
    world = dist.get_world_size()
    if devices is None:
        return np.arange(world)
    ranks = np.asarray([int(r) for r in devices], dtype=np.int64)
    if ranks.size and (ranks.min() < 0 or ranks.max() >= world):
        raise ValueError(f"devices must be ranks of the group (0 … {world - 1}), "
                         f"got {ranks.tolist()}")
    if np.unique(ranks).size != ranks.size:
        raise ValueError(f"devices must be distinct ranks, got {ranks.tolist()}")
    return ranks


def make_row_mesh(
    n_devices: Optional[int] = None,
    *,
    axis: Optional[str] = None,
    devices: Optional[Sequence[int]] = None,
    device=None,
) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` (default: all) of ``devices``
    (ranks of the group, in mesh order; default: every rank), named after
    the row-shard axis. Joins a group first where there is none
    (:func:`join_group`). Every rank must call it with the same arguments;
    ranks outside the mesh get ``None``."""
    axis = axis or default_config().mesh_axis
    join_group(device)
    ranks = _ranks(devices)
    if n_devices is None:
        n_devices = ranks.size
    if n_devices > ranks.size:
        raise ValueError(f"asked for {n_devices} devices, have {ranks.size}")
    if n_devices < 1:
        raise ValueError(f"mesh dims must be >= 1, got {n_devices}")
    return _make_mesh(ranks[:n_devices], (axis,), device)


def make_grid_mesh(
    rows: int,
    bits: int,
    *,
    axes: tuple = ("rows", "bits"),
    devices: Optional[Sequence[int]] = None,
    device=None,
) -> Optional[Mesh]:
    """2-D mesh [rows × bits] over the first ``rows·bits`` of ``devices``
    (ranks of the group; default: every rank), the one at ``r·bits + b`` at
    (r, b): the ring streams row shards along ``axes[0]`` while
    :func:`psum` over ``axes[1]`` merges the exact int32 partials of the
    word slices. Ranks outside the grid get ``None``."""
    if rows < 1 or bits < 1:
        raise ValueError(f"mesh dims must be >= 1, got {rows}×{bits}")
    join_group(device)
    ranks = _ranks(devices)
    if rows * bits > ranks.size:
        raise ValueError(f"asked for {rows}×{bits} devices, have {ranks.size}")
    return _make_mesh(ranks[: rows * bits].reshape(rows, bits), tuple(axes), device)


def bit_axis_of(mesh: Mesh) -> Optional[str]:
    """Second axis name of a 2-D [rows × bits] mesh, else None."""
    return mesh.axis_names[1] if len(mesh.axis_names) == 2 else None


def local_shard(packed: np.ndarray, rows: tuple, words: tuple, device,
                width: Optional[int] = None) -> torch.Tensor:
    """Rows [r0, r1) and words [w0, w1) of the host words ``packed`` as an
    int32 bit-view tensor on ``device``, zero where they lie past its
    shape, zero-padded to ``width`` words: one rank's shard, without a
    padded copy of the whole matrix."""
    from stormtpu_torch.layout import to_device_words

    (r0, r1), (w0, w1) = rows, words
    out = np.zeros((r1 - r0, width or (w1 - w0)), dtype=np.uint32)
    src = packed[r0:r1, w0:w1]
    out[: src.shape[0], : src.shape[1]] = src
    return to_device_words(out, device)


# ------------------------------------------------------------ collectives
def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` in page-locked host memory (gloo's side of a CUDA tensor)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axis``, in place (exact for
    integers); returns ``x``."""
    ranks, group = mesh.lines[axis]
    if len(ranks) == 1:
        return x
    if not x.is_contiguous():
        x = x.contiguous()
    if _staged(mesh, x):
        h = _host_copy(x)
        dist.all_reduce(h, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
    return x


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int) -> torch.Tensor:
    """Rotate ``x`` along ``axis``: this rank sends it to the rank
    ``shift`` places on and returns what the rank ``shift`` places back
    sent (JAX's ``ppermute`` with pairs ``(i, (i + shift) % r)``)."""
    ranks, group = mesh.lines[axis]
    r = len(ranks)
    if shift % r == 0:
        return x
    my = ranks.index(mesh.rank)
    dst, src = ranks[(my + shift) % r], ranks[(my - shift) % r]
    x = x.contiguous()
    staged = _staged(mesh, x)
    send = _host_copy(x) if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


def shift_stage(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The staging buffer of :func:`ring_shift_` for buffers shaped like
    ``x``: a flat tensor of ``x``'s dtype, as long as every rank of the
    line along ``axis`` can spare (an eighth of its free device memory, at
    most :data:`SHIFT_STAGE_MAX_BYTES`, never more than ``x``), agreed by a
    minimum over the line. It lies where the send leaves from: on the
    device, or in page-locked host memory where gloo carries a CUDA
    tensor. Every rank of the line must call it."""
    ranks, group = mesh.lines[axis]
    item = x.element_size()
    elems = max(1, min(x.numel(), SHIFT_STAGE_MAX_BYTES // item))
    if x.device.type == "cuda" and not _staged(mesh, x):
        profiling.count("mem_queries")
        free, _total = torch.cuda.mem_get_info(x.device)
        elems = max(1, min(elems, free // 8 // item))
    if len(ranks) > 1:
        agreed = torch.tensor([elems], dtype=torch.int64,
                              device="cpu" if mesh.backend == "gloo" else x.device)
        dist.all_reduce(agreed, op=dist.ReduceOp.MIN, group=group)
        elems = int(agreed.item())
    if _staged(mesh, x):
        return torch.empty(elems, dtype=x.dtype, pin_memory=True)
    return torch.empty(elems, dtype=x.dtype, device=x.device)


def ring_shift_(x: torch.Tensor, mesh: Mesh, axis: str, shift: int,
                stage: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate the contiguous ``x`` along ``axis`` in place: afterwards it
    holds what the rank ``shift`` places back held, as :func:`ppermute`
    returns, and this rank's old contents are at the rank ``shift`` places
    on. It moves a chunk of ``stage``'s length at a time: the chunk is
    copied into ``stage``, sent from there, and the chunk from the other
    side lands where it was. ``stage`` (default: :func:`shift_stage`) must
    be as long on every rank of the line; its chunks need not divide
    ``x``. On gloo a CUDA buffer's chunks go through page-locked host
    memory. Returns ``x``."""
    ranks, group = mesh.lines[axis]
    r = len(ranks)
    if shift % r == 0:
        return x
    if not x.is_contiguous():
        raise ValueError("ring_shift_ rotates a contiguous buffer in place")
    my = ranks.index(mesh.rank)
    dst, src = ranks[(my + shift) % r], ranks[(my - shift) % r]
    if stage is None:
        stage = shift_stage(x, mesh, axis)
    staged = _staged(mesh, x)
    if stage.dtype != x.dtype or stage.device != (torch.device("cpu") if staged else x.device):
        raise ValueError(f"the stage must be {x.dtype} where the send leaves from "
                         f"(shift_stage), got {stage.dtype} on {stage.device}")
    landing = torch.empty(stage.shape, dtype=stage.dtype, pin_memory=True) if staged else None
    flat = x.view(-1)
    c = stage.numel()
    for a in range(0, flat.numel(), c):
        part = flat[a : a + c]
        send = stage[: part.numel()]
        send.copy_(part)
        recv = landing[: part.numel()] if staged else part
        ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            part.copy_(recv)
    return x


def fetch_global(x_local: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> np.ndarray:
    """Host array of a result sharded by rows along ``axis`` (default: the
    first): every rank all-gathers the row shards of its line, so each
    holds the full array — the JAX package's multi-process contract."""
    axis = axis or mesh.axis_names[0]
    ranks, group = mesh.lines[axis]
    if len(ranks) == 1:
        return download(x_local)
    x = x_local.contiguous()
    if mesh.backend == "gloo":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x, group=group)
    # a group orders its members by global rank; the mesh by its own order
    by_rank = sorted(ranks)
    return download(torch.cat([parts[by_rank.index(r)] for r in ranks]))


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (a one-element sum over each axis,
    on the mesh's device as NCCL needs)."""
    probe = torch.zeros(1, dtype=torch.int32, device=mesh.device)
    for axis in mesh.axis_names:
        psum(probe, mesh, axis)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
