"""Device-memory refusal guard (the only part of the JAX package's
``stream.py`` ported so far).

The streaming route itself — superblock stripes, checkpoint/resume,
operand streaming — is not ported yet, so a refusal here names it as
such instead of pointing at a route the port does not have.
"""

from __future__ import annotations

import os

import torch

__all__ = ["require_device_budget"]

STREAM_NOT_PORTED = (
    "the streaming route (stormtpu.stream / stormtpu.stream_query in the "
    "JAX package) is not yet ported to stormtpu_torch"
)


def _device_refuse_budget(device) -> int:
    """Bytes a single-shot route may allocate on ``device``.

    On a card: what CUDA reports free plus what PyTorch's caching
    allocator holds but does not use (``torch.cuda.mem_get_info`` and the
    allocator's counters). On the CPU: the host's physical memory.
    ``STORMTPU_DEVICE_REFUSE_BUDGET_BYTES`` overrides both (the same
    variable the JAX package reads)."""
    env = os.environ.get("STORMTPU_DEVICE_REFUSE_BUDGET_BYTES")
    if env:
        return int(env)
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        idle = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        return int(free + idle)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def require_device_budget(
    need_bytes: int, what: str, hint: str, device="cuda"
) -> None:
    """Refuse a device route whose footprint cannot fit on ``device``
    with ``ValueError`` (instead of an opaque mid-call out-of-memory)."""
    budget = _device_refuse_budget(device)
    if need_bytes > budget:
        raise ValueError(
            f"{what} (~{need_bytes / (1 << 30):.1f} GiB) exceeds the "
            f"device budget ({budget / (1 << 30):.1f} GiB); {hint}"
        )
