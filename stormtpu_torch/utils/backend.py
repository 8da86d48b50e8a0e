"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. The
CPU runs only when the caller asks for it (``device="cpu"``): then each
kernel wrapper takes its plain PyTorch version. There is no quiet fall
back from a missing card to the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; stormtpu_torch runs on an NVIDIA card "
            "unless the caller passes device='cpu'"
        )
    return dev
