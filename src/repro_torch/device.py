"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Asking for CUDA on a machine
    without a card raises: the port never carries on silently on the
    CPU, which callers must ask for with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            f"device; pass device='cpu' to run the plain PyTorch path")
    return dev
