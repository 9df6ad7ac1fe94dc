"""Device selection shared by the entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise when a CUDA device is asked for
    and none is present. Entry points run on the card unless the caller asks
    for the CPU, and never carry on on the CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
