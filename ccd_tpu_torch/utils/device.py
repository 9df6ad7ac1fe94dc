"""Device selection shared by the entry points."""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Union

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


@lru_cache(maxsize=None)
def device_constant(make: Callable, device: torch.device, *args):
    """``make(*args)`` — a numpy array, or a tuple of them — as tensors on
    ``device``, made and copied there once per (make, device, args). A copy
    from host memory waits for the device, so code inside a step keeps its
    constants here rather than uploading them at each call. None is ever
    dropped: a captured CUDA graph reads them at their addresses for as long
    as it lives (``utils/cuda_graphs.py``)."""
    value = make(*args)
    if isinstance(value, tuple):
        return tuple(torch.as_tensor(v, device=device) for v in value)
    return torch.as_tensor(value, device=device)
