"""Constants made once per device (a copy of the port's ``device_constant``)."""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import torch


@lru_cache(maxsize=256)
def device_constant(make: Callable, device: torch.device, *args):
    """``make(*args)`` — a numpy array, or a tuple of them — as tensors on
    ``device``, made and copied there once per (make, device, args)."""
    value = make(*args)
    if isinstance(value, tuple):
        return tuple(torch.as_tensor(v, device=device) for v in value)
    return torch.as_tensor(value, device=device)
