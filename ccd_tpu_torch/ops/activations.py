"""Activation functions shared by the model families.

GELU: torch ``nn.GELU()`` (the reference's activation everywhere —
``vision_transformer.py:90``, ``transformer.py`` FFN) is the exact erf form,
and every fp32 path keeps it. Under bf16 compute the tanh approximation is
used, as in ``ccd_tpu/ops/activations.py``: it deviates from erf by at most
~3e-3 absolute (around |x|~=2), the same order as bf16 rounding itself, and
keeping it makes the two packages compute the same function per dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in fp32 paths; tanh GELU in bf16 compute."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
