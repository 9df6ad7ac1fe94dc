"""Building blocks that reproduce Flax's dtype semantics in PyTorch.

Parameters are always fp32. ``dtype`` is the compute type: as Flax's
``promote_dtype`` does, a :class:`Dense` casts its input and its weights to
``dtype`` at use; a :class:`LayerNorm` computes in fp32 whatever the input
and returns ``dtype``. (``ccd_tpu`` gets these from ``flax.linen``; the port
has no other home for them.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated_normal(stddev) truncates at +-2 sigma and divides stddev by
# the standard deviation of that truncated unit normal, so samples end up with
# the requested stddev
_TRUNC_STD_CORRECTION = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In-place normal(0, std) truncated at +-2 sigma (inverse-CDF sampling),
    the JAX package's ``truncated_normal(stddev=std, lower=-2, upper=2)``."""
    lo = math.erf(-2.0 / math.sqrt(2.0))  # 2 * Phi(-2) - 1
    with torch.no_grad():
        t.uniform_(lo, -lo, generator=generator).erfinv_()
        t.mul_(std / _TRUNC_STD_CORRECTION * math.sqrt(2.0))
    return t


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters and a compute ``dtype``.

    Outside autograd (evaluation) the cast copies of the parameters are kept
    and reused until the parameter changes, so a bf16 decode loop does not
    re-cast its weights at every step.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        self._cast_cache = {}

    def cast_param(self, name: str) -> Optional[torch.Tensor]:
        p = getattr(self, name)
        if p is None or p.dtype == self.dtype:
            return p
        if torch.is_grad_enabled():
            return p.to(self.dtype)
        key = (p._version, p.device, self.dtype)
        hit = self._cast_cache.get(name)
        if hit is None or hit[0] != key:
            hit = (key, p.detach().to(self.dtype))
            self._cast_cache[name] = hit
        return hit[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.cast_param("weight"),
                        self.cast_param("bias"))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and arithmetic, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype)


def init_dense_layers(module: nn.Module,
                      generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisers for every Dense / LayerNorm under
    ``module``: truncated normal (std 0.02) weights, zero biases, unit scales."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
