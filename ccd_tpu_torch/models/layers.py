"""Building blocks that reproduce Flax's dtype semantics in PyTorch.

Parameters are always fp32. ``dtype`` is the compute type: as Flax's
``promote_dtype`` does, a :class:`Dense` casts its input and its weights to
``dtype`` at use, and so do :class:`Conv2d` and :class:`ConvTranspose2d`; a
:class:`LayerNorm` and a :class:`BatchNorm` compute in fp32 whatever the input
and return ``dtype``. (``ccd_tpu`` gets these from ``flax.linen``; the port
has no other home for them.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ccd_tpu_torch.parallel.mesh import all_reduce_sum, world

# the standard deviation of a unit normal truncated at +-2 sigma
_TRUNC_STD_CORRECTION = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: a unit normal truncated at +-2 (inverse-CDF sampling), times
    ``std``. This is JAX's ``nn.initializers.truncated_normal(stddev=std,
    lower=-2, upper=2)``, which does NOT correct ``std`` for the truncation:
    the samples' standard deviation is 0.8796 std and they lie within +-2 std."""
    lo = math.erf(-2.0 / math.sqrt(2.0))  # 2 * Phi(-2) - 1
    with torch.no_grad():
        t.uniform_(lo, -lo, generator=generator).erfinv_()
        t.mul_(std * math.sqrt(2.0))
    return t


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: Flax's ``lecun_normal`` (``variance_scaling(1, "fan_in",
    "truncated_normal")``), a unit normal truncated at +-2 scaled by
    ``sqrt(1 / fan_in) / 0.8796``, so that the samples' standard deviation
    is ``sqrt(1 / fan_in)``."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION, generator)


def keep_mask(x: torch.Tensor, rate: float, shape, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
    """Bernoulli(1 - rate) keep-mask of ``shape`` in ``x``'s type, drawn from
    ``generator`` on ``x``'s device (``uniform < 1 - rate``, as
    ``jax.random.bernoulli`` draws Flax's keep-mask): the one source of dropout
    and drop-path randomness. A draw from torch's global generator would be
    hidden state that no train-state carries, so a missing generator is an
    error."""
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit generator (torch.Generator)")
    return (torch.rand(shape, device=x.device, generator=generator) < 1.0 - rate).to(x.dtype)


class Dropout(nn.Module):
    """Elementwise dropout with an explicit generator, Flax ``nn.Dropout``'s
    semantics: in training mode each entry is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``; in evaluation mode, or at
    rate 0, the input passes and nothing is drawn."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return x / (1.0 - self.rate) * keep_mask(x, self.rate, x.shape, generator)


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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) with fp32 parameters and a compute ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (NCHW) with fp32 parameters and a compute ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class BatchNorm(nn.Module):
    """Batch normalisation over all axes but the channel axis 1, as Flax's
    ``nn.BatchNorm(momentum=0.9)`` does it: statistics and arithmetic in
    fp32, the variance as ``E[x^2] - E[x]^2`` clamped at 0, and the running
    variance updated with that BIASED batch variance (``nn.BatchNorm2d``
    keeps the unbiased one, so its running statistics drift apart from
    Flax's). Training mode normalises with the batch statistics and updates
    the running ones in place; evaluation mode uses the running ones.
    Parameter and buffer names are ``nn.BatchNorm2d``'s.

    ``group`` (a ``torch.distributed`` group, set by
    :func:`set_batchnorm_group`) makes the batch statistics global, as GSPMD
    makes them in the JAX step: under a group of more than one process the
    sums of x and x^2 and the count are all-reduced, differentiably, so the
    gradient flows through the global statistics, and the running ones
    update from them. With no group, or a world of one, no collective runs."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            axes = [0] + list(range(2, x.ndim))
            if self.group is not None and world(self.group) > 1:
                c = x.shape[1]
                count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
                sums = all_reduce_sum(torch.cat([x.sum(axes), (x * x).sum(axes), count]),
                                      self.group, "batchnorm", differentiable=True)
                mean, mean_sq = sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]
            else:
                mean, mean_sq = x.mean(axes), (x * x).mean(axes)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


def set_batchnorm_group(module: nn.Module, group) -> None:
    """Give every :class:`BatchNorm` under ``module`` the ``torch.distributed``
    group its batch statistics reduce over (None: this process's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
