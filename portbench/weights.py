"""Weights made on the card from ``--seed``, the same for the program and
the reference.

One draw of unit normals for all of a model's parameters (a ``torch.Generator``
on the model's device, one call), cut into the parameters in the order of
their names and scaled per kind:

* matrices and embeddings (2-D): standard deviation 0.02, as the ViT and DINO
  initialisers draw them;
* convolution kernels (4-D): 1 / sqrt(fan in), as LeCun's;
* biases: 0.02, not zero, so that a character slot that pools nothing still
  gives the DINO head an input away from its normalisation's clamp;
* scales (LayerNorm and BatchNorm weights, the head's ``weight_g``): 1 plus
  0.02 of a normal.

Parameters are float32, the type both sides hold them in (the program
computes in its configuration's type).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _scale(name: str, shape) -> tuple:
    """(multiplier, offset) of the unit normals for one parameter."""
    last = name.rsplit(".", 1)[-1]
    if last == "weight_g" or (len(shape) == 1 and last == "weight"):
        return 0.02, 1.0
    if len(shape) == 1:
        return 0.02, 0.0
    if len(shape) == 4:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    return 0.02, 0.0


@torch.no_grad()
def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for the parameters ``shapes`` (name -> shape)."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n in names:
        k = math.prod(shapes[n])
        mul, add = _scale(n, shapes[n])
        out[n] = flat[at:at + k].view(shapes[n]).mul_(mul).add_(add)
        at += k
    return out


@torch.no_grad()
def load_weights(module: torch.nn.Module, seed: int) -> None:
    """Copy :func:`make_weights` into every parameter of ``module``."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    made = make_weights({n: tuple(p.shape) for n, p in params.items()}, seed, device)
    for n, p in params.items():
        p.copy_(made[n])
