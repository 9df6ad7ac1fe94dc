"""The augmentation's source of random draws: a key object over one
``torch.Generator``.

Every op of ``ccd_tpu/data/aug_ops.py`` draws its parameters from a JAX key
and applies them in the same function. Seeds do not cross frameworks, so the
port's ops take a key object whose methods mirror, one for one, the
``jax.random`` primitives the JAX code calls: ``split``, ``fold_in``,
``uniform``, ``bernoulli``, ``randint``, ``normal``, ``laplace`` and
``permutations`` (a batch of ``jax.random.permutation``). The ops
make the same calls, in the same order and shapes, as their JAX counterparts;
a test-side twin of this class holds a real JAX key and answers each call with
``jax.random``'s own draw, so that one JAX key drives both packages to the
same numbers.

Here, ``split`` and ``fold_in`` hand out keys over the SAME generator: draws
happen in call order and are deterministic for a given generator state. Every
draw is made on the generator's device and nothing is read back to the host,
so the augmentation adds no synchronisation point to a step.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class TorchKey:
    """A key over ``generator``; draws land on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def split(self, n: int = 2) -> List["TorchKey"]:
        return [self] * n

    def fold_in(self, data: int) -> "TorchKey":
        del data
        return self

    def uniform(self, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        """float32 uniform in [lo, hi)."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return u * (hi - lo) + lo

    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor:
        """bool, True with probability ``p``."""
        return self.uniform(shape) < p

    def randint(self, shape: Sequence[int], lo: int, hi: int) -> torch.Tensor:
        """int64 uniform in [lo, hi)."""
        return torch.randint(lo, hi, tuple(shape), generator=self.generator, device=self.device)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def permutations(self, b: int, n: int) -> torch.Tensor:
        """(b, n) int64: row i a uniform random permutation of ``range(n)``
        (the argsort of uniforms, so that nothing goes to the host)."""
        return torch.argsort(self.uniform((b, n)), dim=-1)

    def laplace(self, shape: Sequence[int]) -> torch.Tensor:
        """Standard Laplace by the inverse CDF of a uniform in (-1, 1)."""
        v = self.uniform(shape, -1.0, 1.0).clamp_min(-1.0 + 2.0 ** -24)
        return -torch.sign(v) * torch.log1p(-v.abs())
