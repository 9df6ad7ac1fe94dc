"""One process and no group: what the copied modules need of
``parallel/mesh.py``. Every reduction returns its input."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

Group = Optional[object]


class Layout:
    """The (data, model) layout of a run of one process."""
    data = None
    model = None
    world = None
    model_index, model_size = 0, 1

    @staticmethod
    def of(group) -> "Layout":
        if group is not None:
            raise ValueError("the reference runs in one process, without a group")
        return Layout()


def world(group: Group = None) -> int:
    return 1


def rank_seed(seed: int, process: int) -> int:
    return int(seed) + (int(process) << 32)


def all_reduce_sum(t: torch.Tensor, group: Group, what: str,
                   differentiable: bool = False) -> torch.Tensor:
    return t


def all_reduce_max(t: torch.Tensor, group: Group, what: str) -> torch.Tensor:
    return t


def all_reduce_flat(tensors: Sequence[torch.Tensor], group: Group, what: str):
    return list(tensors)


def copy_to_model_group(t: torch.Tensor, group: Group, what: str) -> torch.Tensor:
    return t


def shard_rows(t: torch.Tensor, index: int, count: int, dim: int = 0) -> torch.Tensor:
    return t


def gather_rows(t: torch.Tensor, group: Group, what: str, dim: int = 0) -> torch.Tensor:
    return t
