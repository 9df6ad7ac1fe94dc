"""Step-indexed checkpoints as ``torch.save`` files.

Counterpart of ``ccd_tpu/checkpoints/orbax_io.py::CheckpointManager`` (the
reference's ``checkpoint.pth`` + ``checkpoint{epoch}`` scheme,
train.py:197-211): ``save(step, payload)`` writes ``ckpt_<step>.pt`` in the
directory, keeping the newest ``max_to_keep`` and, with ``keep_period``, every
step divisible by it as well. Payloads are moved to the CPU before they are
written and are read back with ``weights_only=True``, so a file holds only
tensors, numbers, strings and containers of them. Saves are synchronous; a
file appears under its final name only once it is complete.

:func:`save_payload` / :func:`load_payload` write and read one such file at
a fixed path, the counterpart of ``orbax_io.save_pytree`` /
``restore_pytree``: the finetune loop keeps its best checkpoint there, out of
the manager's retention.

Data parallelism (``group``): every rank calls ``save``/``save_payload``
with the same payload, rank 0 alone writes, and every rank waits at a
barrier until the file is there; every rank reads. A payload carries every
rank's generator states (:func:`generator_payload`), and a resume restores
each rank's own (:func:`restore_generators`). Under tensor parallelism the
ranks of one model group draw alike, and the generators travel over the
data group: the states are those of the data ranks.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from ccd_tpu_torch.parallel.mesh import Group, all_gather_bytes, barrier, rank, world

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def generator_payload(generators, group: Group = None) -> dict:
    """``{"world_size", "generators": [rank 0's states, rank 1's, ...]}``:
    every rank's states of ``generators``, gathered over ``group``, the data
    group (every rank calls this); ``world_size`` counts its ranks."""
    mine = torch.cat([g.get_state() for g in generators])
    sizes = [g.get_state().numel() for g in generators]
    every = all_gather_bytes(mine, group, "generator_states")
    return {"world_size": len(every),
            "generators": [[part.clone() for part in s.split(sizes)] for s in every]}


def restore_generators(generators, payload: dict, group: Group = None) -> None:
    """This rank's states out of a :func:`generator_payload` gathered over
    the data group ``group``. A payload of another number of data ranks is
    refused; one without states (an older checkpoint) leaves the generators
    as they are."""
    if "generators" not in payload:
        return
    if int(payload["world_size"]) != world(group):
        raise ValueError(f"the checkpoint was written by {payload['world_size']} data ranks and "
                         f"this run has {world(group)}: resuming at another world size (number "
                         "of data ranks) is not supported (each rank's data shard and "
                         "generators would change)")
    for g, saved in zip(generators, payload["generators"][rank(group)]):
        g.set_state(saved.cpu().contiguous())


def save_payload(path: str, payload: Any, group: Group = None) -> None:
    """Write ``payload`` (moved to the CPU) to ``path``, replacing what was
    there only once the new file is complete; under ``group`` rank 0
    writes and every rank returns once it has."""
    if rank(group) == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(_to_cpu(payload), tmp)
        os.replace(tmp, path)
    barrier(group)


def load_payload(path: str, map_location=None) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    """Step-indexed checkpoint manager with max-to-keep + periodic keeps."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_period: Optional[int] = None, group: Group = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.group = group

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any) -> None:
        if rank(self.group) == 0:
            save_payload(self.path(step), payload)
            steps = self.all_steps()
            for old in steps[:-self.max_to_keep] if self.max_to_keep else []:
                if not (self.keep_period and old % self.keep_period == 0):
                    os.remove(self.path(old))
        barrier(self.group)

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_payload(self.path(step), map_location)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""
