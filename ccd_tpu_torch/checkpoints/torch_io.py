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
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_payload(path: str, payload: Any) -> None:
    """Write ``payload`` (moved to the CPU) to ``path``, replacing what was
    there only once the new file is complete."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path)


def load_payload(path: str, map_location=None) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    """Step-indexed checkpoint manager with max-to-keep + periodic keeps."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_period: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any) -> None:
        save_payload(self.path(step), payload)
        steps = self.all_steps()
        for old in steps[:-self.max_to_keep] if self.max_to_keep else []:
            if not (self.keep_period and old % self.keep_period == 0):
                os.remove(self.path(old))

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_payload(self.path(step), map_location)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""
