"""Process groups, data-parallel layout and the collectives of the steps.

Counterpart of ``ccd_tpu/parallel/mesh.py``. The JAX package lays one 1-D
``Mesh(('data',))`` over the chips and lets GSPMD insert the gradient
``psum``, the global BatchNorm statistics and the DINO-centre sum. The port
runs one process per GPU, started by ``torchrun`` (``env://``: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), each with
the whole model, and makes those reductions itself over a
``torch.distributed`` group: NCCL on the card, gloo on the CPU. The "mesh"
here is that group, or None for one process without ``torch.distributed``.

Every collective of the port goes through the helpers below, which count
calls and bytes by (operation, what it carries) for ``cli.collective_audit``
and ``chip_smoke.py``. A helper given no group calls nothing and returns
its input.

Tensor parallelism (``mesh.model_parallel > 1``: the column-sharded DINO
head) is not ported yet: :func:`pretrain_mesh` refuses it (ROADMAP M11b).
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# (operation, what it carries) -> [calls, bytes]; see collective_counts()
_COUNTS: Dict[Tuple[str, str], List[int]] = defaultdict(lambda: [0, 0])


def _count(op: str, what: str, nbytes: int) -> None:
    entry = _COUNTS[(op, what)]
    entry[0] += 1
    entry[1] += int(nbytes)


def collective_counts() -> Dict[str, Dict[str, int]]:
    """``{"<op>:<what>": {"calls": n, "bytes": b}}`` since the last reset;
    the backward of a differentiable all-reduce counts as ``<what>_backward``."""
    return {f"{op}:{what}": {"calls": c, "bytes": b} for (op, what), (c, b) in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()


# ------------------------------------------------------------------ processes
def init_distributed(device: torch.device) -> Tuple[torch.device, Group]:
    """Join the group ``torchrun`` describes in the environment, or none.

    Without ``WORLD_SIZE`` in the environment: ``(device, None)``, one
    process. With it: the default group over ``env://`` (NCCL for a CUDA
    ``device``, gloo for the CPU), created here unless it exists, and on the
    card the process's GPU ``cuda:<LOCAL_RANK>``. A failure to join raises."""
    if "WORLD_SIZE" not in os.environ:
        return device, None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return device, dist.group.WORLD


@contextlib.contextmanager
def distributed_run(device: torch.device) -> Iterator[torch.device]:
    """An entry point's run: :func:`init_distributed`, and at the end the
    group destroyed if it was created here. Yields the process's device."""
    created = not (dist.is_available() and dist.is_initialized())
    device, group = init_distributed(device)
    try:
        yield device
    finally:
        if created and group is not None:
            dist.destroy_process_group()


def world(group: Group = None) -> int:
    """The group's size; 1 without a group."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group = None) -> int:
    """This process's rank in the group; 0 without a group."""
    return 0 if group is None else dist.get_rank(group)


def backend(group: dist.ProcessGroup) -> str:
    """The group's backend: ``nccl`` or ``gloo``."""
    return str(dist.get_backend(group))


def default_group() -> Group:
    """The default group when ``torch.distributed`` is initialised, else None."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank_seed(seed: int, process: int) -> int:
    """The seed of process ``process``'s generators: ``seed`` on rank 0, and
    apart from every other rank's for seeds below 2^32."""
    return int(seed) + (int(process) << 32)


def data_mesh(num_devices: Optional[int] = None) -> Group:
    """The data-parallel group: every process, one GPU each (the default
    group, or None for one process without ``torch.distributed``).
    ``num_devices`` (``mesh.num_devices``) must be None or the world size:
    more is refused in the JAX package's words, fewer would leave ranks
    without data."""
    group = default_group()
    n = world(group)
    if num_devices is not None:
        num_devices = int(num_devices)
        if num_devices > n:
            raise ValueError(f"num_devices={num_devices} > available {n}")
        if num_devices < n:
            raise ValueError(f"num_devices={num_devices} < world size {n}: {n - num_devices} "
                             f"processes would have no data; start {num_devices} processes "
                             "(torchrun --nproc_per_node) or leave mesh.num_devices null")
    return group


def pretrain_mesh(num_devices: Optional[int] = None, model_parallel: Optional[int] = 1) -> Group:
    """:func:`data_mesh` for ``model_parallel`` None or 1. Tensor parallelism
    of the DINO head (``model_parallel > 1``) is not ported yet."""
    mp = int(model_parallel or 1)
    if mp > 1:
        raise NotImplementedError(
            f"mesh.model_parallel={mp}: tensor parallelism of the DINO head (its column-sharded "
            "last layer, centre and moments) is not ported yet (ROADMAP M11b); set "
            "mesh.model_parallel to 1 or null for data parallelism over the processes")
    return data_mesh(num_devices)


# ------------------------------------------------------------------ collectives
def _comm(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``t`` where the group's backend can reduce it: NCCL wants the card
    (host-side values such as meters and counters cross to it and back)."""
    if backend(group) == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_sum(t: torch.Tensor, group: Group, what: str,
                   differentiable: bool = False) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor when ``differentiable``,
    whose gradient is the sum of the ranks' gradients; else ``t`` reduced in
    place); ``t`` itself without a group."""
    if group is None:
        return t
    _count("all_reduce", what, t.numel() * t.element_size())
    if differentiable:
        from torch.distributed.nn.functional import all_reduce
        out = all_reduce(t, group=group)
        if out.requires_grad:
            out.register_hook(lambda g: _count("all_reduce", f"{what}_backward",
                                               g.numel() * g.element_size()))
        return out
    return _reduce_in_place(t, dist.ReduceOp.SUM, group)


def _reduce_in_place(t: torch.Tensor, op, group: dist.ProcessGroup) -> torch.Tensor:
    on = _comm(t, group)
    dist.all_reduce(on, op=op, group=group)
    if on is not t:
        t.copy_(on)
    return t


def all_reduce_max(t: torch.Tensor, group: Group, what: str) -> torch.Tensor:
    """``t`` reduced in place to its maximum over the group."""
    if group is None:
        return t
    _count("all_reduce_max", what, t.numel() * t.element_size())
    return _reduce_in_place(t, dist.ReduceOp.MAX, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group: Group, what: str
                    ) -> List[torch.Tensor]:
    """The sums over the group of ``tensors`` (one type), through ONE
    all-reduce of a flat buffer of all of them; the tensors themselves
    without a group."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum(flat, group, what)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                tensors)]


def broadcast_module(module: torch.nn.Module, group: Group) -> None:
    """Overwrite every parameter and buffer of ``module`` with rank 0's, one
    broadcast of a flat buffer per type."""
    if group is None:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        _count("broadcast", "module", flat.numel() * flat.element_size())
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        with torch.no_grad():
            for part, t in zip(flat.split([t.numel() for t in same]), same):
                t.copy_(part.view_as(t))


def all_gather_bytes(t: torch.Tensor, group: Group, what: str) -> List[torch.Tensor]:
    """Every rank's uint8 tensor ``t`` (all of one size), in rank order, on
    the CPU; ``[t]`` without a group."""
    if group is None:
        return [t.cpu()]
    mine = _comm(t.contiguous(), group)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    _count("all_gather", what, mine.numel() * mine.element_size())
    dist.all_gather(parts, mine, group=group)
    return [p.cpu() for p in parts]


def barrier(group: Group) -> None:
    if group is None:
        return
    _count("barrier", "barrier", 0)
    if backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


# ------------------------------------------------------------------ batches
def _take(x: Any, dim: int, index: int, count: int) -> Any:
    if isinstance(x, (list, tuple)):
        return type(x)(_take(v, dim, index, count) for v in x)
    if isinstance(x, dict):
        return {k: _take(v, dim, index, count) for k, v in x.items()}
    n = x.shape[dim]
    if n % count:
        raise ValueError(f"a global batch of {n} does not split over {count} processes")
    per = n // count
    return x.narrow(dim, index * per, per) if torch.is_tensor(x) else \
        x[(slice(None),) * dim + (slice(index * per, (index + 1) * per),)]


def shard_batch(batch: Any, index: int, count: int) -> Any:
    """Process ``index``'s share of a global (B * count, ...) batch (dim 0),
    the rows the JAX package's ``shard_batch`` places on that process."""
    return _take(batch, 0, index, count)


def shard_stacked_batch(batch: Any, index: int, count: int) -> Any:
    """The same for (K, B * count, ...) multi-step batches (dim 1)."""
    return _take(batch, 1, index, count)
