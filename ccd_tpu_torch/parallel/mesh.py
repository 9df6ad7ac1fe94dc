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
calls and bytes by (operation, what it carries), and by the group they
cross, for ``cli.collective_audit`` and ``chip_smoke.py``. A helper given no
group calls nothing and returns its input.

Tensor parallelism (``mesh.model_parallel = mp > 1``, the JAX package's
``(data, model)`` mesh): :func:`pretrain_mesh` lays the ``n`` processes out
as ``n / mp`` data ranks by ``mp`` model ranks, ``rank = data_index * mp +
model_index`` (JAX's ``reshape(n // mp, mp)``: a model group is consecutive
ranks, on one node), and returns a :class:`Layout` naming the data group
(the ranks of one ``model_index``), the model group (the ranks of one
``data_index``) and the world. The DINO head's last layer, its optimizer
state and the centre are split over the model group along ``out_dim``
(:func:`shard_rows`, :func:`gather_rows`; ``pretrain_step.py``); the head's
input passes :func:`copy_to_model_group` (Megatron's *f*: identity forward,
all-reduce backward).
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# (operation, what it carries) -> [calls, bytes]; see collective_counts()
_COUNTS: Dict[Tuple[str, str], List[int]] = defaultdict(lambda: [0, 0])
# the name of the group each call crossed -> [calls, bytes]
_GROUP_COUNTS: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
# id(group) -> (group, "world" | "data" | "model"), set by pretrain_mesh
_GROUP_NAMES: Dict[int, Tuple[Any, str]] = {}


def _group_name(group) -> str:
    named = _GROUP_NAMES.get(id(group))
    if named is not None and named[0] is group:
        return named[1]
    return "world" if group is dist.group.WORLD else "group"


def _count(op: str, what: str, nbytes: int, group=None) -> None:
    for entry in (_COUNTS[(op, what)], _GROUP_COUNTS[_group_name(group)]):
        entry[0] += 1
        entry[1] += int(nbytes)


def collective_counts() -> Dict[str, Dict[str, int]]:
    """``{"<op>:<what>": {"calls": n, "bytes": b}}`` since the last reset;
    the backward of a differentiable all-reduce counts as ``<what>_backward``."""
    return {f"{op}:{what}": {"calls": c, "bytes": b} for (op, what), (c, b) in _COUNTS.items()}


def collective_counts_by_group() -> Dict[str, Dict[str, int]]:
    """The same calls summed by the group they crossed: ``{"world" | "data" |
    "model": {"calls", "bytes"}}`` (a data-parallel group is the world)."""
    return {name: {"calls": c, "bytes": b} for name, (c, b) in _GROUP_COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()
    _GROUP_COUNTS.clear()


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


@dataclass(frozen=True)
class Layout:
    """Where this process sits in the ``(data, model)`` layout.

    ``data``: the ranks that hold the same columns of the DINO head and
    different samples (reductions over the batch: gradients of the sharded
    tensors, denominators, BatchNorm statistics, the centre, losses,
    meters); ``model``: the ranks that hold the same samples and different
    columns (the CE's row statistics, the head input's gradient, the norms
    of the sharded tensors), None without a model axis; ``world``: every
    process (the replicated gradients). Without a model axis ``data`` is
    ``world``: plain data parallelism."""
    data: Group
    model: Group
    world: Group
    data_index: int = 0
    model_index: int = 0
    data_size: int = 1
    model_size: int = 1

    @staticmethod
    def of(group: Union[Group, "Layout"]) -> "Layout":
        """``group`` itself if it is a layout, else the data-parallel layout
        over it (no model axis)."""
        if isinstance(group, Layout):
            return group
        return Layout(data=group, model=None, world=group, data_index=rank(group),
                      data_size=world(group))


def pretrain_mesh(num_devices: Optional[int] = None,
                  model_parallel: Optional[int] = 1) -> Layout:
    """The pretraining layout (``ccd_tpu/parallel/mesh.py::pretrain_mesh``):
    :func:`data_mesh` for ``model_parallel`` None or 1, else ``n / mp`` data
    ranks by ``mp`` model ranks over the ``n`` processes, refused in the JAX
    package's words where ``mp`` does not divide ``n`` or where a model group
    would span hosts (``LOCAL_WORLD_SIZE``, the processes on this node, not a
    multiple of ``mp``). Every process calls it: the groups are made
    collectively."""
    mp = max(int(model_parallel or 1), 1)
    group = data_mesh(num_devices)
    if mp == 1:
        return Layout.of(group)
    n = world(group)
    if n % mp != 0:
        raise ValueError(f"model_parallel={mp} must divide device count {n}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host % mp != 0:
        raise ValueError(
            f"model_parallel={mp} would span hosts ({per_host} local processes per host): "
            "a model group's collectives and the checkpoint's gather of the shards need "
            "every model group on one node")
    me = rank(group)
    data_ranks = [[d * mp + m for d in range(n // mp)] for m in range(mp)]
    model_ranks = [[d * mp + m for m in range(mp)] for d in range(n // mp)]
    data, _ = dist.new_subgroups_by_enumeration(data_ranks)
    model, _ = dist.new_subgroups_by_enumeration(model_ranks)
    for g, name in ((data, "data"), (model, "model")):
        _GROUP_NAMES[id(g)] = (g, name)
    return Layout(data=data, model=model, world=group, data_index=me // mp,
                  model_index=me % mp, data_size=n // mp, model_size=mp)


# ------------------------------------------------------------------ collectives
def _comm(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``t`` where the group's backend takes it: NCCL wants the card
    (host-side values such as meters and counters cross to it and back),
    gloo the host (a gloo group of processes that share one card stages
    their tensors through the CPU)."""
    nccl = backend(group) == "nccl"
    if nccl and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    if not nccl and t.is_cuda:
        return t.cpu()
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, whose gradient is the sum of the ranks'
    gradients (counted as ``<what>_backward``)."""

    @staticmethod
    def forward(ctx, t, group, what):
        ctx.group, ctx.what = group, what
        return _reduce_in_place(t.clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        _count("all_reduce", f"{ctx.what}_backward", g.numel() * g.element_size(), ctx.group)
        return _reduce_in_place(g.clone(), dist.ReduceOp.SUM, ctx.group), None, None


class _CopyToModelGroup(_AllReduceSum):
    """Megatron's *f*: identity forward, all-reduce of the gradient over the
    model group backward."""

    @staticmethod
    def forward(ctx, t, group, what):
        ctx.group, ctx.what = group, what
        return t.view_as(t)


def copy_to_model_group(t: torch.Tensor, group: Group, what: str) -> torch.Tensor:
    """``t`` into a layer whose columns are split over the model ``group``:
    each rank's gradient of ``t`` is its columns' share, and the backward
    sums the shares, so every rank holds the whole gradient. ``t`` itself
    without a group."""
    if group is None:
        return t
    return _CopyToModelGroup.apply(t, group, what)


def all_reduce_sum(t: torch.Tensor, group: Group, what: str,
                   differentiable: bool = False) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor when ``differentiable``,
    whose gradient is the sum of the ranks' gradients; else ``t`` reduced in
    place); ``t`` itself without a group."""
    if group is None:
        return t
    _count("all_reduce", what, t.numel() * t.element_size(), group)
    if differentiable:
        return _AllReduceSum.apply(t, group, what)
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
    _count("all_reduce_max", what, t.numel() * t.element_size(), group)
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
    """Overwrite every parameter and buffer of ``module`` with the group's
    rank 0's, one broadcast of a flat buffer per type."""
    if group is None:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _comm(torch.cat([t.detach().reshape(-1) for t in same]), group)
        _count("broadcast", "module", flat.numel() * flat.element_size(), group)
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
    _count("all_gather", what, mine.numel() * mine.element_size(), group)
    dist.all_gather(parts, mine, group=group)
    return [p.cpu() for p in parts]


def shard_rows(t: torch.Tensor, index: int, count: int, dim: int = 0) -> torch.Tensor:
    """Part ``index`` of ``count`` equal parts of ``t`` along ``dim`` (a copy):
    a model rank's columns of the DINO head (rows of the torch layout's
    ``weight_v``/``weight_g``, columns of the centre)."""
    n = t.shape[dim]
    if n % count:
        raise ValueError(f"{n} does not split into {count} equal parts")
    return t.narrow(dim, index * (n // count), n // count).clone()


def gather_rows(t: torch.Tensor, group: Group, what: str, dim: int = 0) -> torch.Tensor:
    """The model group's parts of ``t`` (one size on every rank), concatenated
    in rank order along ``dim`` on ``t``'s device: the inverse of
    :func:`shard_rows`. ``t`` itself without a group."""
    if group is None:
        return t
    mine = _comm(t.detach().contiguous(), group)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    _count("all_gather", what, mine.numel() * mine.element_size(), group)
    dist.all_gather(parts, mine, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def barrier(group: Group) -> None:
    if group is None:
        return
    _count("barrier", "barrier", 0, group)
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
