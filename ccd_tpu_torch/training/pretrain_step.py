"""The CCD pretraining step (student/teacher DINO over char features).

Counterpart of ``ccd_tpu/training/pretrain_step.py::make_pretrain_step``, the
reference hot loop (``train.py:183-298`` + ``ABIDINOModel.forward``) as ONE
function per iteration: student forward (ViT + SegHead), device-side glyph
clustering (no host round-trip of the labels, unlike
``dino_vision.py:59-70``), theta-warping, char pooling + DINO head for student
and teacher, both losses, backward, per-param clipping, the optimizer
(AdamW, sgd or lars) with scheduled lr/wd, the EMA teacher update, and the
DINO-center EMA.

PyTorch runs it eagerly and in place: the state owns the two modules, the
optimizer state and the center, and ``step`` updates them where they are.
Schedules are computed on the host from the Python iteration count, so the
step itself reads nothing back from the device (``label_clusters`` reads one
scalar per flood round). ``make_pretrain_step`` takes the three views and
theta; ``make_fused_pretrain_step`` takes the raw uint8 images and masks and
draws the views on the device (``data/augment.py::pretrain_views``) from the
state's augmentation generator, through ``graphed_augment`` (on the card one
CUDA graph a batch shape); ``make_multi_pretrain_step`` runs K fused steps
over K stacked batches.

Data parallelism (``group``, ``parallel/mesh.py``): every process holds the
whole state and runs the step on its share of the global batch. Its losses
are its shares of the global ones (global denominators, ``losses.py``), the
SegHead's BatchNorm statistics are global, one all-reduce sums the ranks'
gradients before the per-parameter clip, and the centre's sum and count are
all-reduced: every rank then clips, steps and updates the teacher and the
centre alike, and the parameters stay equal across ranks, as on the JAX
package's one global array. The cross-view CE pairs rows on the rank (each
rank's rows are [view 1; view 2] of its own samples), so the fused kernel
runs as on one device. The reported losses are the global ones.

Tensor parallelism (``group`` a ``parallel.mesh.Layout`` with a model axis,
the JAX package's ``(data, model)`` mesh): the ranks of one model group run
the step on the same samples, each holding its columns of the DINO head's
last layer (``weight_v``/``weight_g``), of their optimizer state and of the
centre (:func:`shard_pretrain_state`); everything else is replicated. The
DINO CE is the plain chain over the shards (the JAX step leaves the fused
kernel under a model axis), with each row's maxima and sums all-reduced
over the model group; the head's input sums its gradient over the model
group (Megatron's *f*). The replicated gradients are summed over the world
and divided by ``mp`` (every rank then holds the same bits), the sharded
ones summed over the data group; the clip and the lars trust ratio take a
sharded tensor's norm over the model group. Denominators, BatchNorm
statistics, the centre's sums and the losses go over the data group. A
checkpoint holds the full tensors (:func:`pretrain_state_payload` gathers
the shards), so it resumes at any ``mp``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ccd_tpu_torch.checkpoints.torch_io import generator_payload, restore_generators
from ccd_tpu_torch.data.augment import graphed_augment, pretrain_views
from ccd_tpu_torch.losses import (dino_char_loss, dino_char_loss_fused,
                                  dino_center_update, seg_loss)
from ccd_tpu_torch.models.layers import set_batchnorm_group
from ccd_tpu_torch.models.pretrain import CCDPretrainModel, char_validity_mask
from ccd_tpu_torch.ops.cc_label import label_clusters
from ccd_tpu_torch.ops.warp import affine_grid, grid_sample_binary_packed
from ccd_tpu_torch.parallel.mesh import (Group, Layout, all_reduce_flat, all_reduce_sum,
                                         gather_rows, rank_seed, shard_rows)
from ccd_tpu_torch.schedules import cosine_iter_schedule
from ccd_tpu_torch.training.optim import (
    AdamWState, MomentumState, OptState, cancel_last_layer_grads, clip_gradients_per_param,
    ema_update, optimizer_init, optimizer_updates, weight_decay_mask,
)
from ccd_tpu_torch.utils.cuda_graphs import GraphCache
from ccd_tpu_torch.utils.tracing import span

_EMA_BRANCHES = ("backbone.", "head.")  # what the teacher tracks (train.py:268-272)
# split over the model group along out_dim: the JAX package's column shard of
# head/last_layer_{v,g} (ccd_tpu/parallel/mesh.py::pretrain_state_shardings)
SHARDED_PARAMETERS = ("head.last_layer.weight_v", "head.last_layer.weight_g")


@dataclass
class PretrainState:
    student: CCDPretrainModel        # parameters and BatchNorm running statistics
    teacher: CCDPretrainModel        # backbone + head, evaluation mode, no gradients
    opt_state: OptState              # AdamW moments, or the sgd/lars momentum
    center: torch.Tensor             # (1, out_dim) fp32
    iteration: int
    generator: torch.Generator       # draws the student's drop-path masks
    aug_generator: torch.Generator   # draws the fused step's augmentation


def init_pretrain_state(student: CCDPretrainModel, teacher: CCDPretrainModel,
                        seed: int = 0, optimizer: str = "adamw",
                        process: int = 0) -> PretrainState:
    """Build the initial state around two built models: the teacher starts as
    a copy of the student's backbone+head (train.py:109-110), the optimizer
    state and the center at zero. The drop-path generator and the
    augmentation generator live on the models' device and start from
    ``s`` and ``s + 1``, ``s = rank_seed(seed, process)``: the data-parallel
    ranks draw apart.

    ``optimizer`` is the configuration's name (``config.optimizer``; empty
    means AdamW, as train.py defaults it): ``adamw``, ``sgd`` or ``lars``
    (``training/optim.py``); another name raises ``ValueError``.

    A student built with ``use_bn_in_head`` is refused: the JAX package's
    step cannot train it either. Its ``pool_project`` is applied without
    ``mutable=["batch_stats"]`` (ccd_tpu/training/pretrain_step.py:231-236),
    so the head's BatchNorm in training mode raises Flax's
    ``ModifyScopeVariableError`` ("Cannot update variable "mean" in
    "/head/bn_0" because collection "batch_stats" is immutable"). The module
    itself (``DINOHead(use_bn=True)``) is ported."""
    if student.head.use_bn:
        raise NotImplementedError(
            "use_bn_in_head: the reference JAX step cannot train a DINOHead with BatchNorm "
            "(its pool_project runs without mutable=['batch_stats'] and Flax raises "
            "ModifyScopeVariableError: Cannot update variable \"mean\" in \"/head/bn_0\" "
            "because collection \"batch_stats\" is immutable), so there is no step to port")
    opt_state = optimizer_init(optimizer or "adamw", dict(student.named_parameters()))
    teacher.backbone.load_state_dict(student.backbone.state_dict())
    teacher.head.load_state_dict(student.head.state_dict())
    student.train()
    teacher.eval().requires_grad_(False)
    device = next(student.parameters()).device
    return PretrainState(
        student=student, teacher=teacher,
        opt_state=opt_state,
        center=torch.zeros((1, student.out_dim), dtype=torch.float32, device=device),
        iteration=0,
        generator=torch.Generator(device=device).manual_seed(rank_seed(seed, process)),
        aug_generator=torch.Generator(device=device).manual_seed(rank_seed(seed, process) + 1))


def _sharded_buffers(state: PretrainState):
    """(optimizer buffers in the payload's order, whether each is sharded)."""
    names = [n for n, _ in state.student.named_parameters()]
    opt = state.opt_state
    buffers = opt.trace if isinstance(opt, MomentumState) else opt.mu + opt.nu
    return buffers, [n in SHARDED_PARAMETERS for n in names * (len(buffers) // len(names))]


def shard_pretrain_state(state: PretrainState, group: Union[Group, Layout]) -> PretrainState:
    """Keep this model rank's columns of the DINO head's last layer (student
    and teacher), of their optimizer state and of the centre, in place; a
    no-op without a model axis. Called on the full state, after every rank
    holds rank 0's weights, so the shards start as the unsharded init."""
    layout = Layout.of(group)
    if layout.model is None:
        return state
    index, count = layout.model_index, layout.model_size
    for model in (state.student, state.teacher):  # refuses out_dim % mp first
        model.head.shard_last_layer(index, count, layout.model)
    for t, sharded in zip(*_sharded_buffers(state)):
        if sharded:
            t.data = shard_rows(t.data, index, count)
    state.center = shard_rows(state.center, index, count, dim=1)
    return state


def pretrain_state_payload(state: PretrainState, group: Union[Group, Layout] = None) -> dict:
    """Checkpoint payload mirroring the reference's
    {student, teacher, optimizer, epoch/iteration, dino_loss-center}
    (train.py:197-207); the optimizer as AdamW's ``{mu, nu, count}`` or
    ``{optimizer: 'sgd'|'lars', trace}``; and every data rank's generator
    states (:func:`generator_payload`). Every rank calls this; under a
    model axis the shards are gathered, so the payload holds the full
    tensors whatever ``mp``."""
    layout = Layout.of(group)
    full = lambda t, dim=0: gather_rows(t, layout.model, "checkpoint_shards", dim)
    student, teacher = state.student.state_dict(), state.teacher.state_dict()
    if layout.model is not None:
        for sd in (student, teacher):
            for n in SHARDED_PARAMETERS:
                sd[n] = full(sd[n])
    buffers, sharded = _sharded_buffers(state)
    buffers = [full(b) if f else b for b, f in zip(buffers, sharded)]
    opt = state.opt_state
    if isinstance(opt, AdamWState):
        half = len(buffers) // 2
        opt_payload = {"mu": buffers[:half], "nu": buffers[half:], "count": opt.count}
    else:
        opt_payload = {"optimizer": opt.name, "trace": buffers}
    return {"student": student, "teacher": teacher, "opt_state": opt_payload,
            "center": full(state.center, 1), "iteration": state.iteration,
            **generator_payload([state.generator, state.aug_generator], layout.data)}


def restore_pretrain_state(state: PretrainState, payload: dict,
                           group: Union[Group, Layout] = None) -> PretrainState:
    """Put a :func:`pretrain_state_payload` back into ``state``, in place:
    both modules, the optimizer state (AdamW's moments and count, or the
    sgd/lars momentum), the centre, the iteration (tensors are copied onto
    the state's devices) and this rank's generator states; under a model
    axis each rank takes its own columns of the full tensors. A checkpoint
    of another optimizer than the state's, or of another number of data
    ranks than ``group``'s, raises ``ValueError``."""
    layout = Layout.of(group)
    mine = lambda t, dim=0: t if layout.model is None else \
        shard_rows(t, layout.model_index, layout.model_size, dim)
    opt = payload["opt_state"]
    saved_name = opt.get("optimizer", "adamw")
    if saved_name != state.opt_state.name:
        raise ValueError(f"the checkpoint holds {saved_name} state; this run trains "
                         f"with {state.opt_state.name}")
    restore_generators([state.generator, state.aug_generator], payload, layout.data)
    for model, key in ((state.student, "student"), (state.teacher, "teacher")):
        sd = dict(payload[key])
        for n in SHARDED_PARAMETERS:
            sd[n] = mine(sd[n])
        model.load_state_dict(sd, strict=True)
    buffers, sharded = _sharded_buffers(state)
    if isinstance(state.opt_state, MomentumState):
        saved = opt["trace"]
    else:
        saved = opt["mu"] + opt["nu"]
        state.opt_state.count = int(opt["count"])
    with torch.no_grad():
        for m, s, f in zip(buffers, saved, sharded):
            m.copy_(mine(s) if f else s)
        state.center.copy_(mine(payload["center"], 1))
    state.iteration = int(payload["iteration"])
    return state


def make_pretrain_step(
    *,
    # schedule configuration (train.py:144-158)
    base_lr: float,
    min_lr: float,
    total_iters: int,
    warmup_iters: int,
    weight_decay: float,
    weight_decay_end: float,
    momentum_teacher: float,
    # loss configuration
    teacher_temps: np.ndarray,       # per-epoch teacher temperature
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
    # training control
    clip_grad: Optional[float] = 3.0,
    freeze_last_layer: int = 1,
    global_batch: int = 64,
    imgnet_based: int = 1_000_000,
    gt_mask_epochs: int = 30,        # epoch threshold for GT vs predicted masks
    num_slots: int = 26,
    use_fused_ce: Optional[bool] = None,
    group: Union[Group, Layout] = None,
) -> Callable[..., Tuple[PretrainState, Dict[str, object]]]:
    """Build the train step; ``step(state, images, masks, theta)`` advances
    ``state`` in place and returns it with the step's metrics: the losses
    (device scalars, global), ``lr``, ``wd`` and ``epoch`` (host values of
    the schedule) and ``cluster_rounds``, a host int: the flood rounds of
    this rank's glyph clustering (``label_clusters``), one host read each,
    counted on the rank and not reduced across ranks. It climbs when the
    self-predicted masks take over from the ground truth.

    ``use_fused_ce``: route the DINO CE through the fused kernel (one pass
    over the (2B*T, out_dim) logits, cross-view pairing by addressing,
    ``pool_project(flat=True)`` rows) instead of the plain chain. ``None`` =
    on for CUDA tensors, off on the CPU, and off under a model axis, where
    ``True`` is refused (the kernel's online softmax needs every column on
    the rank; the JAX step keeps its XLA chain there).

    ``group``: the data-parallel ``torch.distributed`` group, or the
    ``parallel.mesh.Layout`` of a ``(data, model)`` run whose state went
    through :func:`shard_pretrain_state` (see the module docstring); the
    inputs are this data rank's share of the global batch and
    ``global_batch`` the global batch's size. None: one process, no
    collective.
    """
    layout = Layout.of(group)
    data, model_group = layout.data, layout.model
    if model_group is not None and use_fused_ce:
        raise ValueError(f"use_fused_ce=True with model_parallel={layout.model_size}: the fused "
                         "DINO CE needs all out_dim columns on one rank; under a model axis the "
                         "step keeps the plain chain (as the JAX step keeps its XLA chain)")
    temps = np.asarray(teacher_temps, np.float32)

    def step(state: PretrainState, images: torch.Tensor, masks: torch.Tensor,
             theta: torch.Tensor) -> Tuple[PretrainState, Dict[str, object]]:
        """images: (B, 3, H, W, 3) three views NHWC; masks: (B, H, W); theta: (B, 3, 3)."""
        student, teacher = state.student, state.teacher
        b, _, h, w, _ = images.shape
        it = state.iteration
        fused = model_group is None and (images.is_cuda if use_fused_ce is None
                                         else use_fused_ce)
        # virtual-epoch bookkeeping (train.py:188)
        epoch = ((it + 1) * global_batch) // imgnet_based
        teacher_temp = float(temps[min(max(epoch, 0), len(temps) - 1)])
        lr = cosine_iter_schedule(it, base_lr, min_lr, total_iters, warmup_iters)
        wd = cosine_iter_schedule(it, weight_decay, weight_decay_end, total_iters)
        m = cosine_iter_schedule(it, momentum_teacher, 1.0, total_iters)
        freeze = epoch < freeze_last_layer
        set_batchnorm_group(student, data)

        x = torch.cat([images[:, 1], images[:, 2]], dim=0)  # (2B, H, W, 3)
        grid = affine_grid(theta[:, :2, :].float(), (h, w))

        with span("student_encode"):
            region_f, taps = student.encode(x, state.generator)
        with span("segment"):
            seg_logits = student.segment(taps)

        with torch.no_grad():
            # ---- glyph clusters: GT masks early, self-predicted later
            # (dino_vision.py:59-70); non-differentiable pseudo-labels
            with span("label_clusters"):
                if epoch < gt_mask_epochs:
                    cluster_src_mask = masks
                else:
                    cluster_src_mask = (torch.softmax(seg_logits.float(), dim=-1)[..., 1]
                                        > 0.5).float()[:b]
                clusters_source, rounds = label_clusters(cluster_src_mask, num_slots=num_slots)
            # warp clusters + GT mask to the view-2 frame in ONE packed-int32
            # bilinear warp (27 binary channels -> 4 single-channel gathers;
            # equal to per-channel grid_sample + >0.1, see warp.py)
            with span("warp"):
                shifts = torch.arange(num_slots, dtype=torch.int32, device=x.device)
                packed = ((clusters_source > 0.5).to(torch.int32)
                          << shifts[None, :, None, None]).sum(dim=1, dtype=torch.int32)
                packed = packed | ((masks > 0.5).to(torch.int32) << num_slots)
                warped = grid_sample_binary_packed(packed, grid, num_slots + 1)
                clusters_image = warped[..., :num_slots].permute(0, 3, 1, 2)
                warped_gt = warped[..., num_slots]
                clusters = torch.cat([clusters_source, clusters_image], dim=0)
            with span("teacher_encode"):
                t_region_f, _ = teacher.encode(x)
            with span("pool_head"):
                t_logits, _ = teacher.pool_project(t_region_f, clusters, flat=fused)

        # flat=True (fused path) emits view-stacked (2B*T, K) rows — the
        # (N, T) collapse happens on the 256-wide head INPUT, not on the
        # out_dim-wide output
        with span("pool_head"):
            s_logits, index = student.pool_project(region_f, clusters, flat=fused)
            valid = char_validity_mask(index[:b], num_slots)

        # ---- losses (train.py:234-238 + Dino_loss.py:59-105);
        # warped_gt came from the packed warp above
        with span("seg_loss"):
            seg_gt = torch.cat([masks, warped_gt], dim=0)
            l_seg = seg_loss(seg_logits, seg_gt, data)
        with span("dino_ce"):
            if fused:
                l_dino = dino_char_loss_fused(s_logits, t_logits, valid, state.center,
                                              teacher_temp, student_temp, group=data)
            else:
                l_dino = dino_char_loss(s_logits, t_logits, valid, state.center, teacher_temp,
                                        student_temp, group=data, model_group=model_group)
            loss = l_seg + l_dino

        named = dict(student.named_parameters())
        names, params = list(named), list(named.values())
        with span("backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad(), span("update"):
            # a parameter the loss does not reach (the frozen weight-norm gain)
            # has a zero gradient, not none: the optimizer still runs on it
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            sharded = [model_group is not None and n in SHARDED_PARAMETERS for n in names]
            grads = _reduce_gradients(grads, sharded, layout)
            grads = clip_gradients_per_param(grads, clip_grad, sharded, model_group)
            grads = cancel_last_layer_grads(names, grads, freeze)
            decay = weight_decay_mask(named, student.norm_last_layer)
            updates = optimizer_updates(grads, state.opt_state, params,
                                        [decay[n] for n in names], lr, wd, sharded, model_group)
            # cancel_gradients_last_layer sets p.grad=None, which makes torch
            # AdamW skip the param entirely — weight decay included — so the
            # whole UPDATE is zeroed while frozen, not just the gradient. As
            # in the JAX step, the optimizer has run on the zeroed gradient
            # first: sgd's and lars's momentum of the frozen last layer keeps
            # gathering its weight-decay term, and moves it once unfrozen.
            updates = cancel_last_layer_grads(names, updates, freeze)
            torch._foreach_add_(params, updates)

            # EMA teacher over backbone + head only, with the NEW student params
            t_named = dict(teacher.named_parameters())
            tracked = [n for n in names if n.startswith(_EMA_BRANCHES)]
            ema_update([t_named[n] for n in tracked], [named[n] for n in tracked], m)
            state.center = dino_center_update(state.center, t_logits, valid, center_momentum,
                                              data)
            losses = all_reduce_sum(torch.stack([loss, l_seg, l_dino]).detach(), data,
                                    "losses")

        state.iteration = it + 1
        metrics = {"loss": losses[0], "mask_loss": losses[1], "dino_loss": losses[2],
                   "lr": lr, "wd": wd, "epoch": epoch, "cluster_rounds": rounds}
        return state, metrics

    return step


def _reduce_gradients(grads, sharded, layout: Layout):
    """Sum the ranks' gradients. Data parallelism: one flat all-reduce over
    the group. Under a model axis: the replicated ones over the world, over
    ``mp`` (each model rank computed the whole gradient of its data rank's
    samples), and the sharded ones over the data group, one flat all-reduce
    each."""
    if layout.model is None:
        return all_reduce_flat(grads, layout.data, "gradients")
    out = list(grads)
    for flag, group, what in ((False, layout.world, "gradients"),
                              (True, layout.data, "sharded_gradients")):
        idx = [i for i, f in enumerate(sharded) if f == flag]
        summed = all_reduce_flat([grads[i] for i in idx], group, what)
        if not flag:
            torch._foreach_mul_(summed, 1.0 / layout.model_size)
        for i, g in zip(idx, summed):
            out[i] = g
    return out


def make_fused_pretrain_step(*, severity: int = 5, **kwargs
                             ) -> Callable[..., Tuple[PretrainState, Dict[str, object]]]:
    """The step on RAW images: ``step(state, raw, masks)`` with raw
    (B, H, W, 3) uint8 (or float [0,1]) and masks (B, H, W) uint8 or float.
    The conversion to float, the 3-view augmentation and theta run on the
    device, with draws from ``state.aug_generator``, then the step of
    :func:`make_pretrain_step` (built from ``kwargs``). The augmentation goes
    through ``graphed_augment`` with the step's own graph cache."""
    inner = make_pretrain_step(**kwargs)
    graphs = GraphCache("augment_graph")

    def step(state: PretrainState, raw: torch.Tensor, masks: torch.Tensor):
        # uint8 crosses from the host (4x fewer bytes than fp32) and is
        # converted here, on the device
        if raw.dtype == torch.uint8:
            raw = raw.float() / 255.0
        if masks.dtype != torch.float32:
            masks = masks.float()
        with span("augment"):
            views, theta = graphed_augment(graphs, state.aug_generator, raw, pretrain_views,
                                           severity)
        return inner(state, views, masks, theta)

    return step


def make_multi_pretrain_step(*, severity: int = 5, **kwargs
                             ) -> Callable[..., Tuple[PretrainState, Dict[str, torch.Tensor]]]:
    """K fused steps over K stacked batches: ``step(state, raws (K, B, H, W,
    3), masks (K, B, H, W)) -> (state, metrics stacked along K)``, as the JAX
    package's ``lax.scan``. The losses stay on the device; the host-side
    schedule values and ``cluster_rounds`` are stacked on the CPU."""
    inner = make_fused_pretrain_step(severity=severity, **kwargs)

    def step(state: PretrainState, raws: torch.Tensor, masks: torch.Tensor):
        history = []
        for raw, mask in zip(raws, masks):
            state, metrics = inner(state, raw, mask)
            history.append(metrics)
        stacked = {k: torch.stack([m[k] for m in history]) if torch.is_tensor(history[0][k])
                   else torch.tensor([m[k] for m in history]) for k in history[0]}
        return state, stacked

    return step
