"""The supervised finetune step (teacher-forced CE recognition training).

Counterpart of ``ccd_tpu/training/finetune_step.py``, the
``train_finetune.py:262-290`` loop body as one function per iteration:
forward with teacher forcing, CE over the non-PAD targets (``tf_loss``),
backward, optional global-norm clipping, AdamW with a cosine (warm-up)
learning rate and constant weight decay.

PyTorch runs it eagerly and in place: the state owns the recognizer, the
optimizer moments, the iteration and two generators, and ``step`` updates
them where they are. The learning rate is computed on the host from the
Python iteration count, so the step reads nothing back from the device.
``make_finetune_step`` takes normalised images; ``make_fused_finetune_step``
takes raw uint8 (or [0, 1] float) images and augments them on the device
(``data/augment.py::supervised_augment``) from the state's augmentation
generator; ``make_multi_finetune_step`` runs K fused steps over a staged
(K, B, ...) chunk.

Data parallelism (``group``, ``parallel/mesh.py``): every process holds the
whole recognizer and runs the step on its share of the global batch; its
loss is its share of the global one (``tf_loss`` over the global count of
non-PAD targets), one all-reduce sums the ranks' gradients before the
global-norm clip, so every rank clips and steps alike and the parameters
stay equal across ranks. The reported loss is the global one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function as _phase  # names the step's phases in a trace

from ccd_tpu_torch.checkpoints.torch_io import generator_payload, restore_generators
from ccd_tpu_torch.data.augment import normalize
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.losses import tf_loss
from ccd_tpu_torch.models.recognizer import CCDRecognizer
from ccd_tpu_torch.parallel.mesh import Group, all_reduce_flat, all_reduce_sum, rank_seed
from ccd_tpu_torch.schedules import cosine_iter_schedule
from ccd_tpu_torch.training.optim import (AdamWState, adamw_init, adamw_updates,
                                          clip_gradients_global_norm, weight_decay_mask)



@dataclass
class FinetuneState:
    model: CCDRecognizer             # training mode while it trains
    opt_state: AdamWState
    iteration: int
    generator: torch.Generator       # draws the dropout and drop-path masks
    aug_generator: torch.Generator   # draws the fused step's augmentation


def init_finetune_state(model: CCDRecognizer, seed: int = 0, process: int = 0) -> FinetuneState:
    """The initial state around a built recognizer: training mode, AdamW
    moments at zero, and the dropout and augmentation generators on the
    model's device from ``s`` and ``s + 1``, ``s = rank_seed(seed,
    process)``: the data-parallel ranks draw apart."""
    model.train()
    device = next(model.parameters()).device
    s = rank_seed(seed, process)
    return FinetuneState(model=model, opt_state=adamw_init(dict(model.named_parameters())),
                         iteration=0,
                         generator=torch.Generator(device=device).manual_seed(s),
                         aug_generator=torch.Generator(device=device).manual_seed(s + 1))


def finetune_state_payload(state: FinetuneState, best_accuracy: float = 0.0,
                           group: Group = None) -> dict:
    """Checkpoint payload mirroring the reference's ``{net, optimizer,
    iteration}`` periodic and best checkpoints (``train_finetune.py:373-389``),
    plus ``best_accuracy`` so that a resumed run keeps its best-checkpoint
    tracking, and every rank's generator states (``generator_payload``;
    under ``group`` every rank calls this). The weights are under ``net``, as
    in a reference checkpoint, so ``builders.load_recognizer_params`` reads
    them too."""
    return {"net": state.model.state_dict(),
            "opt_state": {"mu": state.opt_state.mu, "nu": state.opt_state.nu,
                          "count": state.opt_state.count},
            "iteration": state.iteration, "best_accuracy": float(best_accuracy),
            **generator_payload([state.generator, state.aug_generator], group)}


def restore_finetune_state(state: FinetuneState, payload: dict,
                           group: Group = None) -> FinetuneState:
    """Put a :func:`finetune_state_payload` back into ``state``, in place: the
    weights, the optimizer moments and count, the iteration (tensors are
    copied onto the state's device) and this rank's generator states (a
    payload of another world size than ``group``'s raises ``ValueError``).
    The caller reads ``best_accuracy``."""
    restore_generators([state.generator, state.aug_generator], payload, group)
    state.model.load_state_dict(payload["net"], strict=True)
    opt = payload["opt_state"]
    with torch.no_grad():
        for mine, saved in zip(state.opt_state.mu + state.opt_state.nu, opt["mu"] + opt["nu"]):
            mine.copy_(saved)
    state.opt_state.count = int(opt["count"])
    state.iteration = int(payload["iteration"])
    return state


def make_finetune_step(*, base_lr: float, min_lr: float, total_iters: int, warmup_iters: int,
                       weight_decay: float, clip_grad: Optional[float] = None,
                       group: Group = None
                       ) -> Callable[..., Tuple[FinetuneState, Dict[str, object]]]:
    """Build the train step; ``step(state, images, targets)`` with normalised
    images (B, H, W, 3) and padded target ids (B, T) advances ``state`` in
    place and returns it with ``{"loss": device scalar, "lr": float}``.

    The optimizer is ``ccd_tpu/training/optim.py::make_adamw``'s: AdamW with
    the no-decay grouping of ``weight_decay_mask`` (biases and rank-1
    parameters), a new learning rate at every step and a constant weight
    decay. ``group``: the data-parallel group (see the module docstring);
    None: one process, no collective."""

    def step(state: FinetuneState, images: torch.Tensor, targets: torch.Tensor
             ) -> Tuple[FinetuneState, Dict[str, object]]:
        model = state.model
        it = state.iteration
        lr = cosine_iter_schedule(it, base_lr, min_lr, total_iters, warmup_iters)
        targets = targets.long()
        named = dict(model.named_parameters())
        params = list(named.values())
        mask = weight_decay_mask(named)

        with _phase("forward"):
            logits, _ = model(images, targets, train_mode=True, generator=state.generator)
        with _phase("tf_loss"):
            loss = tf_loss(logits, targets, model.padding_idx, group)
        with _phase("backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad(), _phase("update"):
            # a parameter the loss does not reach (the ViT's segmentation
            # taps) has a zero gradient, not none: AdamW still runs on it
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            grads = all_reduce_flat(grads, group, "gradients")
            grads = clip_gradients_global_norm(grads, clip_grad)
            updates = adamw_updates(grads, state.opt_state, params, [mask[n] for n in named], lr,
                                    weight_decay)
            torch._foreach_add_(params, updates)
            loss = all_reduce_sum(loss.detach().reshape(1), group, "losses")[0]
        state.iteration = it + 1
        return state, {"loss": loss, "lr": lr}

    return step


def make_fused_finetune_step(*, aug_fn: Optional[Callable] = None, **kwargs
                             ) -> Callable[..., Tuple[FinetuneState, Dict[str, object]]]:
    """The step on RAW images: ``step(state, images, targets)`` with images
    (B, H, W, 3) uint8 (or float [0, 1]). The conversion to float, the
    augmentation ``aug_fn(key, images)`` (``supervised_augment``, or None for
    none) with draws from ``state.aug_generator``, and the ImageNet
    normalisation run on the device, then the step of
    :func:`make_finetune_step` (built from ``kwargs``)."""
    inner = make_finetune_step(**kwargs)

    def step(state: FinetuneState, images: torch.Tensor, targets: torch.Tensor):
        # uint8 crosses from the host (4x fewer bytes than fp32) and is
        # converted here, on the device
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        with _phase("augment"):
            if aug_fn is not None:
                images = aug_fn(TorchKey(state.aug_generator), images)
            x = normalize(images)
        return inner(state, x, targets)

    return step


def make_multi_finetune_step(*, aug_fn: Optional[Callable] = None, **kwargs
                             ) -> Callable[..., Tuple[FinetuneState, Dict[str, torch.Tensor]]]:
    """K fused steps over a staged chunk: ``step(state, images (K, B, H, W,
    3), targets (K, B, T)) -> (state, metrics stacked along K)``, as the JAX
    package's ``lax.scan``. The losses stay on the device; the learning rates
    are stacked on the CPU."""
    inner = make_fused_finetune_step(aug_fn=aug_fn, **kwargs)

    def step(state: FinetuneState, images: torch.Tensor, targets: torch.Tensor):
        losses, lrs = [], []
        for x, t in zip(images, targets):
            state, metrics = inner(state, x, t)
            losses.append(metrics["loss"])
            lrs.append(metrics["lr"])
        return state, {"loss": torch.stack(losses), "lr": torch.tensor(lrs)}

    return step
