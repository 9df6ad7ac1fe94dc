"""The optimizer and the gradient-control utilities of the pretraining and
finetune steps.

Counterpart of ``ccd_tpu/training/optim.py``. Parity targets in
``Dino/modules/utils.py``: ``get_params_groups`` (biases and 1-D params not
regularized, ``:643-654``), ``clip_gradients`` (PER-PARAMETER norm clipping,
``:132-141``), ``cancel_gradients_last_layer`` (``:144-149``), the in-place
EMA teacher update (``train.py:263-272``), and the finetune path's global-norm
clipping (``torch.nn.utils.clip_grad_norm_``).

Parameters travel as ``{name: tensor}`` dictionaries in the order of
``module.named_parameters()``. The three optimizers of ``make_optimizer``
(train.py:132-137: ``adamw``, ``sgd``, ``lars``) are written out as tensor
functions that follow optax 0.2.6 under ``inject_hyperparams``: the learning
rate and the weight decay are new at every step, every parameter's state
advances at every step whatever its gradient, and the caller may zero a
parameter's whole update afterwards. (``torch.optim.AdamW`` skips a parameter
whose ``grad`` is None, moments and count included, which gives other numbers
from the second step after the last layer is unfrozen.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import torch

from portbench.reference.parallel.mesh import Group, all_reduce_sum

Params = Dict[str, torch.Tensor]
MOMENTUM = 0.9                  # sgd's and lars's trace decay (make_optimizer)
LARS_TRUST_COEFFICIENT = 1e-3   # optax.lars's default, which make_optimizer keeps


def weight_decay_mask(params: Params, norm_last_layer: bool = True) -> Dict[str, bool]:
    """True = regularized. Mirrors get_params_groups: names ending in 'bias'
    and rank<=1 params (LayerNorm scales, biases) get no weight decay.

    ``last_layer.weight_g`` (the DINOHead weight-norm gain) is excluded only
    when ``norm_last_layer``: the reference then freezes it with
    ``requires_grad=False`` (vision_transformer.py:316-317), which drops it
    from ``get_params_groups`` entirely. With ``norm_last_layer=False`` (the
    shipped ViT-Small/Tiny configs) ``weight_g`` is a trainable ndim-2 param
    that get_params_groups DOES regularize, so it is decayed here too."""
    def keep(name: str, p: torch.Tensor) -> bool:
        if name.endswith("last_layer.weight_g"):
            return not norm_last_layer
        return p.ndim > 1 and not name.endswith("bias")
    return {name: keep(name, p) for name, p in params.items()}


@dataclass
class AdamWState:
    """First and second moments, in the parameters' order, and the step count."""
    name = "adamw"
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


def adamw_init(params: Params) -> AdamWState:
    return AdamWState([torch.zeros_like(p) for p in params.values()],
                      [torch.zeros_like(p) for p in params.values()])


def adamw_updates(grads: List[torch.Tensor], state: AdamWState, params: List[torch.Tensor],
                  decay: List[bool], lr: float, weight_decay: float, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8) -> List[torch.Tensor]:
    """One AdamW step as ``optax.adamw`` takes it: advances ``state`` in place
    and returns the updates ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
    (``wd * p`` on the ``decay`` parameters only), to be added to ``params``
    by the caller."""
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
    state.count += 1
    c1 = 1.0 - b1 ** state.count
    c2 = 1.0 - b2 ** state.count
    denom = torch._foreach_div(state.nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    updates = torch._foreach_div(state.mu, c1)
    torch._foreach_div_(updates, denom)
    decayed = [i for i, d in enumerate(decay) if d]
    if decayed and weight_decay != 0.0:
        torch._foreach_add_([updates[i] for i in decayed], [params[i] for i in decayed],
                            alpha=weight_decay)
    torch._foreach_mul_(updates, -lr)
    return updates


@dataclass
class MomentumState:
    """The momentum buffers (optax's ``trace``) of ``sgd`` or ``lars``, in
    the parameters' order."""
    name: str
    trace: List[torch.Tensor]


OptState = Union[AdamWState, MomentumState]


def optimizer_init(name: str, params: Params) -> OptState:
    """Zero state of the named optimizer; an unknown name raises
    ``ValueError``, as ``make_optimizer`` does."""
    if name == "adamw":
        return adamw_init(params)
    if name in ("sgd", "lars"):
        return MomentumState(name, [torch.zeros_like(p) for p in params.values()])
    raise ValueError(f"unknown optimizer {name!r}")


def tensor_norms(tensors: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                 group: Group = None) -> torch.Tensor:
    """Each tensor's L2 norm, stacked in fp32. With a model ``group``, a
    tensor flagged in ``sharded`` gets the norm over every rank's slice (one
    all-reduce of the flagged squares)."""
    norms = [n.float() for n in torch._foreach_norm(tensors)]
    idx = [i for i, f in enumerate(sharded or ()) if f] if group is not None else []
    if idx:
        squares = all_reduce_sum(torch.stack([norms[i] for i in idx]).square(), group,
                                 "sharded_norms")
        for i, n in zip(idx, squares.sqrt().unbind(0)):
            norms[i] = n
    return torch.stack(norms)


def _with_decay(grads: List[torch.Tensor], params: List[torch.Tensor], decay: List[bool],
                weight_decay: float) -> List[torch.Tensor]:
    """``optax.add_decayed_weights(wd, mask)``: ``g + wd * p`` on the
    ``decay`` parameters, ``g`` on the others (a new list)."""
    out = list(grads)
    decayed = [i for i, d in enumerate(decay) if d]
    if decayed:
        summed = torch._foreach_add([grads[i] for i in decayed],
                                    [params[i] for i in decayed], alpha=weight_decay)
        for i, g in zip(decayed, summed):
            out[i] = g
    return out


def momentum_updates(grads: List[torch.Tensor], state: MomentumState,
                     params: List[torch.Tensor], decay: List[bool], lr: float,
                     weight_decay: float, sharded: Optional[List[bool]] = None,
                     group: Group = None) -> List[torch.Tensor]:
    """One step of ``make_optimizer("sgd")`` or ``("lars")``: advances
    ``state.trace`` in place and returns the updates. The two chains take the
    momentum on different sides of the learning rate:

      * sgd = ``add_decayed_weights`` -> ``trace(0.9)`` -> ``scale(-lr)``:
        ``m = (g + wd p) + 0.9 m``, update ``-lr m``;
      * lars = ``add_decayed_weights`` -> trust ratio on the ``decay``
        parameters -> ``scale(-lr)`` -> ``trace(0.9)``:
        ``m = -lr trust(g + wd p) + 0.9 m``, update ``m``, where
        ``trust(u) = u * 0.001 * |p| / |u|``, or ``u`` where either norm is 0.

    Nothing is read back to the host. ``sharded``/``group``: the norms of
    sliced parameters are over the model group (:func:`tensor_norms`)."""
    lars = state.name == "lars"
    updates = _with_decay(grads, params, decay, weight_decay)
    idx = [i for i, d in enumerate(decay) if d] if lars else []
    if idx:
        shards = [bool(sharded and sharded[i]) for i in idx]
        p_norm = tensor_norms([params[i] for i in idx], shards, group)
        u_norm = tensor_norms([updates[i] for i in idx], shards, group)
        ratio = LARS_TRUST_COEFFICIENT * p_norm / u_norm
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)
        scaled = torch._foreach_mul([updates[i] for i in idx], list(ratio.unbind(0)))
        for i, u in zip(idx, scaled):
            updates[i] = u
    if lars:
        updates = torch._foreach_mul(updates, -lr)
    torch._foreach_mul_(state.trace, MOMENTUM)
    torch._foreach_add_(state.trace, updates)
    # copies: the caller zeroes the frozen last layer's updates in place
    return [t.clone() for t in state.trace] if lars else torch._foreach_mul(state.trace, -lr)


def optimizer_updates(grads: List[torch.Tensor], state: OptState, params: List[torch.Tensor],
                      decay: List[bool], lr: float, weight_decay: float,
                      sharded: Optional[List[bool]] = None, group: Group = None
                      ) -> List[torch.Tensor]:
    """One step of whichever optimizer ``state`` belongs to (see
    :func:`adamw_updates`, :func:`momentum_updates`; AdamW is elementwise
    and needs no ``sharded``/``group``)."""
    if isinstance(state, AdamWState):
        return adamw_updates(grads, state, params, decay, lr, weight_decay)
    return momentum_updates(grads, state, params, decay, lr, weight_decay, sharded, group)


def clip_gradients_per_param(grads: List[torch.Tensor], clip: Optional[float],
                             sharded: Optional[List[bool]] = None, group: Group = None
                             ) -> List[torch.Tensor]:
    """Per-parameter L2 norm clipping (clip_gradients, utils.py:132-141):
    ``g * clip / (norm + 1e-6)`` where that coefficient is below 1. In place.
    ``sharded``/``group``: a sliced parameter's norm is over the model
    group (:func:`tensor_norms`)."""
    if not clip:
        return grads
    norms = tensor_norms(grads, sharded, group)
    coefs = norms.add_(1e-6).reciprocal_().mul_(clip).clamp_max_(1.0)
    torch._foreach_mul_(grads, list(coefs.unbind(0)))
    return grads


def clip_gradients_global_norm(grads: List[torch.Tensor], clip: Optional[float]
                               ) -> List[torch.Tensor]:
    """Global-norm clipping (``torch.nn.utils.clip_grad_norm_``, the finetune
    path): every gradient times ``min(clip / (norm + 1e-6), 1)``, ``norm`` the
    L2 norm over all of them. In place; reads nothing back to the host."""
    if not clip:
        return grads
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).float())
    coef = (clip / (norm + 1e-6)).clamp_max(1.0)
    torch._foreach_mul_(grads, coef)
    return grads


def cancel_last_layer_grads(names: List[str], grads: List[torch.Tensor], freeze: bool
                            ) -> List[torch.Tensor]:
    """Zero the DINO-head last-layer entries of ``grads`` while ``freeze``.

    Matches cancel_gradients_last_layer: params whose name contains
    'last_layer'. The reference sets ``p.grad = None`` which makes torch
    AdamW skip the parameter COMPLETELY (no weight decay either) — so the
    train step also applies this to the optimizer *updates*, not just the
    gradients (see make_pretrain_step). In place."""
    if freeze:
        for name, g in zip(names, grads):
            if "last_layer" in name:
                g.zero_()
    return grads


@torch.no_grad()
def ema_update(teacher: List[torch.Tensor], student: List[torch.Tensor], momentum: float
               ) -> None:
    """teacher = m * teacher + (1 - m) * student, in place (train.py:263-272)."""
    torch._foreach_mul_(teacher, momentum)
    torch._foreach_add_(teacher, student, alpha=1.0 - momentum)
