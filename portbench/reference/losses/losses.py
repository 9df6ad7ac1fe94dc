"""Training losses (pure functions over whole-batch tensors).

Counterpart of ``ccd_tpu/losses/losses.py``. Parity targets:
  * :func:`seg_loss` — ``SegLoss`` as *invoked* by ``DINOLoss.forward``
    (``Dino/loss/Dino_loss.py:59-68``): note the reference applies
    ``F.cross_entropy`` to an already-softmaxed prediction (a double softmax);
    reproduced as-is.
  * :func:`dino_char_loss` + :func:`dino_center_update` — ``DINOLoss``
    (``Dino_loss.py:35-143``) with the ragged valid-char concat replaced by a
    padded (B, 26) validity mask; the masked mean over (loss * mask) equals
    the reference's ``.mean()`` over the flattened valid rows.
  * :func:`dino_char_loss_fused` — the same loss through the fused
    cross-entropy kernel (:mod:`portbench.reference.ops.fused_dino_ce`).
  * :func:`tf_loss` — the finetune path's teacher-forced CE
    (``train_finetune.py:276-282``).

Data parallelism (``group``): each process holds a share of the global
batch, and each loss returns that process's SHARE of the loss on the global
batch, so that the ranks' losses, and their gradients, sum to the JAX
step's on the concatenated batch (GSPMD reduces its means globally). The
denominators are global: the valid char slots of the DINO CE and the
non-PAD targets of ``tf_loss`` are all-reduced (a mean of per-rank means
would weigh the ranks wrongly, their counts differ); ``seg_loss`` has the
same count on every rank, so its share is the local mean over the world
size. Without a group no collective runs and the losses are the plain ones.

Tensor parallelism (``model_group``): the DINO head's logits and the centre
hold this model rank's columns of ``out_dim``. :func:`dino_char_loss` then
all-reduces each row's maxima and sums over the model group
(:class:`_ShardedCrossViewCE`), and :func:`dino_center_update` updates the
rank's own columns; ``group`` is the data group (the ranks of other samples).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ops.fused_dino_ce import fused_dino_row_ce
from portbench.reference.parallel.mesh import Group, all_reduce_max, all_reduce_sum, world


def _global_count(w: torch.Tensor, group: Group, what: str) -> torch.Tensor:
    """The sum of the 0/1 weights ``w`` over the group, at least 1."""
    return all_reduce_sum(w.sum().float().reshape(1), group, what)[0].clamp_min(1.0)


def seg_loss(seg_logits: torch.Tensor, gt_masks: torch.Tensor,
             group: Group = None) -> torch.Tensor:
    """Per-pixel 2-class CE of softmaxed mask logits vs {0,1} GT.

    seg_logits: (N, H, W, 2); gt_masks: (N, H, W) in {0, 1}. Under ``group``
    the rank's share: its mean over the world size.
    """
    probs = torch.softmax(seg_logits.float(), dim=-1)
    logp = torch.log_softmax(probs, dim=-1)  # reference's double softmax
    y = gt_masks.float()
    nll = -(logp[..., 0] * (1.0 - y) + logp[..., 1] * y)
    return nll.mean() / world(group)


def teacher_temp_schedule(warmup_teacher_temp: float, teacher_temp: float,
                          warmup_teacher_temp_epochs: int, nepochs: int) -> np.ndarray:
    """Per-epoch teacher temperature (Dino_loss.py:47-51)."""
    return np.concatenate([
        np.linspace(warmup_teacher_temp, teacher_temp,
                    warmup_teacher_temp_epochs),
        np.ones(max(nepochs - warmup_teacher_temp_epochs, 0)) * teacher_temp,
    ]).astype(np.float32)


def dino_char_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                   valid: torch.Tensor, center: torch.Tensor, teacher_temp: float,
                   student_temp: float = 0.1, group: Group = None,
                   model_group: Group = None) -> torch.Tensor:
    """Cross-view character-distillation CE (the plain chain).

    student_logits/teacher_logits: (2B, T, K) — view-1 then view-2 halves.
    valid: (B, T) bool char-slot mask (shared across views, dino_vision.py:87).
    center: (1, K) teacher centering state. With ``model_group`` K is this
    rank's columns and the CE is :class:`_ShardedCrossViewCE`'s.
    """
    w = valid.float()
    denom = _global_count(w, group, "dino_denominator")
    if model_group is not None:
        w = w.reshape(-1)
        return _ShardedCrossViewCE.apply(student_logits, teacher_logits.detach(),
                                         torch.cat([w, w]), center, float(teacher_temp),
                                         float(student_temp), denom, model_group)
    b = valid.shape[0]
    s = (student_logits / student_temp).float()
    s1, s2 = s[:b], s[b:]
    t = torch.softmax((teacher_logits.detach().float() - center) / teacher_temp, dim=-1)
    t1, t2 = t[:b], t[b:]

    def term(q, v):
        ce = (-q * torch.log_softmax(v, dim=-1)).sum(-1)  # (B, T)
        return (ce * w).sum() / denom

    # teacher view i distills into student view j != i (Dino_loss.py:94-102)
    return (term(t1, s2) + term(t2, s1)) / 2.0


class _ShardedCrossViewCE(torch.autograd.Function):
    """:func:`dino_char_loss` over column shards of the logits.

    Rows are view-stacked (view 1's then view 2's char slots); teacher row
    ``r`` pairs with the student row of the other view. With ``s`` the
    student logits over ``student_temp`` and ``t`` the centred teacher
    logits over ``teacher_temp``, a row's CE is ``lse(s) - sum(p_t s)``,
    ``p_t = softmax(t)``. Forward: one all-reduce of the rows' maxima of
    ``s`` and ``t`` (MAX), then one of their exp-sums and of ``sum(exp(t -
    max_t) s)`` (SUM), over the model group. Backward: on the rank's own
    columns, ``ds = g w (softmax(s) - p_t) / (2 denom student_temp)`` from
    the saved global statistics; no collective (autograd never sees the
    max)."""

    @staticmethod
    def forward(ctx, student_logits, teacher_logits, w2, center, teacher_temp, student_temp,
                denom, group):
        s, t = _sharded_ce_inputs(student_logits, teacher_logits, center, teacher_temp,
                                  student_temp)
        maxes = torch.stack([s.amax(-1), t.amax(-1)], dim=1)              # (rows, 2)
        all_reduce_max(maxes, group, "dino_ce_max")
        et = torch.exp(t - maxes[:, 1:])
        sums = torch.stack([torch.exp(s - maxes[:, :1]).sum(-1), et.sum(-1),
                            (et * s).sum(-1)], dim=1)                     # (rows, 3)
        all_reduce_sum(sums, group, "dino_ce_sums")
        ce = maxes[:, 0] + torch.log(sums[:, 0]) - sums[:, 2] / sums[:, 1]
        ctx.save_for_backward(student_logits, teacher_logits, center, w2, maxes, sums, denom)
        ctx.temps = teacher_temp, student_temp
        # sum over both row halves = term(t1->s2) + term(t2->s1)
        return (ce * w2).sum() / denom / 2.0

    @staticmethod
    def backward(ctx, g):
        student_logits, teacher_logits, center, w2, maxes, sums, denom = ctx.saved_tensors
        teacher_temp, student_temp = ctx.temps
        s, t = _sharded_ce_inputs(student_logits, teacher_logits, center, teacher_temp,
                                  student_temp)
        p_s = torch.exp(s - maxes[:, :1]) / sums[:, :1]
        p_t = torch.exp(t - maxes[:, 1:]) / sums[:, 1:2]
        ds = (p_s - p_t) * (g * w2 / (denom * 2.0 * student_temp))[:, None]
        n = ds.shape[0] // 2
        ds = torch.cat([ds[n:], ds[:n]])  # back to the student's own rows
        return (ds.to(student_logits.dtype).reshape(student_logits.shape),
                None, None, None, None, None, None, None)


def _sharded_ce_inputs(student_logits, teacher_logits, center, teacher_temp, student_temp):
    """(s, t) of :class:`_ShardedCrossViewCE` as (rows, K) fp32, ``s``'s rows
    swapped to the other view's, as the plain chain rounds them."""
    k = student_logits.shape[-1]
    s = (student_logits / student_temp).float().reshape(-1, k)
    n = s.shape[0] // 2
    s = torch.cat([s[n:], s[:n]])
    t = ((teacher_logits.float() - center) / teacher_temp).reshape(-1, k)
    return s, t


def dino_char_loss_fused(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                         valid: torch.Tensor, center: torch.Tensor, teacher_temp: float,
                         student_temp: float = 0.1, group: Group = None) -> torch.Tensor:
    """:func:`dino_char_loss` via the fused CE kernel: one pass over the
    (rows, K) logits instead of several fp32 intermediates.

    Logits are the flat ``(2B*T, K)`` view-stacked rows that
    ``pool_project(flat=True)`` emits, or ``(2B, T, K)``. The cross-view
    pairing — teacher view i distills into student view j != i
    (Dino_loss.py:94-102) — happens inside the kernel by addressing
    (``swap_halves``), so the logits are never sliced or concatenated here.
    Under ``group`` each rank's rows are [view 1; view 2] of its own samples,
    so the pairing stays on the rank, as the JAX package's ``shard_map``
    branch keeps it on the device; what is global is the denominator.
    """
    k = student_logits.shape[-1]
    ce = fused_dino_row_ce(student_logits.reshape(-1, k),
                           teacher_logits.detach().reshape(-1, k),
                           center.reshape(1, k), teacher_temp, float(student_temp),
                           swap_halves=True)
    w = valid.float().reshape(-1)
    w2 = torch.cat([w, w])  # (2B*T,) — slot validity, shared per view
    denom = _global_count(w, group, "dino_denominator")
    # sum over both row halves = term(t1->s2) + term(t2->s1)
    return (ce * w2).sum() / denom / 2.0


def dino_center_update(center: torch.Tensor, teacher_logits: torch.Tensor,
                       valid: torch.Tensor, momentum: float = 0.9,
                       group: Group = None) -> torch.Tensor:
    """EMA update of the teacher center over valid char slots of both views.

    teacher_logits: (2B, T, K), or (2B*T, K) view-stacked rows from
    ``pool_project(flat=True)``; valid: (B, T) — applied to both halves,
    like the reference's concat of the two masked views
    (Dino_loss.py:133-143). Returns the new (1, K) center. Under ``group``
    the sum and the count are all-reduced (one buffer) before the division.
    """
    k = teacher_logits.shape[-1]
    w = valid.reshape(-1)
    w2 = torch.cat([w, w]).to(teacher_logits.dtype)  # (2B*T,), exact 0/1 in any type
    # the masked logits are exact in their own type; the sum runs in fp32
    # without a fp32 copy of the logits
    total = (teacher_logits.detach().reshape(-1, k) * w2[:, None]).sum(
        0, keepdim=True, dtype=torch.float32)
    count = w2.float().sum().reshape(1, 1)
    if group is not None:
        both = all_reduce_sum(torch.cat([total, count], dim=1), group, "center")
        total, count = both[:, :k], both[:, k:]
    return center * momentum + (total / count.clamp_min(1.0)) * (1.0 - momentum)


@torch.no_grad()
def sinkhorn_knopp_teacher(teacher_output: torch.Tensor, teacher_temp: float,
                           n_iterations: int = 3) -> torch.Tensor:
    """Sinkhorn-Knopp teacher assignment (Dino_loss.py:157-184,
    ``ccd_tpu/losses/losses.py::sinkhorn_knopp_teacher``): the reference's
    alternative to softmax centering, present but unused in its step and in
    the JAX package's. Single device, so the reference's ``all_reduce`` calls
    are plain sums. fp32.

    teacher_output: (N, K) logits -> (N, K) assignment (rows sum to 1)."""
    q = torch.exp(teacher_output.float() / teacher_temp).t()  # (K, N)
    k, n_total = q.shape
    q = q / q.sum()
    for _ in range(n_iterations):
        q = q / q.sum(dim=1, keepdim=True)
        q = q / k
        q = q / q.sum(dim=0, keepdim=True)
        q = q / n_total
    return (q * n_total).t()


def tf_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int,
            group: Group = None) -> torch.Tensor:
    """Teacher-forcing CE (``ccd_tpu/losses/losses.py::tf_loss``): drop the
    last output and the first target, mean over the non-PAD targets.

    logits: (N, T, C-1); targets: (N, T) with BOS first. A target id outside
    the classifier's range (PAD is one past it) is clipped for the gather and
    masked out by ``ignore_index``. Under ``group`` the count of non-PAD
    targets is the global one."""
    out = logits[:, :-1].float()
    tgt = targets[:, 1:]
    mask = (tgt != ignore_index).float()
    logp = torch.log_softmax(out, dim=-1)
    safe = tgt.clamp(0, out.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / _global_count(mask, group, "tf_denominator")
