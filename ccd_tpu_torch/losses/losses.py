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
    cross-entropy kernel (:mod:`ccd_tpu_torch.ops.fused_dino_ce`).
  * :func:`tf_loss` — the finetune path's teacher-forced CE
    (``train_finetune.py:276-282``).
"""

from __future__ import annotations

import numpy as np
import torch

from ccd_tpu_torch.ops.fused_dino_ce import fused_dino_row_ce


def seg_loss(seg_logits: torch.Tensor, gt_masks: torch.Tensor) -> torch.Tensor:
    """Per-pixel 2-class CE of softmaxed mask logits vs {0,1} GT.

    seg_logits: (N, H, W, 2); gt_masks: (N, H, W) in {0, 1}.
    """
    probs = torch.softmax(seg_logits.float(), dim=-1)
    logp = torch.log_softmax(probs, dim=-1)  # reference's double softmax
    y = gt_masks.float()
    nll = -(logp[..., 0] * (1.0 - y) + logp[..., 1] * y)
    return nll.mean()


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
                   student_temp: float = 0.1) -> torch.Tensor:
    """Cross-view character-distillation CE (the plain chain).

    student_logits/teacher_logits: (2B, T, K) — view-1 then view-2 halves.
    valid: (B, T) bool char-slot mask (shared across views, dino_vision.py:87).
    center: (1, K) teacher centering state.
    """
    b = valid.shape[0]
    s = (student_logits / student_temp).float()
    s1, s2 = s[:b], s[b:]
    t = torch.softmax((teacher_logits.detach().float() - center) / teacher_temp, dim=-1)
    t1, t2 = t[:b], t[b:]

    w = valid.float()
    denom = w.sum().clamp_min(1.0)

    def term(q, v):
        ce = (-q * torch.log_softmax(v, dim=-1)).sum(-1)  # (B, T)
        return (ce * w).sum() / denom

    # teacher view i distills into student view j != i (Dino_loss.py:94-102)
    return (term(t1, s2) + term(t2, s1)) / 2.0


def dino_char_loss_fused(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                         valid: torch.Tensor, center: torch.Tensor, teacher_temp: float,
                         student_temp: float = 0.1) -> torch.Tensor:
    """:func:`dino_char_loss` via the fused CE kernel: one pass over the
    (rows, K) logits instead of several fp32 intermediates.

    Logits are the flat ``(2B*T, K)`` view-stacked rows that
    ``pool_project(flat=True)`` emits, or ``(2B, T, K)``. The cross-view
    pairing — teacher view i distills into student view j != i
    (Dino_loss.py:94-102) — happens inside the kernel by addressing
    (``swap_halves``), so the logits are never sliced or concatenated here.
    """
    k = student_logits.shape[-1]
    ce = fused_dino_row_ce(student_logits.reshape(-1, k),
                           teacher_logits.detach().reshape(-1, k),
                           center.reshape(1, k), teacher_temp, float(student_temp),
                           swap_halves=True)
    w = valid.float().reshape(-1)
    w2 = torch.cat([w, w])  # (2B*T,) — slot validity, shared per view
    denom = w.sum().clamp_min(1.0)
    # sum over both row halves = term(t1->s2) + term(t2->s1)
    return (ce * w2).sum() / denom / 2.0


def dino_center_update(center: torch.Tensor, teacher_logits: torch.Tensor,
                       valid: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
    """EMA update of the teacher center over valid char slots of both views.

    teacher_logits: (2B, T, K), or (2B*T, K) view-stacked rows from
    ``pool_project(flat=True)``; valid: (B, T) — applied to both halves,
    like the reference's concat of the two masked views
    (Dino_loss.py:133-143). Returns the new (1, K) center.
    """
    k = teacher_logits.shape[-1]
    w = valid.reshape(-1)
    w2 = torch.cat([w, w]).to(teacher_logits.dtype)  # (2B*T,), exact 0/1 in any type
    # the masked logits are exact in their own type; the sum runs in fp32
    # without a fp32 copy of the logits
    total = (teacher_logits.detach().reshape(-1, k) * w2[:, None]).sum(
        0, keepdim=True, dtype=torch.float32)
    count = w2.float().sum().clamp_min(1.0)
    return center * momentum + (total / count) * (1.0 - momentum)


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


def tf_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Teacher-forcing CE (``ccd_tpu/losses/losses.py::tf_loss``): drop the
    last output and the first target, mean over the non-PAD targets.

    logits: (N, T, C-1); targets: (N, T) with BOS first. A target id outside
    the classifier's range (PAD is one past it) is clipped for the gather and
    masked out by ``ignore_index``."""
    out = logits[:, :-1].float()
    tgt = targets[:, 1:]
    mask = (tgt != ignore_index).float()
    logp = torch.log_softmax(out, dim=-1)
    safe = tgt.clamp(0, out.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
