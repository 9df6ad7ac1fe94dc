"""Cosine-with-linear-warmup schedules.

Parity targets: ``cosine_scheduler`` / ``cosine_iter_scheduler`` in
``Dino/modules/utils.py:187-210``; counterpart of ``ccd_tpu/schedules.py``.
Besides the precomputed-array form there is the closed form of one iteration,
computed on the host in float32 arithmetic (as the JAX step computes it on the
device), so a train step reads no schedule value back from the device.
"""

from __future__ import annotations

import numpy as np


def cosine_iter_schedule_array(base_value: float, final_value: float, niter: int,
                               warmup_iters: int = 0, start_warmup_value: float = 0.0) -> np.ndarray:
    """Precomputed per-iteration schedule (host-side, numpy)."""
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters) if warmup_iters > 0 \
        else np.array([])
    iters = np.arange(niter - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters)))
    schedule = np.concatenate((warmup, schedule))
    assert len(schedule) == niter
    return schedule


def cosine_epoch_schedule_array(base_value: float, final_value: float, epochs: int,
                                niter_per_ep: int, warmup_epochs: int = 0,
                                start_warmup_value: float = 0.0) -> np.ndarray:
    """Epoch-granular variant used by the finetune entry point."""
    return cosine_iter_schedule_array(
        base_value, final_value, epochs * niter_per_ep,
        warmup_iters=int(warmup_epochs * niter_per_ep),
        start_warmup_value=start_warmup_value)


def cosine_iter_schedule(iteration: int, base_value: float, final_value: float, niter: int,
                         warmup_iters: int = 0, start_warmup_value: float = 0.0) -> float:
    """Closed-form schedule value at ``iteration`` (a Python int).

    Matches :func:`cosine_iter_schedule_array` indexed at ``iteration`` up to
    float32 rounding: every operation is rounded to float32, in the order the
    JAX package applies them.
    """
    f32 = np.float32
    it = f32(iteration)
    warmup_iters = int(warmup_iters)
    if it < warmup_iters:
        # np.linspace(start, base, n)[i] = start + i * (base-start)/(n-1)
        denom = max(warmup_iters - 1, 1)
        return float(f32(start_warmup_value)
                     + it * f32((base_value - start_warmup_value) / denom))
    n_cos = niter - warmup_iters
    cos_i = np.clip(it - f32(warmup_iters), f32(0), f32(n_cos - 1))
    phase = f32(np.pi) * cos_i / f32(n_cos)
    return float(f32(final_value) + f32(0.5 * (base_value - final_value))
                 * (f32(1) + np.cos(phase, dtype=f32)))
