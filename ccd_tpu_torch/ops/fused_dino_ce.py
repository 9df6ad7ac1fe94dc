"""Fused DINO distillation cross-entropy, one row per character slot:
``-softmax((t - c)/tt) . log_softmax(s/st)`` over K prototype logits.

Counterpart of ``ccd_tpu/ops/fused_dino_ce.py::fused_dino_row_ce`` (the Pallas
kernels ``_fwd_kernel`` and ``_bwd_kernel`` under one custom VJP). The plain
chain writes several (rows, K) fp32 intermediates to device memory (teacher
softmax, student log-softmax, their product); the kernels in
``csrc/fused_dino_ce.cu`` read each logit once per direction, keep five fp32
statistics per row, and the backward writes only the student gradient: the
teacher, the centre and the temperatures get none, matching the reference's
detached teacher (``Dino_loss.py:90``).

On a CUDA tensor the wrapper launches the kernels (built with ``nvcc`` at
first use, bound with ``ctypes``) or raises; there is no fallback. On a CPU
tensor it computes :func:`fused_dino_row_ce_plain`. Rows and K need no
particular size (``swap_halves`` needs an even number of rows).

Bound on an H100 at the pretraining shape (rows, K) = (3328, 65536) in bf16,
bytes in both directions: the forward must read 872.4 MB, 0.260 ms at
3.35 TB/s; the backward reads them again and writes 436.2 MB, 0.391 ms.
"""

from __future__ import annotations

import torch

_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor, swap_halves: bool) -> None:
    if s.ndim != 2 or t.shape != s.shape:
        raise ValueError(f"s and t must be (R, K) alike, got {tuple(s.shape)} and "
                         f"{tuple(t.shape)}")
    if c.numel() != s.shape[1]:
        raise ValueError(f"c must hold K = {s.shape[1]} values, got {tuple(c.shape)}")
    if s.dtype not in _SUPPORTED_DTYPES or t.dtype != s.dtype:
        raise TypeError(f"s and t must both be float32 or bfloat16, got {s.dtype} and {t.dtype}")
    if t.device != s.device or c.device != s.device:
        raise ValueError(f"s on {s.device}, t on {t.device}, c on {c.device}")
    if swap_halves and s.shape[0] % 2 != 0:
        raise ValueError(f"swap_halves needs an even number of rows, got {s.shape[0]}")


def fused_dino_row_ce_plain(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                            teacher_temp: float = 0.04, student_temp: float = 0.1,
                            swap_halves: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernels, any device: (R, K) x2 -> (R,)
    fp32. Differentiable with respect to ``s`` only."""
    _check(s, t, c, swap_halves)
    t = t.detach()
    if swap_halves:
        t = torch.roll(t, -(t.shape[0] // 2), dims=0)  # row r reads teacher row r + R/2
    q = torch.softmax((t.float() - c.detach().float().reshape(1, -1)) / teacher_temp, dim=-1)
    return -(q * torch.log_softmax(s.float() / student_temp, dim=-1)).sum(-1)


def _call(entry: str, tensors, s: torch.Tensor, swap_halves: bool, teacher_temp: float,
          student_temp: float) -> None:
    """Launch C entry point ``entry`` of ``csrc/fused_dino_ce.cu`` on the
    current stream: the pointers of ``tensors``, then R, K, the teacher's row
    shift, is_bf16, the two temperatures, the stream."""
    import ctypes

    from ccd_tpu_torch.ops._build import load_library

    fn = getattr(load_library("fused_dino_ce"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    r, k = s.shape
    with torch.cuda.device(s.device):
        err = fn(*[x.data_ptr() for x in tensors], r, k, r // 2 if swap_halves else 0,
                 int(s.dtype == torch.bfloat16), float(teacher_temp), float(student_temp),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed at launch: CUDA error {err} "
                           f"(s {tuple(s.shape)} {s.dtype})")


class _FusedDinoRowCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, c, teacher_temp, student_temp, swap_halves):
        s, t = s.contiguous(), t.contiguous()
        c = c.detach().float().reshape(-1).contiguous()
        ce = torch.empty(s.shape[0], dtype=torch.float32, device=s.device)
        stats = torch.empty((5, s.shape[0]), dtype=torch.float32, device=s.device)
        _call("fused_dino_ce_forward", (s, t, c, ce, stats), s, swap_halves, teacher_temp,
              student_temp)
        fused_dino_row_ce.launches += 1
        ctx.save_for_backward(s, t, c, stats)
        ctx.args = (swap_halves, teacher_temp, student_temp)
        return ce

    @staticmethod
    def backward(ctx, g):
        s, t, c, stats = ctx.saved_tensors
        g = g.float().contiguous()
        ds = torch.empty_like(s)
        _call("fused_dino_ce_backward", (s, t, c, g, stats, ds), s, *ctx.args)
        fused_dino_row_ce.bwd_launches += 1
        return ds, None, None, None, None, None


def fused_dino_row_ce(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                      teacher_temp: float = 0.04, student_temp: float = 0.1,
                      swap_halves: bool = False) -> torch.Tensor:
    """Per-row CE: ``-softmax((t-c)/tt) . log_softmax(s/st)``.

    s, t: (R, K) logits, both float32 or both bfloat16; c: (1, K) or (K,)
    centre. Returns (R,) fp32. Only ``s`` is differentiated.

    ``swap_halves``: pair student row i with teacher row (i + R/2) mod R — the
    DINO cross-view pairing over view-stacked logits, done by the kernel's
    addressing so that callers never slice or permute the (R, K) arrays.

    ``fused_dino_row_ce.launches`` and ``.bwd_launches`` count launches of the
    forward and of the backward kernel (and nothing else)."""
    _check(s, t, c, swap_halves)
    if s.device.type == "cpu":
        return fused_dino_row_ce_plain(s, t, c, teacher_temp, student_temp, swap_halves)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    return _FusedDinoRowCE.apply(s, t.detach(), c, float(teacher_temp), float(student_temp),
                                 bool(swap_halves))


fused_dino_row_ce.launches = 0
fused_dino_row_ce.bwd_launches = 0
