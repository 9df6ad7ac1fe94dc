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

The forward walks a row per block with online statistics. The backward is a
streaming pass: blocks of 4 consecutive rows by a 4 KB slice of K, the slices
fastest, so the card sweeps s, t and ds in order; each row's constants are
folded once in base 2 (``p = 2^(x a - b)``, see
:func:`fused_dino_ce_backward_plain`) and the centre is read once a block.

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
LOG2E = 1.4426950408889634


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
    t = _paired_teacher(t.detach(), swap_halves)
    q = torch.softmax((t.float() - c.detach().float().reshape(1, -1)) / teacher_temp, dim=-1)
    return -(q * torch.log_softmax(s.float() / student_temp, dim=-1)).sum(-1)


def _paired_teacher(t: torch.Tensor, swap_halves: bool) -> torch.Tensor:
    """The teacher rows as the kernels read them: row r of the result is
    teacher row r, or (r + R/2) mod R with ``swap_halves``."""
    return torch.roll(t, -(t.shape[0] // 2), dims=0) if swap_halves else t


def fused_dino_ce_stats_plain(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                              teacher_temp: float = 0.04, student_temp: float = 0.1,
                              swap_halves: bool = False) -> torch.Tensor:
    """The statistics the forward kernel saves, (5, R) fp32, in the JAX
    kernel's layout and natural units (``_run_fwd(...)[1]``): per row, with
    s' = s / st and t' = (t[r'] - c) / tt, max s', sum exp(s' - max s'),
    max t', sum exp(t' - max t') and sum exp(t' - max t') * s'."""
    _check(s, t, c, swap_halves)
    sp = s.detach().float() / student_temp
    tp = (_paired_teacher(t.detach(), swap_halves).float()
          - c.detach().float().reshape(1, -1)) / teacher_temp
    m_s, m_t = sp.amax(-1), tp.amax(-1)
    p = torch.exp(tp - m_t[:, None])
    return torch.stack([m_s, torch.exp(sp - m_s[:, None]).sum(-1), m_t, p.sum(-1),
                        (p * sp).sum(-1)])


def fused_dino_ce_backward_plain(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                                 g: torch.Tensor, stats: torch.Tensor,
                                 teacher_temp: float = 0.04, student_temp: float = 0.1,
                                 swap_halves: bool = False) -> torch.Tensor:
    """Plain version of the backward kernel, any device: ds (R, K) in the
    type of ``s`` from the cotangent ``g`` (R,) and the saved ``stats``, in
    the kernel's base-2 algebra. Per row, a_s = log2(e)/st and b_s = max s'
    * log2(e) + log2(sum_s), likewise a_t and b_t; then

        ds = g / st * (2^(s a_s - b_s) - 2^(t[r'] a_t - c a_t - b_t)),

    which is g / st * (softmax(s') - softmax(t'))."""
    _check(s, t, c, swap_halves)
    a_s, a_t = LOG2E / student_temp, LOG2E / teacher_temp
    stats = stats.float()
    b_s = stats[0] * LOG2E + torch.log2(stats[1])
    b_t = stats[2] * LOG2E + torch.log2(stats[3])
    c_scaled = c.detach().float().reshape(1, -1) * a_t
    p_s = torch.exp2(s.detach().float() * a_s - b_s[:, None])
    p_t = torch.exp2(_paired_teacher(t.detach(), swap_halves).float() * a_t - c_scaled
                     - b_t[:, None])
    return ((g.float() / student_temp)[:, None] * (p_s - p_t)).to(s.dtype)


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


def _on_card(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor, swap_halves: bool):
    _check(s, t, c, swap_halves)
    if s.device.type != "cuda":
        raise ValueError(f"the fused CE kernels run on a CUDA device, got {s.device}")
    return s.detach().contiguous(), t.detach().contiguous(), \
        c.detach().float().reshape(-1).contiguous()


def fused_dino_ce_forward(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                          teacher_temp: float = 0.04, student_temp: float = 0.1,
                          swap_halves: bool = False):
    """The forward kernel alone on CUDA tensors: (ce (R,), stats (5, R)),
    both fp32, stats as :func:`fused_dino_ce_stats_plain` gives them. Adds
    one to ``fused_dino_row_ce.launches``."""
    s, t, c = _on_card(s, t, c, swap_halves)
    ce = torch.empty(s.shape[0], dtype=torch.float32, device=s.device)
    stats = torch.empty((5, s.shape[0]), dtype=torch.float32, device=s.device)
    _call("fused_dino_ce_forward", (s, t, c, ce, stats), s, swap_halves, teacher_temp,
          student_temp)
    fused_dino_row_ce.launches += 1
    return ce, stats


def fused_dino_ce_backward(s: torch.Tensor, t: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
                           stats: torch.Tensor, teacher_temp: float = 0.04,
                           student_temp: float = 0.1, swap_halves: bool = False) -> torch.Tensor:
    """The backward kernel alone on CUDA tensors: ds (R, K) in the type of
    ``s``, as :func:`fused_dino_ce_backward_plain` computes it. Adds one to
    ``fused_dino_row_ce.bwd_launches``."""
    s, t, c = _on_card(s, t, c, swap_halves)
    r = s.shape[0]
    g = g.detach().float().reshape(-1).contiguous()
    if g.numel() != r or tuple(stats.shape) != (5, r) or stats.dtype != torch.float32 \
            or g.device != s.device or stats.device != s.device:
        raise ValueError(f"g must be ({r},) and stats (5, {r}) fp32 on {s.device}, got "
                         f"{tuple(g.shape)} and {tuple(stats.shape)} {stats.dtype}")
    ds = torch.empty_like(s)
    _call("fused_dino_ce_backward", (s, t, c, g, stats.contiguous(), ds), s, swap_halves,
          teacher_temp, student_temp)
    fused_dino_row_ce.bwd_launches += 1
    return ds


def backward_kernel_attributes(dtype: torch.dtype, vector: bool = True) -> dict:
    """Launch resources of the backward kernel on the current card for
    ``dtype``, on its 16-byte path (``vector``) or its scalar one:
    registers and local (spill) bytes per thread, shared memory per block,
    resident blocks per SM, threads per block."""
    from ccd_tpu_torch.ops._build import kernel_attributes

    if dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f"no backward kernel for {dtype}")
    return kernel_attributes("fused_dino_ce", "fused_dino_ce_backward_attributes",
                             int(dtype == torch.bfloat16), int(vector))


class _FusedDinoRowCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, c, teacher_temp, student_temp, swap_halves):
        ce, stats = fused_dino_ce_forward(s, t, c, teacher_temp, student_temp, swap_halves)
        ctx.save_for_backward(s, t, c, stats)
        ctx.args = (teacher_temp, student_temp, swap_halves)
        return ce

    @staticmethod
    def backward(ctx, g):
        s, t, c, stats = ctx.saved_tensors
        return fused_dino_ce_backward(s, t, c, g, stats, *ctx.args), None, None, None, None, None


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
