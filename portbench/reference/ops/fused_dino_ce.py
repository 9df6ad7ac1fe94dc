"""The DINO cross-view CE per row (K2) in plain PyTorch: the port's
``fused_dino_row_ce_plain`` under the kernel's name."""

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
    t = _paired_teacher(t.detach(), swap_halves)
    q = torch.softmax((t.float() - c.detach().float().reshape(1, -1)) / teacher_temp, dim=-1)
    return -(q * torch.log_softmax(s.float() / student_temp, dim=-1)).sum(-1)




def _paired_teacher(t: torch.Tensor, swap_halves: bool) -> torch.Tensor:
    """The teacher rows as the kernels read them: row r of the result is
    teacher row r, or (r + R/2) mod R with ``swap_halves``."""
    return torch.roll(t, -(t.shape[0] // 2), dims=0) if swap_halves else t




fused_dino_row_ce = fused_dino_row_ce_plain
