"""The bilateral filter of the augmentation (K3) in plain PyTorch: the port's
``bilateral_filter_plain`` under the kernel's name."""

from __future__ import annotations

import torch

MAX_RADIUS = 5


def _check(x: torch.Tensor, sigma_color: torch.Tensor, sigma_space: torch.Tensor,
           rad2: torch.Tensor, max_radius: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b = x.shape[0]
    for name, t in (("sigma_color", sigma_color), ("sigma_space", sigma_space), ("rad2", rad2)):
        if t.numel() != b:
            raise ValueError(f"{name} must hold one value per sample ({b}), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not 0 <= int(max_radius) <= MAX_RADIUS:
        raise ValueError(f"max_radius must be in [0, {MAX_RADIUS}], got {max_radius}")




def _gains(sigma_color: torch.Tensor, sigma_space: torch.Tensor):
    """The exponent's per-sample factors, -1 / (2 sigma²), as (B, 1, 1, 1)."""
    b = sigma_color.numel()
    sc = sigma_color.reshape(b, 1, 1, 1)
    ss = sigma_space.reshape(b, 1, 1, 1)
    return -0.5 / (sc * sc), -0.5 / (ss * ss)




def bilateral_filter_plain(x: torch.Tensor, sigma_color: torch.Tensor,
                           sigma_space: torch.Tensor, rad2: torch.Tensor,
                           max_radius: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, any device: the shifted-tap loop
    of ``ccd_tpu/data/aug_ops.py::bilateral_filter`` (its XLA path). x:
    (B, H, W, C); sigmas, rad2: B values each."""
    _check(x, sigma_color, sigma_space, rad2, max_radius)
    b, h, w, _ = x.shape
    r = int(max_radius)
    gc, gs = _gains(sigma_color, sigma_space)
    rad2 = rad2.reshape(b, 1, 1, 1).to(x.dtype)
    rows = torch.arange(-r, h + r, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=x.device).clamp(0, w - 1)
    xp = x.index_select(1, rows).index_select(2, cols)
    num = torch.zeros_like(x)
    den = torch.zeros((b, h, w, 1), dtype=x.dtype, device=x.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d2 = dy * dy + dx * dx
            if d2 > r * r:
                continue  # cv2's circular window (static bound)
            nb = xp[:, r + dy:r + dy + h, r + dx:r + dx + w]
            cd = torch.sum(torch.abs(nb - x), dim=-1, keepdim=True) * 255.0
            wgt = torch.exp(gc * cd * cd + gs * float(d2))
            if d2 > 0:
                wgt = wgt * (float(d2) <= rad2)
            num = num + wgt * nb
            den = den + wgt
    return num / den




bilateral_filter_fused = bilateral_filter_plain
