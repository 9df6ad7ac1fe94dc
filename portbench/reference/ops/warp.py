"""Affine and projective grid generation and bilinear grid sampling.

Used to warp glyph-cluster maps from the view-1 frame into the view-2 frame
with the inverse-affine theta recorded by the augmentation pipeline, matching
``F.affine_grid``/``F.grid_sample`` as called in
``Dino/model/dino_vision.py:72-77`` and ``train.py:234-236`` (bilinear, zero
padding, align_corners=False).

Counterpart of ``ccd_tpu/ops/warp.py``. Tensors are channel-last: input
(B, H, W, C), grid (B, Ho, Wo, 2) with xy in [-1, 1]. The sampler is a 4-tap
gather whose weights are the hat kernel ``max(0, 1 - |src - pixel|)`` per axis,
blended along x first and then along y: term for term the arithmetic of the
JAX package's dense (two-contraction) sampler, so thresholded warps of binary
maps agree with it bit for bit. The coordinate mapping is stated here and does
not depend on the installed ``F.grid_sample``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def affine_grid(theta: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Generate a (B, H, W, 2) sampling grid from (B, 2, 3) affine matrices
    ((B, H, W, k) from (B, k, 3)).

    align_corners=False convention: base coords are pixel centers
    ``(2i+1)/S - 1``.
    """
    h, w = size_hw
    xs = (2.0 * torch.arange(w, dtype=theta.dtype, device=theta.device) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, dtype=theta.dtype, device=theta.device) + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    # grid[b, i, j, :] = theta[b] @ [x, y, 1], written out so that a fp32
    # theta stays fp32 on any device
    t = theta[:, None, None]  # (B, 1, 1, 2, 3)
    return t[..., 0] * gx[None, ..., None] + t[..., 1] * gy[None, ..., None] + t[..., 2]


def homography_grid(h33: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, 3, 3) projective matrices (normalised coordinates) -> (B, H, W, 2)
    grid: :func:`affine_grid` with the perspective divide, for the
    CVRandomPerspective-style warps (``Dino/dataset/transforms.py:198-232``).
    Products and sums are written out in fp32 (no TF32 on the card); the
    divide keeps the sign of z and bounds its magnitude below by 1e-6."""
    mapped = affine_grid(h33, size_hw)  # the same products, over all three rows: (B, H, W, 3)
    z = mapped[..., 2:3]
    return mapped[..., :2] / z.abs().clamp_min(1e-6) * torch.sign(z)


def _taps(grid: torch.Tensor, h: int, w: int):
    """The four bilinear taps of every grid point: flat source index (clamped
    into the image), x weight, y weight — weights are zero outside the image."""
    gx = (grid[..., 0] + 1.0) * w / 2.0 - 0.5  # (B, Ho, Wo)
    gy = (grid[..., 1] + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    taps = []
    for yi in (y0, y0 + 1):
        ky = (1.0 - (gy - yi).abs()).clamp_min(0.0) * ((yi >= 0) & (yi <= h - 1))
        row = []
        for xi in (x0, x0 + 1):
            kx = (1.0 - (gx - xi).abs()).clamp_min(0.0) * ((xi >= 0) & (xi <= w - 1))
            idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            row.append((idx, kx))
        taps.append((ky, row))
    return taps


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``x`` (B, H, W, C) at ``grid`` (B, Ho, Wo, 2).

    Zero padding for out-of-bounds, align_corners=False:
    ``src = (g + 1) * S / 2 - 0.5``. Weights in at least fp32.
    """
    b, h, w, c = x.shape
    ho, wo = grid.shape[1:3]
    dt = torch.promote_types(x.dtype, torch.float32)
    flat = x.reshape(b, h * w, c).to(dt)
    out = 0.0
    for ky, row in _taps(grid.to(dt), h, w):
        along_x = 0.0
        for idx, kx in row:
            vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
            along_x = along_x + vals.reshape(b, ho, wo, c) * kx[..., None]
        out = out + along_x * ky[..., None]
    return out.to(x.dtype)


def grid_sample_binary_packed(bits: torch.Tensor, grid: torch.Tensor, n_bits: int,
                              thresh: float = 0.1) -> torch.Tensor:
    """Warp up to 31 BINARY channels packed into an int32 (B, H, W) bitfield.

    Equal to :func:`grid_sample` over the unpacked one-hot channels followed
    by ``> thresh`` (with binary inputs the bilinear output is just the
    weighted corner-bit sum), but each of the 4 bilinear taps gathers ONE
    int32 per output pixel instead of ``n_bits`` floats. Returns
    (B, Ho, Wo, n_bits) float32 {0, 1}.
    """
    b, h, w = bits.shape
    ho, wo = grid.shape[1:3]
    flat = bits.reshape(b, h * w)
    shifts = torch.arange(n_bits, dtype=bits.dtype, device=bits.device)
    out = 0.0
    for ky, row in _taps(grid.float(), h, w):
        along_x = 0.0
        for idx, kx in row:
            packed = torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, ho, wo)
            unpacked = ((packed[..., None] >> shifts) & 1).float()
            along_x = along_x + unpacked * kx[..., None]
        out = out + along_x * ky[..., None]
    return (out > thresh).float()
