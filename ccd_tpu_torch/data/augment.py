"""Batched, on-device pretraining augmentation: the severity-5 photometric
chain and the random affine view with its recorded theta.

Counterpart of ``ccd_tpu/data/augment.py`` for the pretraining path
(``pretrain_views`` and what it calls). The whole batch is augmented on the
device in one call with draws from a key object
(``ccd_tpu_torch/data/random.py``); theta is the normalised inverse affine
that maps view-2 grid coordinates back to the source frame, the matrix the
step later feeds to ``affine_grid``/``grid_sample`` to warp the glyph
clusters (``dino_vision.py:72-77``).

* ``photometric_augment`` = severity-5 chain,
  ``augmentation_pipelines.py:122-208``: Sometimes(0.2, Identity,
  Sequential[arithmetic(OneOf-21), Sometimes(.7) colour(OneOf-9),
  Sometimes(.7) blur, Sometimes(.7) contrast(OneOf-8),
  Sometimes(.7) weather(OneOf-4)]).

Severities 1-4 and 6, ``supervised_augment``, ``abinet_augment`` and the crop,
elastic and perspective ops belong to the finetune slice and are not here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ccd_tpu_torch.data import aug_ops as A
from ccd_tpu_torch.ops.warp import affine_grid, grid_sample
from ccd_tpu_torch.utils.device import device_constant

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _imagenet_stats():
    return IMAGENET_MEAN, IMAGENET_STD


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) float [0,1] -> ImageNet-normalised."""
    mean, std = device_constant(_imagenet_stats, images.device)
    return (images - mean) / std


def denormalize(images: torch.Tensor) -> torch.Tensor:
    mean, std = device_constant(_imagenet_stats, images.device)
    return images * std + mean


def _gate(key, b, p):
    return key.bernoulli(p, (b, 1, 1, 1)).to(torch.float32)


def _blend(x, y, gate):
    return x * (1.0 - gate) + y * gate


def photometric_augment(key, images: torch.Tensor, severity: int = 5) -> torch.Tensor:
    """``get_augmentation_pipeline(5)`` on (B, H, W, 3) float [0,1] images::

        Sometimes(0.2, Identity, Sequential[
            OneOf(21 arithmetic ops),            # always applied
            Sometimes(0.7, OneOf(9 colour ops)),
            Sometimes(0.7, OneOf[Sharpen, OneOf(5 blurs)]),
            Sometimes(0.7, OneOf(8 contrast ops)),
            Sometimes(0.7, OneOf(4 weather ops)),
        ])
    """
    if severity != 5:
        raise NotImplementedError(
            f"augmentation_severity={severity}: only severity 5 (the pretraining chain) is "
            "ported; severities 1-4 and 6 come with the finetune slice")
    b = images.shape[0]
    keys = key.split(6)
    x = images
    x = A.one_of(keys[0], x, A.ARITHMETIC_OPS)
    x = A.sometimes(keys[1], x, 0.7, lambda k, y: A.one_of(k, y, A.COLOR_OPS))
    x = A.sometimes(keys[2], x, 0.7, A.blur_family)
    x = A.sometimes(keys[3], x, 0.7, lambda k, y: A.one_of(k, y, A.CONTRAST_OPS))
    x = A.sometimes(keys[4], x, 0.7, lambda k, y: A.one_of(k, y, A.WEATHER_OPS))
    # iaa.Sometimes(0.2, Identity, <chain>): 20% keep the original
    keep = _gate(keys[5], b, 0.2)
    return _blend(x, images, keep)


def _normalize_matrix(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel -> [-1,1] grid-coordinate change of basis (the reference's W_,
    datasetsupervised_kmeans.py:70)."""
    w_ = np.array([[2.0 / (w - 1), 0, -1], [0, 2.0 / (h - 1), -1], [0, 0, 1]], np.float32)
    return w_, np.linalg.inv(w_).astype(np.float32)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as fp32 products and sums (no TF32 path)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, 3, 3) matrices by cofactors, elementwise fp32."""
    c = [[m[:, (i + 1) % 3, (j + 1) % 3] * m[:, (i + 2) % 3, (j + 2) % 3]
          - m[:, (i + 1) % 3, (j + 2) % 3] * m[:, (i + 2) % 3, (j + 1) % 3]
          for j in range(3)] for i in range(3)]
    det = m[:, 0, 0] * c[0][0] + m[:, 0, 1] * c[0][1] + m[:, 0, 2] * c[0][2]
    adj = torch.stack([torch.stack([c[j][i] for j in range(3)], -1) for i in range(3)], -2)
    return adj / det[:, None, None]


def random_affine_with_theta(key, images: torch.Tensor, apply_prob: float = 0.7
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random affine warp with its recorded normalised inverse matrix theta.

    Parameter ranges follow ``iaa.Affine`` in the reference pretrain dataset
    (scale .6-1.1, translate ±2%, rotate ±10°, shear x ±45° y ±10°, p=0.7).
    Returns (warped (B,H,W,3), theta (B,3,3))."""
    b, h, w, _ = images.shape
    k = key.split(7)
    sx = k[0].uniform((b,), 0.6, 1.1)
    sy = k[1].uniform((b,), 0.6, 1.1)
    tx = k[2].uniform((b,), -0.02, 0.02) * w
    ty = k[3].uniform((b,), -0.02, 0.02) * h
    rot = torch.deg2rad(k[4].uniform((b,), -10.0, 10.0))
    shx = torch.tan(torch.deg2rad(k[5].uniform((b,), -45.0, 45.0)))
    shy = torch.tan(torch.deg2rad(k[6].uniform((b,), -10.0, 10.0)))

    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    center = mat([[ones, zeros, ones * cx], [zeros, ones, ones * cy], [zeros, zeros, ones]])
    center_inv = mat([[ones, zeros, -ones * cx], [zeros, ones, -ones * cy],
                      [zeros, zeros, ones]])
    scale = mat([[sx, zeros, zeros], [zeros, sy, zeros], [zeros, zeros, ones]])
    shear = mat([[ones, shx, zeros], [shy, ones, zeros], [zeros, zeros, ones]])
    rotm = mat([[torch.cos(rot), -torch.sin(rot), zeros],
                [torch.sin(rot), torch.cos(rot), zeros], [zeros, zeros, ones]])
    trans = mat([[ones, zeros, tx], [zeros, ones, ty], [zeros, zeros, ones]])

    # forward pixel-space map, centred: M = T · C · R · Sh · S · C⁻¹
    m = trans
    for factor in (center, rotm, shear, scale, center_inv):
        m = _matmul3(m, factor)
    w_, w_inv = device_constant(_normalize_matrix, images.device, h, w)
    theta = _matmul3(_matmul3(w_.expand(b, 3, 3), _inv3(m)), w_inv.expand(b, 3, 3))

    apply = key.fold_in(999).bernoulli(apply_prob, (b,))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device).expand(b, 3, 3)
    theta = torch.where(apply[:, None, None], theta, eye)

    warped = grid_sample(images, affine_grid(theta[:, :2, :], (h, w)))
    return warped, theta


def pretrain_views(key, images: torch.Tensor, severity: int = 5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the 3-view pretraining batch on the device.

    images: (B, H, W, 3) float [0,1] resized raw images. Returns (views
    (B, 3, H, W, 3) ImageNet-normalised, theta (B, 3, 3)): view0 = raw,
    view1 = photometric, view2 = photometric + affine(theta)
    (``_process_training``, datasetsupervised_kmeans.py:48-87)."""
    k1, k2, k3 = key.split(3)
    v1 = photometric_augment(k1, images, severity)
    v2p = photometric_augment(k2, images, severity)
    v2, theta = random_affine_with_theta(k3, v2p)
    views = torch.stack([normalize(images), normalize(v1), normalize(v2)], dim=1)
    return views, theta
