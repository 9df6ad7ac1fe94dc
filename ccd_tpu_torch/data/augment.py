"""Batched, on-device augmentation: the severity-5 photometric chain and the
random affine view with its recorded theta (pretraining), and the staged
supervised chain (finetuning).

Counterpart of ``ccd_tpu/data/augment.py`` for the pretraining path
(``pretrain_views`` and what it calls) and the finetune path
(``supervised_augment`` and what it calls). The whole batch is augmented on the
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

* ``supervised_augment`` = the finetune chain, ``dataset_pretrain.py:80-160``:
  Invert, the big OneOf of noise/colour/weather ops with ChannelShuffle, the
  blur family without the bilateral filter, contrast, then one of affine,
  piecewise-affine (an elastic grid) and rotation.

Severities 1-4 and 6, ``abinet_augment`` and the crop, elastic and
perspective ops of the photometric chains are not ported yet (ROADMAP
queue 1, item 3b).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ccd_tpu_torch.data import aug_ops as A
from ccd_tpu_torch.ops.image import jax_image_resize
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


def _per_sample(key, b, lo, hi):
    return key.uniform((b, 1, 1, 1), lo, hi)


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


def _random_affine_matrix(key, b: int, h: int, w: int, scale=(0.6, 1.1), translate=0.02,
                          rotate=10.0, shear_x=45.0, shear_y=10.0) -> torch.Tensor:
    """(B, 3, 3) normalised inverse affine matrices (no image warp): scale,
    translation (a fraction of the image), rotation and shear in degrees,
    drawn per sample, composed about the image centre."""
    k = key.split(7)
    sx = k[0].uniform((b,), scale[0], scale[1])
    sy = k[1].uniform((b,), scale[0], scale[1])
    tx = k[2].uniform((b,), -translate, translate) * w
    ty = k[3].uniform((b,), -translate, translate) * h
    rot = torch.deg2rad(k[4].uniform((b,), -rotate, rotate))
    shx = torch.tan(torch.deg2rad(k[5].uniform((b,), -shear_x, shear_x)))
    shy = torch.tan(torch.deg2rad(k[6].uniform((b,), -shear_y, shear_y)))

    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    center = mat([[ones, zeros, ones * cx], [zeros, ones, ones * cy], [zeros, zeros, ones]])
    center_inv = mat([[ones, zeros, -ones * cx], [zeros, ones, -ones * cy],
                      [zeros, zeros, ones]])
    scl = mat([[sx, zeros, zeros], [zeros, sy, zeros], [zeros, zeros, ones]])
    shr = mat([[ones, shx, zeros], [shy, ones, zeros], [zeros, zeros, ones]])
    rotm = mat([[torch.cos(rot), -torch.sin(rot), zeros],
                [torch.sin(rot), torch.cos(rot), zeros], [zeros, zeros, ones]])
    trn = mat([[ones, zeros, tx], [zeros, ones, ty], [zeros, zeros, ones]])

    # forward pixel-space map, centred: M = T · C · R · Sh · S · C⁻¹
    m = trn
    for factor in (center, rotm, shr, scl, center_inv):
        m = _matmul3(m, factor)
    w_, w_inv = device_constant(_normalize_matrix, sx.device, h, w)
    return _matmul3(_matmul3(w_.expand(b, 3, 3), _inv3(m)), w_inv.expand(b, 3, 3))


def random_affine_with_theta(key, images: torch.Tensor, apply_prob: float = 0.7
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random affine warp with its recorded normalised inverse matrix theta.

    Parameter ranges follow ``iaa.Affine`` in the reference pretrain dataset
    (scale .6-1.1, translate ±2%, rotate ±10°, shear x ±45° y ±10°, p=0.7).
    Returns (warped (B,H,W,3), theta (B,3,3))."""
    b, h, w, _ = images.shape
    theta = _random_affine_matrix(key, b, h, w)
    apply = key.fold_in(999).bernoulli(apply_prob, (b,))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device).expand(b, 3, 3)
    theta = torch.where(apply[:, None, None], theta, eye)

    warped = grid_sample(images, affine_grid(theta[:, :2, :], (h, w)))
    return warped, theta


def _elastic_grid(key, b: int, h: int, w: int, scale: torch.Tensor) -> torch.Tensor:
    """Identity grid plus a smooth random displacement (iaa.PiecewiseAffine-like):
    (B, 4, 8, 2) uniforms in [-1, 1] upsampled by ``jax.image.resize``'s cubic
    kernel to (B, H, W, 2), times ``scale``."""
    xs = (2.0 * torch.arange(w, dtype=torch.float32, device=scale.device) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, dtype=torch.float32, device=scale.device) + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy], -1).expand(b, h, w, 2)
    coarse = key.uniform((b, 4, 8, 2), -1.0, 1.0)
    disp = jax_image_resize(coarse, (b, h, w, 2), "cubic") * scale
    return base + disp


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


def supervised_augment(key, images: torch.Tensor) -> torch.Tensor:
    """The finetune-time staged chain on (B, H, W, 3) float [0, 1] images
    (``dataset_pretrain.py:80-160``, ViT-Small probabilities
    [0.6, 0.8, 0.6, 0.6, 0.6])::

        Sequential[
            Sometimes(0.6, Invert(0.1)),
            Sometimes(0.8, OneOf(35 noise/colour/weather ops)),
            Sometimes(0.6, OneOf[Sharpen, OneOf(4 blurs)]),
            Sometimes(0.6, OneOf(8 contrast ops)),
            Sometimes(0.6, OneOf[Affine, PiecewiseAffine(0.01-0.1),
                                 Rotate(-45, 45)]),
        ]

    The blur family has no bilateral filter here, so the chain runs no
    hand-written kernel. Nothing is read back to the host."""
    b, h, w, _ = images.shape
    keys = key.split(10)
    x = images

    # stage 1: Sometimes(0.6, Invert(0.1)) -> effective p = 0.06
    x = A.sometimes(keys[0], x, 0.6, lambda k, y: A.op_invert(k, y, p=0.1))

    # stage 2 (p=0.8): OneOf over the arithmetic + colour + weather union
    # (Invert is not in this OneOf)
    stage2_ops = ([A.op_channel_shuffle]
                  + [op for op in A.ARITHMETIC_OPS if op is not A.op_invert]
                  + [A.COLOR_OPS[0], A.op_multiply_brightness]
                  + A.COLOR_OPS[1:] + A.WEATHER_OPS)
    x = A.sometimes(keys[1], x, 0.8, lambda k, y: A.one_of(k, y, stage2_ops))

    # stage 3 (p=0.6): OneOf[Sharpen, OneOf(4 blurs)], no BilateralBlur
    x = A.sometimes(keys[2], x, 0.6, lambda k, y: A.blur_family(k, y, kinds=A.BLUR_KINDS))

    # stage 4 (p=0.6): OneOf(8 contrast ops)
    x = A.sometimes(keys[3], x, 0.6, lambda k, y: A.one_of(k, y, A.CONTRAST_OPS))

    # stage 5 (p=0.6): OneOf[Affine (the pretraining view's ranges),
    #                        PiecewiseAffine(scale 0.01-0.1), Rotate(-45, 45)]
    theta_aff = _random_affine_matrix(keys[4], b, h, w)
    theta_rot = _random_affine_matrix(keys[5], b, h, w, scale=(1.0, 1.0), translate=0.0,
                                      rotate=45.0, shear_x=0.0, shear_y=0.0)
    which = keys[6].randint((b,), 0, 3)
    theta = torch.where((which == 0)[:, None, None], theta_aff, theta_rot)
    grid_aff = affine_grid(theta[:, :2, :], (h, w))
    pw_scale = _per_sample(keys[7], b, 0.01, 0.1) * 2.0  # fraction of the [-1, 1] span
    grid_el = _elastic_grid(keys[8], b, h, w, pw_scale)
    grid = torch.where((which == 1)[:, None, None, None], grid_el, grid_aff)
    warped = grid_sample(x, grid)
    return _blend(x, warped, _gate(keys[9], b, 0.6))


def abinet_augment(key, images: torch.Tensor) -> torch.Tensor:
    """The ABINet-style chain of ``dataset.use_abi`` configurations: not
    ported yet (ROADMAP queue 1, item 3b, with the perspective warp it
    needs)."""
    raise NotImplementedError("abinet_augment (dataset.use_abi) is not ported yet: "
                              "ROADMAP queue 1, item 3b")
