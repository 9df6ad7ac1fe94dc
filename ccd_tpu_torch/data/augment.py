"""Batched, on-device augmentation: the photometric chains of every
severity and the random affine view with its recorded theta (pretraining),
the staged supervised chain and the ABINet-style chain (finetuning).

Counterpart of ``ccd_tpu/data/augment.py``, function for function. The whole
batch is augmented on the device in one call with draws from a key object
(``ccd_tpu_torch/data/random.py``) made in the same order and shapes as the
JAX draws; nothing is read back to the host. Theta is the normalised inverse
affine that maps view-2 grid coordinates back to the source frame, the matrix
the step later feeds to ``affine_grid``/``grid_sample`` to warp the glyph
clusters (``dino_vision.py:72-77``).

* ``photometric_augment`` = ``get_augmentation_pipeline(severity)``,
  ``augmentation_pipelines.py:4-235``, severities 1-6; severity 5 (the
  pretraining default): Sometimes(0.2, Identity, Sequential[
  arithmetic(OneOf-21), Sometimes(.7) colour(OneOf-9), Sometimes(.7) blur,
  Sometimes(.7) contrast(OneOf-8), Sometimes(.7) weather(OneOf-4)]).

* ``supervised_augment`` = the finetune chain, ``dataset_pretrain.py:80-160``:
  Invert, the big OneOf of noise/colour/weather ops with ChannelShuffle, the
  blur family without the bilateral filter, contrast, then one of affine,
  piecewise-affine (an elastic grid) and rotation.

* ``abinet_augment`` = the ``dataset.use_abi`` chain,
  ``Dino/dataset/transforms.py:307-366``: geometry (rotation, affine or
  perspective), deterioration (noise, motion blur or pixelate) and colour
  jitter.

Only severity 5 reaches a hand-written kernel (the bilateral filter of its
blur family); the other chains are elementwise ops, gathers and resizes.

The training steps run a chain through ``graphed_augment``: on the card, a
chain's thousands of small launches replay as one captured CUDA graph per
input shape, drawing the numbers the eager chain draws.
"""

from __future__ import annotations

from typing import Callable, Hashable, Tuple

import numpy as np
import torch

from ccd_tpu_torch.data import aug_ops as A
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.ops.image import jax_image_resize
from ccd_tpu_torch.ops.warp import affine_grid, grid_sample, homography_grid
from ccd_tpu_torch.utils.cuda_graphs import GraphCache, Outputs
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


def _motion_blur(x: torch.Tensor, key, strength: float) -> torch.Tensor:
    """Random-direction 5-tap line blur (approximates iaa.MotionBlur): per
    sample horizontal or vertical, edge padded."""
    b, h, w, _ = x.shape
    horiz = key.bernoulli(0.5, (b, 1, 1, 1)).to(x.dtype)
    xp_h = A._pad_edge(x, 0, 0, 2, 2)
    blur_h = sum(xp_h[:, :, i:i + w] for i in range(5)) / 5.0
    xp_v = A._pad_edge(x, 2, 2, 0, 0)
    blur_v = sum(xp_v[:, i:i + h] for i in range(5)) / 5.0
    blurred = horiz * blur_h + (1.0 - horiz) * blur_v
    return x * (1.0 - strength) + blurred * strength


def photometric_augment(key, images: torch.Tensor, severity: int = 5) -> torch.Tensor:
    """``get_augmentation_pipeline(severity)`` on (B, H, W, 3) float [0,1]
    images, severities 1-6 chain for chain (``augmentation_pipelines.py:4-235``);
    severity 5 (the pretraining default)::

        Sometimes(0.2, Identity, Sequential[
            OneOf(21 arithmetic ops),            # always applied
            Sometimes(0.7, OneOf(9 colour ops)),
            Sometimes(0.7, OneOf[Sharpen, OneOf(5 blurs)]),
            Sometimes(0.7, OneOf(8 contrast ops)),
            Sometimes(0.7, OneOf(4 weather ops)),
        ])

    Any other severity raises ``NotImplementedError``, as in JAX.
    """
    if severity == 1:
        return _severity_1_3(key, images, invert_p=0.5)
    if severity == 2:
        return _severity_2(key, images)
    if severity == 3:
        return _severity_1_3(key, images, invert_p=0.1)
    if severity == 4:
        return _severity_4(key, images)
    if severity == 6:
        return _severity_6(key, images)
    if severity != 5:
        raise NotImplementedError(f"augmentation_severity={severity} is not supported")
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


def _severity_1_3(key, images: torch.Tensor, invert_p: float) -> torch.Tensor:
    """Severities 1 and 3 (identical but for Invert's p: 0.5 and 0.1),
    ``augmentation_pipelines.py:10-39, 53-81``: Sequential[Invert,
    OneOf(9 colour), OneOf[Sharpen, OneOf(4 blurs)], OneOf(4 noise)]."""
    keys = key.split(4)
    color_ops = [
        lambda k, y: A.op_channel_shuffle(k, y, p=0.35),
        A.op_grayscale,
        A.op_kmeans_color_quantization,
        A.op_histogram_equalization,
        lambda k, y: A.op_dropout(k, y, p_max=0.2),
        A.op_gamma_contrast,
        A.op_multiply_brightness,
        A.op_add_hue_saturation,
        A.op_change_color_temperature,
    ]
    noise_ops = [
        A.op_emboss,
        A.op_additive_gaussian,
        A.op_impulse_noise,
        lambda k, y: A.op_multiply_elementwise(k, y, p_per_channel=0.0),
    ]
    x = A.op_invert(keys[0], images, p=invert_p)
    x = A.one_of(keys[1], x, color_ops)
    x = A.blur_family(keys[2], x, kinds=A.BLUR_KINDS)  # no BilateralBlur
    return A.one_of(keys[3], x, noise_ops)


def _severity_2(key, images: torch.Tensor) -> torch.Tensor:
    """Severity 2, ``augmentation_pipelines.py:40-51``: SomeOf((1, None),
    [LinearContrast, GaussianBlur, Crop(top/bottom 0-40%), Crop(left/right
    0-2%), Sharpen, ElasticTransformation(0-0.8, 0.25),
    PerspectiveTransform(0.01-0.02)], random_order=True)."""
    ops = [
        A.op_linear_contrast,
        A.op_gaussian_blur,
        lambda k, y: _op_crop(k, y, tb=(0.0, 0.4), lr=(0.0, 0.0)),
        lambda k, y: _op_crop(k, y, tb=(0.0, 0.0), lr=(0.0, 0.02)),
        A.op_sharpen,
        _op_elastic,
        _op_perspective,
    ]
    return A.some_of_random_order(key, images, ops)


def _severity_4(key, images: torch.Tensor) -> torch.Tensor:
    """Severity 4, ``augmentation_pipelines.py:83-121``: Sometimes(0.2,
    Identity, Sequential[Sometimes(0.3, Invert(0.1)), Sometimes(0.6,
    OneOf(11 colour)), Sometimes(0.6, blur family), Sometimes(0.6,
    OneOf(5 noise))])."""
    keys = key.split(5)
    color_ops = [
        lambda k, y: A.op_channel_shuffle(k, y, p=0.35),
        A.op_grayscale,
        A.op_kmeans_color_quantization,
        A.op_histogram_equalization,
        A.op_clahe,
        lambda k, y: A.op_dropout(k, y, p_max=0.1),
        A.op_gamma_contrast,
        A.op_linear_contrast,
        A.op_multiply_brightness,
        A.op_add_hue_saturation,
        A.op_change_color_temperature,
    ]
    noise_ops = [
        A.op_emboss,
        lambda k, y: A.op_additive_gaussian(k, y, scale_max=0.1),
        lambda k, y: A.op_impulse_noise(k, y, p=0.05),
        lambda k, y: A.op_multiply_elementwise(k, y, p_per_channel=0.0),
        lambda k, y: A.op_coarse_dropout(k, y, p=0.02, size_percent=0.5, per_channel=0.0),
    ]
    x = A.sometimes(keys[0], images, 0.3, lambda k, y: A.op_invert(k, y, p=0.1))
    x = A.sometimes(keys[1], x, 0.6, lambda k, y: A.one_of(k, y, color_ops))
    x = A.sometimes(keys[2], x, 0.6, lambda k, y: A.blur_family(k, y, kinds=A.BLUR_KINDS))
    x = A.sometimes(keys[3], x, 0.6, lambda k, y: A.one_of(k, y, noise_ops))
    keep = _gate(keys[4], images.shape[0], 0.2)
    return _blend(x, images, keep)


def _severity_6(key, images: torch.Tensor) -> torch.Tensor:
    """Severity 6, ``augmentation_pipelines.py:210-232``: a flat OneOf(17
    colour/contrast ops)."""
    ops = [
        A.op_hue_add,
        A.op_multiply_and_add_to_brightness,
        A.op_multiply_hue_saturation,
        A.op_hue_add_strong,
        A.op_uniform_color_quantization,
        lambda k, y: A.op_channel_shuffle(k, y, p=0.35),
        A.op_grayscale,
        A.op_kmeans_color_quantization,
        A.op_histogram_equalization,
        lambda k, y: A.op_dropout(k, y, p_max=0.2),
        A.op_gamma_contrast,
        A.op_multiply_brightness,
        A.op_add_hue_saturation,
        A.op_change_color_temperature,
        A.op_sharpen,
        A.op_clahe,
        A.op_linear_contrast,
    ]
    return A.one_of(key, images, ops)


def _pixel_centres(n: int, device) -> torch.Tensor:
    """The align_corners=False grid coordinates ``(2i + 1) / n - 1``."""
    return (2.0 * torch.arange(n, dtype=torch.float32, device=device) + 1.0) / n - 1.0


def _op_crop(key, x: torch.Tensor, tb=(0.0, 0.4), lr=(0.0, 0.0)) -> torch.Tensor:
    """iaa.Crop(percent=..., keep_size=True): per-side whole-pixel crop and
    resize back, as one bilinear grid_sample of the crop rectangle."""
    b, h, w, _ = x.shape
    k = key.split(4)
    top = torch.floor(k[0].uniform((b,), tb[0], tb[1]) * h)
    bottom = torch.floor(k[1].uniform((b,), tb[0], tb[1]) * h)
    left = torch.floor(k[2].uniform((b,), lr[0], lr[1]) * w)
    right = torch.floor(k[3].uniform((b,), lr[0], lr[1]) * w)
    # in align_corners=False normalised coordinates the crop is the affine
    # map src = s * out + t with s = (dim - a - b) / dim, t = (a - b) / dim
    sy = (h - top - bottom) / h
    ty = (top - bottom) / h
    sx = (w - left - right) / w
    tx = (left - right) / w
    zeros = torch.zeros_like(sx)
    theta = torch.stack([torch.stack([sx, zeros, tx], dim=-1),
                         torch.stack([zeros, sy, ty], dim=-1)], dim=-2)
    return grid_sample(x, affine_grid(theta, (h, w)))


def _elastic_weights(sigma: float) -> np.ndarray:
    wts = np.exp(-np.array([1.0, 0.0, 1.0]) / (2.0 * sigma * sigma))
    return (wts / wts.sum()).astype(np.float32)


def _op_elastic(key, x: torch.Tensor, alpha=(0.0, 0.8), sigma: float = 0.25) -> torch.Tensor:
    """iaa.ElasticTransformation(alpha=(0, 0.8), sigma=0.25): a per-pixel
    U(-1, 1) displacement field smoothed by a 3-tap separable gaussian
    (edge padded), scaled by a per-sample alpha in pixels, applied as a
    sub-pixel warp."""
    b, h, w, _ = x.shape
    k1, k2, _k3 = key.split(3)  # the third key is unused, as in JAX
    a = k1.uniform((b, 1, 1, 1), alpha[0], alpha[1])
    disp = k2.uniform((b, h, w, 2), -1.0, 1.0)
    wts = [float(v) for v in _elastic_weights(sigma)]

    def blur_h(d):
        dp = A._pad_edge(d, 1, 1, 0, 0)
        return wts[0] * dp[:, 0:h] + wts[1] * dp[:, 1:h + 1] + wts[2] * dp[:, 2:h + 2]

    def blur_w(d):
        dp = A._pad_edge(d, 0, 0, 1, 1)
        return wts[0] * dp[:, :, 0:w] + wts[1] * dp[:, :, 1:w + 1] + wts[2] * dp[:, :, 2:w + 2]

    disp = blur_w(blur_h(disp)) * a
    gy, gx = torch.meshgrid(_pixel_centres(h, x.device), _pixel_centres(w, x.device),
                            indexing="ij")
    grid = torch.stack([gx + disp[..., 0] * (2.0 / w), gy + disp[..., 1] * (2.0 / h)], dim=-1)
    return grid_sample(x, grid)


def _corners():
    """The source corners in normalised coordinates, and the direction in
    which each corner moves inwards."""
    src = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], np.float32)
    sign = np.array([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], np.float32)
    return src, sign


def _op_perspective(key, x: torch.Tensor, scale=(0.01, 0.02)) -> torch.Tensor:
    """iaa.PerspectiveTransform(scale=(0.01, 0.02)): corners moved inwards by
    |N(0, s)| of the image size, the 4-point homography, keep_size."""
    b, h, w, _ = x.shape
    k1, k2 = key.split()
    s = k1.uniform((b, 1, 1), scale[0], scale[1])
    jitter = k2.normal((b, 4, 2)).abs() * s * 2.0
    src, sign = device_constant(_corners, x.device)
    dst = src[None] + jitter * sign[None]
    hmat = _solve_homography(src.expand(b, 4, 2), dst)
    return grid_sample(x, homography_grid(hmat, (h, w)))


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
    gy, gx = torch.meshgrid(_pixel_centres(h, scale.device), _pixel_centres(w, scale.device),
                            indexing="ij")
    base = torch.stack([gx, gy], -1).expand(b, h, w, 2)
    coarse = key.uniform((b, 4, 8, 2), -1.0, 1.0)
    disp = jax_image_resize(coarse, (b, h, w, 2), "cubic") * scale
    return base + disp


def _solve_linear(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x with a @ x = rhs for (B, n, n) and (B, n), by Gauss-Jordan elimination
    with partial pivoting written in tensor ops: no library solver, which
    on the card checks for singular inputs and so makes the host wait."""
    b, n = rhs.shape
    m = torch.cat([a, rhs[..., None]], dim=-1)                   # (B, n, n + 1)
    rows = torch.arange(n, device=a.device)
    for c in range(n):
        # the largest |entry| of column c on or below the diagonal
        cand = torch.where(rows >= c, m[:, :, c].abs(), -1.0)
        p = cand.argmax(dim=-1, keepdim=True)                    # (B, 1)
        perm = torch.where(rows == c, p, torch.where(rows == p, c, rows))
        m = torch.gather(m, 1, perm[..., None].expand(b, n, n + 1))
        pivot_row = m[:, c:c + 1]                                # (B, 1, n + 1)
        factor = torch.where((rows != c)[:, None], m[:, :, c:c + 1] / pivot_row[..., c:c + 1],
                             0.0)
        m = m - factor * pivot_row
    return m[..., n] / torch.diagonal(m[..., :n], dim1=-2, dim2=-1)


def _solve_homography(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """DLT, batched: the (B, 3, 3) H that maps corner sets ``d`` -> ``s``
    ((B, 4, 2) each; the output grid samples the source), from the 8x8
    linear system, with H[2, 2] = 1."""
    x, y, u, v = d[..., 0], d[..., 1], s[..., 0], s[..., 1]     # (B, 4)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    row_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)
    row_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    a = torch.stack([row_u, row_v], dim=2).reshape(-1, 8, 8)   # rows u0, v0, u1, v1, ...
    rhs = torch.stack([u, v], dim=2).reshape(-1, 8)
    h8 = _solve_linear(a, rhs)
    return torch.cat([h8, torch.ones_like(h8[:, :1])], dim=-1).reshape(-1, 3, 3)


def _random_perspective(key, b: int, h: int, w: int, distortion: float = 0.3) -> torch.Tensor:
    """(B, 3, 3) normalised projective matrices from corners moved inwards by
    U(0, distortion) (CVRandomPerspective-style): the 4-point homography of
    each sample."""
    k1, = key.split(1)
    jitter = k1.uniform((b, 4, 2), 0.0, distortion)
    src, sign = device_constant(_corners, jitter.device)
    dst = src[None] + jitter * sign[None]
    return _solve_homography(src.expand(b, 4, 2), dst)


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
    """The ABINet-style chain of ``dataset.use_abi`` configurations on
    (B, H, W, 3) float [0, 1] images (``Dino/dataset/transforms.py:307-366``):

        geometry, p = 0.5: rotation (+-45 deg), affine or perspective, one per
            sample, as one warp;
        deterioration, p = 0.25: Gaussian noise of variance 20/255^2, the
            5-tap motion blur, or a 4x pixelate (antialiased linear down,
            nearest up), one per sample;
        colour jitter, p = 0.25: brightness and contrast in [0.5, 1.5].

    Candidates are selected by index, not by a one-hot product."""
    b, h, w, _ = images.shape
    keys = key.split(12)
    x = images

    # geometry p=0.5: rotate / affine / perspective (uniform pick)
    theta_rot = _random_affine_matrix(keys[0], b, h, w, scale=(1.0, 1.0), translate=0.0,
                                      rotate=45.0, shear_x=0.0, shear_y=0.0)
    theta_aff = _random_affine_matrix(keys[1], b, h, w, scale=(0.5, 2.0), translate=0.0,
                                      rotate=15.0, shear_x=45.0, shear_y=15.0)
    hmat = _random_perspective(keys[2], b, h, w, distortion=0.5)
    which = keys[3].randint((b,), 0, 3)
    theta = torch.where((which == 0)[:, None, None], theta_rot, theta_aff)
    grid_a = affine_grid(theta[:, :2, :], (h, w))
    grid_p = homography_grid(hmat, (h, w))
    grid = torch.where((which == 2)[:, None, None, None], grid_p, grid_a)
    x = _blend(x, grid_sample(x, grid), _gate(keys[4], b, 0.5))

    # deterioration p=0.25: gaussian noise var 20 / motion blur / pixelate
    noise = keys[5].normal(x.shape) * (20.0 ** 0.5 / 255.0)
    c0 = torch.clamp(x + noise, 0.0, 1.0)
    c1 = _motion_blur(x, keys[6], 1.0)
    small = jax_image_resize(x, (b, h // 4, w // 4, 3), "linear")
    c2 = jax_image_resize(small, (b, h, w, 3), "nearest")
    pick = keys[7].randint((b,), 0, 3)
    det = A._select(torch.stack([c0, c1, c2]), pick)
    x = _blend(x, det, _gate(keys[8], b, 0.25))

    # colour jitter p=0.25: brightness / contrast
    bright = _per_sample(keys[9], b, 0.5, 1.5)
    contrast = _per_sample(keys[10], b, 0.5, 1.5)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    jit = torch.clamp((x * bright - mean) * contrast + mean, 0.0, 1.0)
    return _blend(x, jit, _gate(keys[11], b, 0.25))


def _graphable(images: torch.Tensor) -> bool:
    """Whether an augmentation may replay a graph: ``images`` on the card and
    no capture already under way (the chain then joins it eagerly)."""
    return images.is_cuda and not torch.cuda.is_current_stream_capturing()


def graphed_augment(graphs: GraphCache, generator: torch.Generator, images: torch.Tensor,
                    chain: Callable[..., Outputs], *args) -> Outputs:
    """``chain(TorchKey(generator), images, *args)``: through ``graphs`` where
    :func:`_graphable` holds, eagerly anywhere else.

    Through the cache a key's first call runs eagerly, its second captures
    the chain and later calls replay it, keyed (:func:`graph_key`) by the
    input's shape, dtype and device, the chain and its ``args`` and the
    generator. The chain's
    launches do not depend on its draws and it never waits for the card
    (``aug_ops``' docstring), so the capture holds the whole chain, and its
    tables lie outside the graphs' pool (``device_constant``). The
    generator is registered on each graph: eager calls, captures and
    replays draw the same numbers and leave it in the same state, as
    ``cuda_graphs``' docstring sets out. ``graphs`` opens its span (the
    steps name it ``augment_graph``) around each replay."""
    def run(x: torch.Tensor) -> Outputs:
        return chain(TorchKey(generator), x, *args)

    if not _graphable(images):
        return run(images)
    return graphs(graph_key(generator, images, chain, args), run, images, (generator,))


def graph_key(generator: torch.Generator, images: torch.Tensor, chain: Callable,
              args: tuple) -> Hashable:
    """The key of ``graphed_augment``'s graph for these arguments."""
    return (tuple(images.shape), images.dtype, images.device, chain, args, generator)
