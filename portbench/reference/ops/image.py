"""Separable matrix-based image resizing (resampling as two small matmuls).

The interpolation weights are built in numpy as dense (out, in) matrices and
applied over H and W, so the coordinate mapping is stated here and does not
depend on the installed ``F.interpolate``.

Semantics parity:
  * :func:`resize_bilinear` — half-pixel centers with edge clamp; matches
    ``cv2.resize(INTER_LINEAR)`` and ``F.interpolate(mode='bilinear',
    align_corners=False)`` (no antialiasing, like both).
  * :func:`jax_image_resize` — ``jax.image.resize`` (``"linear"``, ``"cubic"``
    with Keys' a=-0.5, ``"nearest"``), ANTIALIASED when it downsamples: the
    kernel is widened by in/out, so a 2x linear downsample averages four
    input pixels, not two. The augmentation calls it where the JAX package
    calls ``jax.image.resize``.
  * :func:`resize_bicubic` — cubic kernel with a=-0.75 (torch/OpenCV
    convention), half-pixel centers, edge clamp; matches
    ``F.interpolate(mode='bicubic', align_corners=False)``. The optional
    ``scale`` argument reproduces torch's behavior when a ``scale_factor`` is
    passed explicitly (coordinate mapping uses the given scale, not out/in) —
    required for parity with the reference ViT pos-embedding interpolation
    (``Dino/modules/vision_transformer.py:182-201`` passes
    ``scale_factor=(w0+0.1)/sqrt(N)``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.utils.device import device_constant


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), torch/OpenCV coefficient a=-0.75."""
    ax = np.abs(x)
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
        np.where(ax < 2.0, a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, method: str,
                   scale: Optional[float] = None) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix."""
    if scale is None:
        scale = out_size / in_size
    # half-pixel (align_corners=False) source coordinates
    src = (np.arange(out_size) + 0.5) / scale - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    if method == "linear":
        taps = ((0, 1.0 - frac), (1, frac))
    elif method == "cubic":
        taps = tuple((tap, _cubic_weight(frac - tap)) for tap in range(-1, 3))
    else:
        raise ValueError(f"unknown resize method {method!r}")
    for tap, w in taps:
        kc = np.clip(i0 + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), kc), w)
    return mat.astype(np.float32)


def _matrices(x: torch.Tensor, in_hw, out_hw, method: str, scale=(None, None)):
    return [torch.as_tensor(_resize_matrix(i, o, method, sc), dtype=x.dtype, device=x.device)
            for i, o, sc in zip(in_hw, out_hw, scale)]


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    channel_last: bool = True) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, edge clamp, no antialias.

    ``x``: (..., H, W, C) if channel_last else (..., H, W).
    """
    if channel_last:
        mh, mw = _matrices(x, x.shape[-3:-1], out_hw, "linear")
        y = torch.einsum("oh,...hwc->...owc", mh, x)
        return torch.einsum("pw,...owc->...opc", mw, y)
    mh, mw = _matrices(x, x.shape[-2:], out_hw, "linear")
    y = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...ow->...op", mw, y)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int],
                   scale: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Bicubic (a=-0.75) resize of a channel-last ``(..., H, W, C)`` tensor,
    matching torch ``interpolate(mode='bicubic')``.

    ``scale``: optional (scale_h, scale_w) to use for the coordinate mapping
    (torch ``scale_factor`` semantics); defaults to out/in.
    """
    scale = (None, None) if scale is None else (float(scale[0]), float(scale[1]))
    mh, mw = _matrices(x, x.shape[-3:-1], out_hw, "cubic", scale)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, y)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """``jax.image``'s cubic kernel (Keys, a=-0.5), for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _jax_resize_taps(in_size: int, out_size: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """(index, weight) arrays of shape (taps, out_size): output ``o`` is
    ``sum_t weight[t, o] * input[index[t, o]]``. Built in float32 from
    ``jax.image``'s weight matrix (antialias on, no translation): sample
    position ``(o + 0.5) * in/out - 0.5``, kernel widened by ``max(in/out, 1)``,
    columns normalised to sum 1, samples outside the input zeroed."""
    if method == "nearest":
        src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(in_size) / np.float32(out_size)
        return np.floor(src).astype(np.int64)[None], np.ones((1, out_size), np.float32)
    kernels = {"linear": lambda x: np.maximum(0.0, 1.0 - x).astype(np.float32),
               "cubic": _keys_cubic}
    if method not in kernels:
        raise ValueError(f"unknown resize method {method!r}")
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernels[method](x.astype(np.float32))                      # (in, out)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, np.float32(0.0))
    taps = max(int((weights != 0).sum(axis=0).max()), 1)
    index = np.zeros((taps, out_size), np.int64)
    weight = np.zeros((taps, out_size), np.float32)
    for o in range(out_size):
        nz = np.nonzero(weights[:, o])[0]
        index[:len(nz), o] = nz
        weight[:len(nz), o] = weights[nz, o]
    return index, weight


def _resize_axis(x: torch.Tensor, axis: int, out_size: int, method: str) -> torch.Tensor:
    index, weight = device_constant(_jax_resize_taps, x.device, x.shape[axis], out_size, method)
    shape = [1] * x.ndim
    shape[axis] = out_size
    out = None
    for idx, w in zip(index, weight):
        term = x.index_select(axis, idx)
        if method != "nearest":
            term = term * w.to(x.dtype).reshape(shape)
        out = term if out is None else out + term
    return out


def jax_image_resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)``: every axis whose size changes is
    resampled, one after the other. Each output is a weighted sum of a few
    gathered inputs (elementwise fp32 products, no matrix product), so no
    TF32 path can round it."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match rank {x.ndim}")
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            x = _resize_axis(x, axis, int(n_out), method)
    return x
