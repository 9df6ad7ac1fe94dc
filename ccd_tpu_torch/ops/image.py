"""Separable matrix-based image resizing (resampling as two small matmuls).

The interpolation weights are built in numpy as dense (out, in) matrices and
applied over H and W, so the coordinate mapping is stated here and does not
depend on the installed ``F.interpolate``.

Semantics parity:
  * :func:`resize_bilinear` — half-pixel centers with edge clamp; matches
    ``cv2.resize(INTER_LINEAR)`` and ``F.interpolate(mode='bilinear',
    align_corners=False)`` (no antialiasing, like both).
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
