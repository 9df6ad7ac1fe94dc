"""Separable matrix-based image resizing (resampling as two small matmuls).

The interpolation weights are built in numpy as dense (out, in) matrices and
applied over H and W, so the coordinate mapping is stated here and does not
depend on the installed ``F.interpolate``.

Semantics parity:
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
def _resize_matrix(in_size: int, out_size: int,
                   scale: Optional[float] = None) -> np.ndarray:
    """(out_size, in_size) row-stochastic bicubic interpolation matrix."""
    if scale is None:
        scale = out_size / in_size
    # half-pixel (align_corners=False) source coordinates
    src = (np.arange(out_size) + 0.5) / scale - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    for tap in range(-1, 3):
        w = _cubic_weight(frac - tap)
        kc = np.clip(i0 + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), kc), w)
    return mat.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int],
                   scale: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Bicubic (a=-0.75) resize of a channel-last ``(..., H, W, C)`` tensor,
    matching torch ``interpolate(mode='bicubic')``.

    ``scale``: optional (scale_h, scale_w) to use for the coordinate mapping
    (torch ``scale_factor`` semantics); defaults to out/in.
    """
    in_h, in_w = x.shape[-3], x.shape[-2]
    sh = float(scale[0]) if scale is not None else None
    sw = float(scale[1]) if scale is not None else None
    mh = torch.as_tensor(_resize_matrix(in_h, out_hw[0], sh),
                         dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(_resize_matrix(in_w, out_hw[1], sw),
                         dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, y)
