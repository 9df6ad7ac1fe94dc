"""Batched 1-D 2-means foreground/background masks for glyph-mask generation.

Counterpart of ``ccd_tpu/ops/kmeans_mask.py``, whose parity target is
``clusterpixels(im, 2)`` (``Dino/utils/kmeans.py:7-23`` and its copies in
``mask_create/generate_mask.py:13`` / ``Dino/model/utils.py:93``): k-means
over the flattened grayscale intensities, then a border-majority polarity
flip so that the foreground (text) is 1.

Deterministic Lloyd iterations from the 25 % / 75 % points of each image's
range, a fixed number of them, as plain tensor ops on whatever device the
images are on: nothing is read back to the host inside the loop.
"""

from __future__ import annotations

import torch


def kmeans_foreground_mask(gray: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """(B, H, W) grayscale in [0, 255] or [0, 1] -> (B, H, W) float32 {0, 1}
    text mask.

    A pixel joins the upper centroid where ``|x - c1| < |x - c0|``, strictly;
    the centroids are fp32 sums, so a pixel that lies on their midpoint may
    land on either side in another framework's reduction order."""
    b, h, w = gray.shape
    x = gray.reshape(b, -1).float()

    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    c0 = lo + 0.25 * (hi - lo)
    c1 = lo + 0.75 * (hi - lo)
    total = x.sum(dim=1, keepdim=True)
    n = float(x.shape[1])

    for _ in range(iters):
        assign = ((x - c1).abs() < (x - c0).abs()).float()  # 1 -> cluster c1
        n1 = assign.sum(dim=1, keepdim=True)
        n0 = n - n1
        s1 = (x * assign).sum(dim=1, keepdim=True)
        s0 = total - s1
        c0 = torch.where(n0 > 0, s0 / n0.clamp_min(1.0), c0)
        c1 = torch.where(n1 > 0, s1 / n1.clamp_min(1.0), c1)
    code = ((x - c1).abs() < (x - c0).abs()).to(torch.int32).reshape(b, h, w)

    # border-majority polarity fix (kmeans.py:15-23): where >= 3 of the four
    # borders are majority 1, the clusters are inverted (background got 1)
    fc = code[:, :, 0].sum(dim=1)
    lc = code[:, :, -1].sum(dim=1)
    fr = code[:, 0, :].sum(dim=1)
    lr = code[:, -1, :].sum(dim=1)
    num = ((fr > w // 2).int() + (lr > w // 2).int()
           + (fc > h // 2).int() + (lc > h // 2).int())
    flip = (num >= 3)[:, None, None]
    return torch.where(flip, 1 - code, code).float()
