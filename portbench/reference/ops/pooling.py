"""Character attention pooling: cluster-mask-weighted token averaging.

Parity target: ``ABIDINOModel.attention`` (``Dino/model/dino_vision.py:38-49``):
bilinear-resize (B, T, H, W) cluster channels to the token grid, normalize
each channel to sum 1 (NaN -> 0 for empty channels), and matmul against the
token features to pool up to T per-character vectors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.ops.image import resize_bilinear


def char_attention_pool(features: torch.Tensor, clusters: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool per-character features from the token grid.

    Args:
      features: (B, h, w, E) token features on the patch grid (NHWC).
      clusters: (B, T, H, W) glyph-cluster channel masks (any H, W).
    Returns:
      attn_vecs: (B, T, E) pooled character vectors, in the wider of the two types.
      index: (B, T) bool — channel has nonzero support after resizing.
    """
    b, h, w, e = features.shape
    t = clusters.shape[1]
    clusters = resize_bilinear(clusters, (h, w), channel_last=False)  # (B, T, h, w)
    flat = clusters.reshape(b, t, h * w)
    sums = flat.sum(-1, keepdim=True)  # (B, T, 1)
    weights = torch.where(sums > 0, flat / sums.clamp_min(1e-12), torch.zeros_like(flat))
    dt = torch.promote_types(weights.dtype, features.dtype)  # fp32 weights: fp32 pooling
    attn_vecs = torch.bmm(weights.to(dt), features.reshape(b, h * w, e).to(dt))
    return attn_vecs, sums[..., 0] > 0
