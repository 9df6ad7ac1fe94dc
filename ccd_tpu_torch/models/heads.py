"""Heads on top of the ViT backbone.

Counterpart of ``ccd_tpu/models/heads.py``. Ported so far: the finetune
encoder. ``DINOHead`` and ``SegHead`` arrive with the pretraining path.
"""

from __future__ import annotations

import torch
from torch import nn

from ccd_tpu_torch.models.layers import Dense
from ccd_tpu_torch.ops.activations import gelu as _gelu


class MlpEncoder(nn.Module):
    """Finetune encoder: Mlp(embed_dim -> 512 -> 512, GELU, dropout 0.1)."""

    def __init__(self, in_features: int, hidden_features: int = 512,
                 out_features: int = 512, drop: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype)
        self.drop = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(_gelu(self.fc1(x)))
        return self.drop(self.fc2(x))
