"""Projection and segmentation heads.

Counterpart of ``ccd_tpu/models/heads.py``; parameter names are the
reference's, so its checkpoints load by name.

  * ``DINOHead`` — ``Dino/modules/vision_transformer.py:294-328``: 3-layer MLP
    (hidden 2048 -> bottleneck 256, BatchNorm after the hidden layers with
    ``use_bn``) -> L2 normalize -> weight-normed linear to ``out_dim``
    (65536), with the weight-norm gain ``g`` frozen when ``norm_last_layer``.
  * ``SegHead`` — ``Dino/modules/segmentor.py:37-95``: three per-level conv
    branches over the tapped ViT maps, concat to 192ch, two ConvTranspose 4x4
    stride-2 upsamplings (8x32 -> 32x128), 3x3 conv to 2-class text/background
    logits. BatchNorm statistics are over the whole batch it is given.
  * ``MlpEncoder`` — the finetune ``Mlp`` encoder (``Dino/model/dino_vision.py:117-133``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccd_tpu_torch.models.layers import (BatchNorm, Conv2d, ConvTranspose2d, Dense, Dropout,
                                         init_dense_layers, lecun_normal_, trunc_normal_)
from ccd_tpu_torch.ops.activations import gelu as _gelu


class _Gelu(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gelu(x)


class _WeightNormed(nn.Module):
    """The parameters of ``weight_norm(nn.Linear(in, out, bias=False))``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.weight_v = nn.Parameter(torch.zeros(out_features, in_features))


class _FeatureBatchNorm(BatchNorm):
    """Flax's ``nn.BatchNorm`` over the last axis of ``(..., C)`` features:
    statistics over every leading axis (the DINOHead's ``bn_{i}``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class DINOHead(nn.Module):
    """With ``use_bn`` a BatchNorm (Flax's ``momentum=0.9, epsilon=1e-5``,
    i.e. torch's ``momentum=0.1``; running variance fed the biased batch
    variance, see ``layers.BatchNorm``) follows the first and every hidden
    Dense, as in the reference's Sequential: ``mlp.{0,1,3,4,6}`` with
    BatchNorm, ``mlp.{0,2,4}`` without. Training mode normalises with the
    batch statistics and updates the running ones; evaluation mode uses the
    running ones."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False,
                 norm_last_layer: bool = True, nlayers: int = 3, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        nlayers = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        layers = []
        for i in range(nlayers):  # Dense, [BatchNorm,] GELU, as the reference's Sequential
            layers.append(Dense(dims[i], dims[i + 1], dtype=dtype))
            if i < nlayers - 1:
                if use_bn:
                    layers.append(_FeatureBatchNorm(dims[i + 1], dtype=dtype))
                layers.append(_Gelu())
        self.mlp = nn.Sequential(*layers)
        self.last_layer = _WeightNormed(bottleneck_dim, out_dim)
        self.use_bn = use_bn
        self.norm_last_layer = norm_last_layer
        self.dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_layers(self.mlp, generator)
        for m in self.mlp:
            if isinstance(m, BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        trunc_normal_(self.last_layer.weight_v, 0.02, generator)
        nn.init.ones_(self.last_layer.weight_g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlp(x)
        # L2 normalize (torch F.normalize: eps=1e-12 on the norm). The clamp
        # sits INSIDE the sqrt: empty char slots pool to all-zero vectors and
        # sqrt'(0) = inf would turn their (masked-out) cotangents into NaNs.
        sumsq = x.float().square().sum(-1, keepdim=True)
        x = x / torch.sqrt(sumsq.clamp_min(1e-24)).to(x.dtype)
        # weight-normed final linear (no bias): w = g * v / ||v||
        v, g = self.last_layer.weight_v, self.last_layer.weight_g
        if self.norm_last_layer:
            g = g.detach()  # the reference freezes weight_g at 1
        v_norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        w = (v * (g / v_norm.clamp_min(1e-12))).to(self.dtype)
        return F.linear(x, w)


def _mla_branch(in_channels: int, mla_channels: int, mlahead_channels: int,
                dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(in_channels, mla_channels, 3, padding=1, bias=False, dtype=dtype),
        BatchNorm(mla_channels, dtype=dtype), nn.ReLU(),
        Conv2d(mla_channels, mlahead_channels, 1, bias=False, dtype=dtype),
        BatchNorm(mlahead_channels, dtype=dtype), nn.ReLU())


class SegHead(nn.Module):
    def __init__(self, in_channels: int, mla_channels: int = 128, mlahead_channels: int = 64,
                 num_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlahead = nn.ModuleDict({
            f"head{i + 2}": _mla_branch(in_channels, mla_channels, mlahead_channels, dtype)
            for i in range(3)})
        # ConvTranspose2d(k=4, s=2, p=1): exact 2x upsampling
        self.unpool1 = nn.Sequential(
            ConvTranspose2d(3 * mlahead_channels, 128, 4, stride=2, padding=1, dtype=dtype),
            BatchNorm(128, dtype=dtype), nn.ReLU())
        self.unpool2 = nn.Sequential(
            ConvTranspose2d(128, 128, 4, stride=2, padding=1, dtype=dtype),
            BatchNorm(128, dtype=dtype), nn.ReLU())
        self.cls = Conv2d(128, num_classes, 3, padding=1, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initialisers: LeCun normal for the convolutions,
        uniform with variance 1/(3 fan_in) for the transposed ones, zero
        biases, unit BatchNorm scales and running variances."""
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                bound = (1.0 / fan_in) ** 0.5
                with torch.no_grad():
                    m.weight.uniform_(-bound, bound, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                lecun_normal_(m.weight, fan_in, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        """taps: 3x (B, gh, gw, E) -> (B, 4*gh, 4*gw, num_classes) logits."""
        heads = [self.mlahead[f"head{i + 2}"](taps[i].permute(0, 3, 1, 2)) for i in range(3)]
        x = torch.cat(heads, dim=1)  # (B, 192, gh, gw)
        x = self.cls(self.unpool2(self.unpool1(x)))
        return x.permute(0, 2, 3, 1)


class MlpEncoder(nn.Module):
    """Finetune encoder: Mlp(embed_dim -> 512 -> 512, GELU, dropout 0.1)."""

    def __init__(self, in_features: int, hidden_features: int = 512,
                 out_features: int = 512, drop: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop(_gelu(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)
