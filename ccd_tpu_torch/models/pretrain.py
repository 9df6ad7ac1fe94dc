"""CCD pretraining model: student/teacher ViT with char-pooled DINO head.

Parity target: ``ABIDINOModel`` (``Dino/model/dino_vision.py:21-115``);
counterpart of ``ccd_tpu/models/pretrain.py``. The module exposes the three
compute stages (encode / segment / pool+project) as separate methods so the
training step can interleave the non-differentiable glyph clustering and
theta-warping between them. ``forward`` runs the full student path.

Training behaviour (drop path, BatchNorm batch statistics) follows the
module's mode: the step keeps the student in ``train()`` and the teacher in
``eval()``. ``remat`` recomputes each ViT block in the backward
(``models/vit.py::remat_block``); ``build_pretrain_models`` sets it on the student only.

Character slots are kept PADDED to (B, 26) with a validity mask instead of
the reference's ragged boolean indexing (``dino_vision.py:83-87``); the DINO
loss consumes the mask.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ccd_tpu_torch.models.heads import DINOHead, SegHead
from ccd_tpu_torch.models.vit import VIT_ARCHS
from ccd_tpu_torch.ops.pooling import char_attention_pool


def char_validity_mask(index: torch.Tensor, num_slots: int = 26) -> torch.Tensor:
    """Reference-exact valid-slot mask (dino_vision.py:82-87).

    ``index``: (B, num_slots) bool channel-support mask from pooling of the
    *source-view* clusters. length = clamp(#nonzero, 3, 26); slots with
    position <= length are kept (note the reference's ``<=`` keeps length+1
    slots, reproduced as-is).
    """
    length = index.sum(dim=1).clamp(3, num_slots)[:, None]
    grid = torch.arange(num_slots, device=index.device)[None, :]
    return grid <= length


class CCDPretrainModel(nn.Module):
    def __init__(self, arch: str = "vit_small", patch_size: int = 4,
                 drop_path_rate: float = 0.0, out_dim: int = 65536,
                 use_bn_in_head: bool = False, norm_last_layer: bool = True,
                 with_seg_head: bool = True,  # student has a SegHead; teacher does not
                 num_slots: int = 26, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.out_dim, self.num_slots = patch_size, out_dim, num_slots
        self.norm_last_layer, self.dtype = norm_last_layer, dtype
        self.backbone = VIT_ARCHS[arch](patch_size=patch_size, drop_path_rate=drop_path_rate,
                                        remat=remat, dtype=dtype)
        embed_dim = self.backbone.embed_dim
        self.segmentation = SegHead(embed_dim, mla_channels=128, mlahead_channels=64,
                                    num_classes=2, dtype=dtype) if with_seg_head else None
        self.head = DINOHead(embed_dim, out_dim, use_bn=use_bn_in_head,
                             norm_last_layer=norm_last_layer, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.backbone.reset_parameters(generator)
        if self.segmentation is not None:
            self.segmentation.reset_parameters(generator)
        self.head.reset_parameters(generator)

    # ------------------------------------------------------------ stages
    def encode(self, images: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """images (N, H, W, 3) -> (region_f (N, gh, gw, E), taps). ``generator``
        draws the drop-path masks in training mode. Only a model with a seg
        head computes the taps (the teacher's list is empty)."""
        n, h, w, _ = images.shape
        tokens, taps = self.backbone(images, generator,
                                     with_taps=self.segmentation is not None)
        gh, gw = h // self.patch_size, w // self.patch_size
        return tokens.reshape(n, gh, gw, tokens.shape[-1]), taps

    def segment(self, taps) -> torch.Tensor:
        """3 taps -> (N, H, W, 2) text/background logits."""
        return self.segmentation(taps)

    def pool(self, region_f: torch.Tensor, clusters: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Char-pooling alone: (N, gh, gw, E) x (N, T, H, W) ->
        ((N, T, E) char vectors, (N, T) channel-support bool)."""
        return char_attention_pool(region_f, clusters)

    def project(self, attn_vecs: torch.Tensor) -> torch.Tensor:
        """DINOHead projection over the last axis; any leading shape."""
        return self.head(attn_vecs)

    def pool_project(self, region_f: torch.Tensor, clusters: torch.Tensor,
                     flat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Char-pool features with cluster maps and project through DINOHead.

        region_f: (N, gh, gw, E); clusters: (N, T, H, W).
        Returns (logits, index (N, T) channel-support bool).

        ``flat``: collapse (N, T) BEFORE the out_dim projection, on the
        256-wide head input, and return logits as (N*T, out_dim)
        view-stacked rows: the rows the fused CE kernel consumes.
        """
        attn_vecs, index = self.pool(region_f, clusters)
        if flat:
            attn_vecs = attn_vecs.reshape(-1, attn_vecs.shape[-1])
        return self.project(attn_vecs), index

    def forward(self, images: torch.Tensor, clusters: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Full student path (touches every parameter)."""
        region_f, taps = self.encode(images, generator)
        seg_logits = self.segment(taps) if self.segmentation is not None else None
        if clusters is None:
            n, h, w, _ = images.shape
            clusters = torch.zeros((n, self.num_slots, h, w), dtype=self.dtype,
                                   device=images.device)
        logits, index = self.pool_project(region_f, clusters)
        return {"instances_view": logits, "mask": seg_logits, "index": index,
                "feature": region_f}
