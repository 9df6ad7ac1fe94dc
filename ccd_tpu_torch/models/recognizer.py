"""Finetune/test recognition model: ViT backbone + Mlp encoder + NRTR decoder.

Parity target: ``DINO_Finetune`` (``Dino/model/dino_vision.py:135-290``):
backbone tokens -> Mlp(embed_dim -> 512) encoder -> NRTR decoder; train mode
is teacher-forced (returns logits + last-layer cross-attention for
visualization), test mode is greedy decoding returning per-step softmax
scores ``(B, max_seq_len, num_classes - 1)``. Counterpart of
``ccd_tpu/models/recognizer.py``; submodule names are the reference's
(``backbone``, ``encoder``, ``decoder``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccd_tpu_torch.models.heads import MlpEncoder
from ccd_tpu_torch.models.nrtr import NRTRDecoder
from ccd_tpu_torch.models.vit import VIT_ARCHS
from ccd_tpu_torch.utils.tracing import span

_ENCODER_WIDTH = 512  # Mlp(embed_dim -> 512 -> 512) (dino_vision.py:163)


class CCDRecognizer(nn.Module):
    def __init__(self, arch: str = "vit_small", patch_size: int = 4,
                 drop_path_rate: float = 0.1,
                 # decoder configuration (CCD_vision_model_*.yaml `decoder:` block)
                 decoder_n_layers: int = 6, decoder_d_embedding: int = 512,
                 decoder_n_head: int = 8, decoder_d_k: int = 64, decoder_d_v: int = 64,
                 decoder_d_model: int = 512, decoder_d_inner: int = 256,
                 decoder_dropout: float = 0.1,
                 num_classes: int = 93,  # AttnConvertor('DICT90', with_unknown=True).num_classes()
                 max_seq_len: int = 25, start_idx: int = 91, padding_idx: int = 92,
                 encoder_drop: float = 0.1,  # Mlp encoder dropout (dino_vision.py:163)
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.arch = arch
        self.max_seq_len = max_seq_len
        self.padding_idx = padding_idx
        self.dtype = dtype
        self.backbone = VIT_ARCHS[arch](patch_size=patch_size,
                                        drop_path_rate=drop_path_rate, dtype=dtype)
        self.encoder = MlpEncoder(self.backbone.embed_dim, _ENCODER_WIDTH,
                                  _ENCODER_WIDTH, drop=encoder_drop, dtype=dtype)
        self.decoder = NRTRDecoder(
            n_layers=decoder_n_layers, d_embedding=decoder_d_embedding,
            n_head=decoder_n_head, d_k=decoder_d_k, d_v=decoder_d_v,
            d_model=decoder_d_model, d_inner=decoder_d_inner, n_position=200,
            dropout=decoder_dropout, num_classes=num_classes, max_seq_len=max_seq_len,
            start_idx=start_idx, padding_idx=padding_idx, d_enc=_ENCODER_WIDTH,
            dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter from the package's initialisers under
        ``generator`` (a CPU generator while the model is on the CPU)."""
        self.backbone.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        from ccd_tpu_torch.models.layers import init_dense_layers
        init_dense_layers(self.encoder, generator)

    def extract_feat(self, img: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, _ = self.backbone(img, generator, with_taps=False)
        return tokens

    def forward(self, img: torch.Tensor, targets: Optional[torch.Tensor] = None,
                train_mode: bool = True, test_speed: bool = False,
                generator: Optional[torch.Generator] = None):
        """img: (B, 32, 128, 3) NHWC normalized images.

        train_mode=True: requires ``targets`` (B, T) padded target ids;
        returns (logits (B, T, C-1), cross_attn (B, H, T, 256)).
        train_mode=False: returns greedy per-step softmax (B, T, C-1);
        test_speed=True uses the early-exit decode (forward_test_speed).
        Dropout and stochastic depth follow ``self.training``: in training
        mode ``generator`` draws every mask (and its absence is an error
        where a rate is non-zero); in evaluation mode nothing is drawn.

        Spans (``utils/tracing.py``): ``backbone``, ``encoder``, and
        ``decoder`` around the teacher-forced decoder; the greedy decodes
        open their own ``decode``.
        """
        with span("backbone"):
            feat = self.extract_feat(img, generator)
        with span("encoder"):
            out_enc = self.encoder(feat, generator)
        if train_mode:
            with span("decoder"):
                return self.decoder(out_enc, targets, train_mode=True, generator=generator)
        if test_speed:
            return self.decoder.decode_greedy_early_stop(out_enc)
        return self.decoder(out_enc, None, train_mode=False)
