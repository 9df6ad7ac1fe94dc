"""Vision Transformer backbone for 32x128 scene-text images.

Parity target: ``Dino/modules/vision_transformer.py`` — a DINO/timm-style ViT
adapted for text: rectangular patch grid (patch 4 -> 8x32 = 256 tokens), NO
CLS token, bicubic pos-embed resampling (the reference stores the table on a
16x16 grid and always resamples it to the 8x32 text grid with
``scale_factor=((gh+0.1)/16, (gw+0.1)/16)`` — reproduced exactly for
checkpoint parity), stochastic depth, LayerNormed intermediate feature
taps at blocks ``out_indices`` reshaped to the 2-D grid for the seg head,
optional recomputation of each block in the backward (``remat``), and the
last block's attention probabilities (``get_last_selfattention``).

Counterpart of ``ccd_tpu/models/vit.py``: NHWC images at the public
functions, fp32 params with a configurable compute dtype, exact (erf) GELU
in fp32 and tanh GELU in bf16, fp32 softmax. Parameter names are the
reference's, so its checkpoints load by name.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ccd_tpu_torch.models.layers import (Dense, Dropout, LayerNorm, init_dense_layers, keep_mask,
                                         lecun_normal_, trunc_normal_)
from ccd_tpu_torch.ops.activations import gelu as _gelu
from ccd_tpu_torch.ops.flash_attention import mha_packed, mha_packed_bias
from ccd_tpu_torch.ops.image import resize_bicubic


class DropPath(nn.Module):
    """Per-sample stochastic depth (``drop_path`` in the reference)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return x / (1.0 - self.rate) * keep_mask(x, self.rate, shape, generator)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop(_gelu(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


class Attention(nn.Module):
    """Self-attention through the packed kernel: the qkv projection is left
    un-biased and the kernel adds the bias as it loads q, k and v, so the
    (B, N, 3C) projection is read once and the (B, H, N, N) probabilities
    never reach device memory.

    ``need_weights=True`` returns ``(out, probabilities (B, H, N, N))``: the
    JAX package's own non-Pallas branch (ccd_tpu/models/vit.py:124-132),
    softmax in fp32 and then cast to the compute type. The probabilities
    must reach memory there, so this branch is plain torch, as it is plain
    XLA in the JAX package; it is no fallback from the kernel, which the
    main path (``need_weights=False``) always takes.
    """

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_drop != 0.0:
            raise NotImplementedError("the packed attention kernel has no dropout on "
                                      "the probabilities; every shipped config uses 0")
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = Dropout(proj_drop)

    def qkv_unbiased(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(x @ W_qkv^T, bias)`` WITHOUT adding the bias."""
        qkv = F.linear(x.to(self.qkv.dtype), self.qkv.cast_param("weight"))
        return qkv, self.qkv.cast_param("bias")

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                need_weights: bool = False):
        qkv, bias = self.qkv_unbiased(x)
        if need_weights:
            out, attn = self._with_weights(qkv, bias)
            return self.proj_drop(self.proj(out), generator), attn
        if bias is None:
            out = mha_packed(qkv, self.scale, self.num_heads)  # (B, N, C)
        else:
            out = mha_packed_bias(qkv, bias, self.scale, self.num_heads)
        return self.proj_drop(self.proj(out), generator)

    def _with_weights(self, qkv: torch.Tensor, bias: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out (B, N, C), probabilities (B, H, N, N)) in the compute type."""
        if bias is not None:
            qkv = qkv + bias
        b, n, c3 = qkv.shape
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, c3 // (3 * self.num_heads)).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
        attn = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, c3 // 3)
        return out, attn


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_eps, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_attention: bool = False):
        """``return_attention``: also return the attention's probabilities
        (``Attention(need_weights=True)``), as ``(x, attn)``."""
        if return_attention:
            y, attn = self.attn(self.norm1(x), generator, need_weights=True)
        else:
            y = self.attn(self.norm1(x), generator)
        x = x + self.drop_path(y, generator)
        x = x + self.drop_path(self.mlp(self.norm2(x), generator), generator)
        return (x, attn) if return_attention else x


def remat_block(block: nn.Module, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, generator)`` whose activations are recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant) instead of kept:
    Flax's ``nn.remat(Block)``. The attention goes through its kernel in both
    passes, and the recompute's forward saves its log-sum-exp for the
    backward as the first pass does.

    Dropout and drop path draw from ``generator``, which ``checkpoint``'s
    ``preserve_rng_state`` does not cover (it restores torch's global
    generators only). So both passes draw from a fresh generator set to the
    state ``generator`` had before the block, and ``generator`` is then moved
    to where the first pass left it: the same masks in both passes, and the
    same draws, in the same order, as without remat."""
    if generator is None:
        return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
    before = generator.get_state()
    first_pass = []

    def run(tokens):
        replay = torch.Generator(device=generator.device)
        replay.set_state(before)
        out = block(tokens, replay)
        first_pass.append(replay)
        return out

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(first_pass[0].get_state())
    return out


class PatchEmbed(nn.Module):
    """Patch projection. Kernel size equals stride, so the convolution is one
    matrix product over flattened patches and is computed as such: a fp32
    product stays full fp32 on the card (a fp32 cuDNN convolution would run
    in TF32 by default). The weight keeps the reference's conv layout
    ``(out, in, kh, kw)``."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 768, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, H, W, C) NHWC
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = x.to(self.dtype).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(
            patches.reshape(b, gh * gw, p * p * c), weight.to(self.dtype),
            self.proj.bias.to(self.dtype))


class VisionTransformer(nn.Module):
    """No-CLS rectangular-grid ViT with intermediate seg-feature taps."""

    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: int = 4,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (2, 4, 6), ln_eps: float = 1e-6,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat  # recompute each block in the backward (remat_block)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.num_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                  dpr[i], ln_eps, dtype=dtype)
            for i in range(depth)])
        self.norm = LayerNorm(embed_dim, ln_eps, dtype)
        # one LayerNorm per tapped block (reference `norm_seg` Sequential of 3)
        self.norm_seg = nn.ModuleList([LayerNorm(embed_dim, ln_eps, dtype)
                                       for _ in self.out_indices])
        self._pos_cache = None  # (key, resampled table), evaluation only
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initialisers: truncated normal (std 0.02) for the
        Dense weights and the pos-embed table, LeCun normal for the patch
        projection, zero biases."""
        init_dense_layers(self, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        conv = self.patch_embed.proj
        fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
        lecun_normal_(conv.weight, fan_in, generator)
        nn.init.zeros_(conv.bias)

    def _interpolate_pos_encoding(self, npatch: int, h_img: int, w_img: int) -> torch.Tensor:
        """Reference-exact pos-embed resampling (vision_transformer.py:182-201).

        The (1, N, E) table is viewed as a sqrt(N) x sqrt(N) grid and
        bicubic-resampled to the actual patch grid with torch's
        scale_factor=( (gh+0.1)/s, (gw+0.1)/s ) coordinate mapping. Skipped
        only when npatch == N AND the image is square. Outside autograd the
        result is constant until the table changes, so it is computed once
        and kept.
        """
        n = self.pos_embed.shape[1]
        if npatch == n and h_img == w_img:
            return self.pos_embed
        key = (self.pos_embed._version, self.pos_embed.device, h_img, w_img)
        cacheable = not torch.is_grad_enabled()
        if cacheable and self._pos_cache is not None and self._pos_cache[0] == key:
            return self._pos_cache[1]
        gh = h_img // self.patch_size
        gw = w_img // self.patch_size
        s = int(math.sqrt(n))
        grid = self.pos_embed.reshape(1, s, s, self.embed_dim)
        out = resize_bicubic(grid, (gh, gw), scale=((gh + 0.1) / s, (gw + 0.1) / s))
        out = out.reshape(1, gh * gw, self.embed_dim)
        if cacheable:
            self._pos_cache = (key, out.detach())
        return out

    def prepare_tokens(self, x: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        tokens = self.patch_embed(x)
        tokens = tokens + self._interpolate_pos_encoding(tokens.shape[1], h, w).to(tokens.dtype)
        return self.pos_drop(tokens, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                with_taps: bool = True) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, H, W, 3) NHWC -> (tokens (B, N, E), [3x (B, gh, gw, E) taps]).

        ``with_taps=False``: the ``norm_seg`` taps are not computed and the
        list is empty (for callers with no seg head to read them: the
        recognizer, the pretraining teacher); the tokens are the same."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        tokens = self.prepare_tokens(x, generator)
        taps = []
        remat = self.remat and torch.is_grad_enabled()
        for index, blk in enumerate(self.blocks):
            tokens = remat_block(blk, tokens, generator) if remat else blk(tokens, generator)
            if with_taps and index + 1 in self.out_indices:
                tap = self.norm_seg[len(taps)](tokens)
                taps.append(tap.reshape(b, gh, gw, self.embed_dim))
        return self.norm(tokens), taps

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's attention probabilities (B, H, N, N) for NHWC
        images, without dropout or drop path whatever the module's mode (the
        JAX package's ``deterministic=True``)."""
        was_training = self.training
        self.train(False)
        try:
            tokens = self.prepare_tokens(x)
            for blk in self.blocks[:-1]:
                tokens = blk(tokens)
            return self.blocks[-1](tokens, return_attention=True)[1]
        finally:
            self.train(was_training)


# reference variants (vision_transformer.py:273-291) — note the non-standard
# 512-dim / 8-head "base"
vit_micro = partial(VisionTransformer, embed_dim=64, depth=3, num_heads=2,
                    mlp_ratio=4.0, qkv_bias=True,
                    out_indices=(1, 2, 3))  # test/dry-run scale only
vit_tiny = partial(VisionTransformer, embed_dim=192, depth=12, num_heads=3,
                   mlp_ratio=4.0, qkv_bias=True)
vit_small = partial(VisionTransformer, embed_dim=384, depth=12, num_heads=6,
                    mlp_ratio=4.0, qkv_bias=True)
vit_base = partial(VisionTransformer, embed_dim=512, depth=12, num_heads=8,
                   mlp_ratio=4.0, qkv_bias=True)

VIT_ARCHS = {"vit_micro": vit_micro, "vit_tiny": vit_tiny,
             "vit_small": vit_small, "vit_base": vit_base}
