"""NRTR transformer decoder for autoregressive text recognition.

Parity targets: ``Dino/decoder/nrtr_decoder.py`` (+ ``transformer_layers.py``,
``transformer_module.py``): 6 pre-norm decoder layers (self-attn, cross-attn,
FFN; separate q/k/v linears with d_k=d_v=64, no biases), char embedding,
sinusoid positional encoding, causal+pad target masks, and a classifier over
``num_classes - 1`` outputs (PAD is never predicted).

Counterpart of ``ccd_tpu/models/nrtr.py``. The reference greedily re-runs the
FULL decoder at every one of the 25 steps (``nrtr_decoder.py:151-175``). Here
greedy decoding is a Python loop over steps with per-layer KV caches that are
updated in place — exactly output-equivalent (causal masking + the fact that
PAD can never be produced make incremental decoding identical in exact
arithmetic) at ~T x less compute. Everything here is plain ``torch`` calls:
the JAX package runs the decoder outside any hand-written kernel too.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ccd_tpu_torch.models.layers import Dense, LayerNorm, init_dense_layers
from ccd_tpu_torch.ops.activations import gelu as _gelu

_NEG_INF = -1e30


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """(1, n_position, d_hid) sinusoid table (transformer_module.py:141-153)."""
    denom = np.array([1.0 / np.power(10000, 2 * (j // 2) / d_hid) for j in range(d_hid)])
    table = np.arange(n_position)[:, None].astype(np.float64) * denom[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table[None].astype(np.float32)


class MultiHeadAttention(nn.Module):
    """Separate-q/k/v multi-head attention (transformer_module.py:35-97).

    ``d_kv_in`` is the width of the key/value input: ``d_model`` for
    self-attention, the encoder's output width for cross-attention (Flax
    infers it; ``nn.Linear`` needs it stated)."""

    def __init__(self, n_head: int = 8, d_k: int = 64, d_v: int = 64,
                 d_model: int = 512, dropout: float = 0.1, qkv_bias: bool = False,
                 d_kv_in: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        d_kv_in = d_model if d_kv_in is None else d_kv_in
        self.linear_q = Dense(d_model, n_head * d_k, bias=qkv_bias, dtype=dtype)
        self.linear_k = Dense(d_kv_in, n_head * d_k, bias=qkv_bias, dtype=dtype)
        self.linear_v = Dense(d_kv_in, n_head * d_v, bias=qkv_bias, dtype=dtype)
        self.fc = Dense(n_head * d_v, d_model, bias=qkv_bias, dtype=dtype)
        self.attn_drop = nn.Dropout(dropout)
        self.proj_drop = nn.Dropout(dropout)

    def q_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return self.linear_q(x).reshape(b, l, self.n_head, self.d_k)

    def k_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return self.linear_k(x).reshape(b, l, self.n_head, self.d_k)

    def v_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return self.linear_v(x).reshape(b, l, self.n_head, self.d_v)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """q: (B,Lq,H,dk), k/v: (B,Lk,H,d*), mask bool (broadcastable to
        (B,H,Lq,Lk), True=keep) -> (out (B,Lq,H,dv), attn (B,H,Lq,Lk))."""
        return self.attend_head_major(q, k.transpose(1, 2), v.transpose(1, 2), mask)

    def attend_head_major(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`attend` with keys and values head-major, (B,H,Lk,d*). The
        batched products read them in place when they are contiguous in that
        layout, which is how the greedy decode keeps them: in (B,Lk,H,d*)
        layout every step would copy them per head first."""
        scores = torch.matmul(q.transpose(1, 2), k.transpose(-1, -2)) / (self.d_k ** 0.5)
        if mask is not None:
            scores = scores.masked_fill(~mask, _NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        attn = self.attn_drop(attn)
        out = torch.matmul(attn, v).transpose(1, 2)  # (B,Lq,H,dv)
        return out, attn

    def out_proj(self, out: torch.Tensor) -> torch.Tensor:
        b, l = out.shape[:2]
        return self.proj_drop(self.fc(out.reshape(b, l, self.n_head * self.d_v)))

    def forward(self, q_in, k_in, v_in, mask=None):
        out, attn = self.attend(self.q_heads(q_in), self.k_heads(k_in),
                                self.v_heads(v_in), mask)
        return self.out_proj(out), attn


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_inner: int, d_model: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_1 = Dense(d_model, d_inner, dtype=dtype)
        self.w_2 = Dense(d_inner, d_model, dtype=dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.w_2(_gelu(self.w_1(x))))


class TFDecoderLayer(nn.Module):
    """Pre-norm decoder layer (transformer_layers.py:149-162 order)."""

    def __init__(self, d_model: int = 512, d_inner: int = 256, n_head: int = 8,
                 d_k: int = 64, d_v: int = 64, dropout: float = 0.1,
                 qkv_bias: bool = False, d_enc: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(d_model, 1e-5, dtype)
        self.norm2 = LayerNorm(d_model, 1e-5, dtype)
        self.norm3 = LayerNorm(d_model, 1e-5, dtype)
        self.self_attn = MultiHeadAttention(n_head, d_k, d_v, d_model, dropout,
                                            qkv_bias, dtype=dtype)
        self.enc_attn = MultiHeadAttention(n_head, d_k, d_v, d_model, dropout,
                                           qkv_bias, d_kv_in=d_enc, dtype=dtype)
        self.mlp = PositionwiseFeedForward(d_inner, d_model, dropout, dtype=dtype)

    def forward(self, x, enc, self_mask=None, enc_mask=None):
        n = self.norm1(x)
        sa = self.self_attn
        a, _ = sa.attend(sa.q_heads(n), sa.k_heads(n), sa.v_heads(n), self_mask)
        x = x + sa.out_proj(a)
        n = self.norm2(x)
        ea = self.enc_attn
        a, attn = ea.attend(ea.q_heads(n), ea.k_heads(enc), ea.v_heads(enc), enc_mask)
        x = x + ea.out_proj(a)
        x = x + self.mlp(self.norm3(x))
        return x, attn

    def step(self, x, cache_k, cache_v, t: int, enc_k, enc_v, key_mask):
        """Incremental step: x (B,1,D) at position t with per-layer KV cache.

        cache_k/v and enc_k/v are head-major, (B, H, L, d*). Position t of the
        cache is written IN PLACE, keys > t are masked.
        """
        n = self.norm1(x)
        sa = self.self_attn
        cache_k[:, :, t] = sa.k_heads(n)[:, 0]
        cache_v[:, :, t] = sa.v_heads(n)[:, 0]
        a, _ = sa.attend_head_major(sa.q_heads(n), cache_k, cache_v, key_mask)
        x = x + sa.out_proj(a)
        n = self.norm2(x)
        a, _ = self.enc_attn.attend_head_major(self.enc_attn.q_heads(n), enc_k, enc_v, None)
        x = x + self.enc_attn.out_proj(a)
        return x + self.mlp(self.norm3(x))


class NRTRDecoder(nn.Module):
    def __init__(self, n_layers: int = 6, d_embedding: int = 512, n_head: int = 8,
                 d_k: int = 64, d_v: int = 64, d_model: int = 512, d_inner: int = 256,
                 n_position: int = 200, dropout: float = 0.1, num_classes: int = 93,
                 max_seq_len: int = 25, start_idx: int = 91, padding_idx: int = 92,
                 d_enc: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.n_head, self.d_k, self.d_v = n_layers, n_head, d_k, d_v
        self.num_classes, self.max_seq_len = num_classes, max_seq_len
        self.start_idx, self.padding_idx = start_idx, padding_idx
        self.dtype = dtype
        # a plain table over all ids: no padding_idx semantics
        self.trg_word_emb = nn.Embedding(num_classes, d_embedding)
        self.register_buffer(
            "pos_table", torch.from_numpy(sinusoid_table(n_position, d_embedding)),
            persistent=False)
        self.emb_drop = nn.Dropout(dropout)
        self.layer_stack = nn.ModuleList([
            TFDecoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout, d_enc=d_enc,
                           dtype=dtype)
            for _ in range(n_layers)])
        self.layer_norm = LayerNorm(d_model, 1e-6, dtype)
        # PAD is assumed and never predicted (nrtr_decoder.py:76-77)
        self.classifier = Dense(d_model, num_classes - 1, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_layers(self, generator)
        with torch.no_grad():
            self.trg_word_emb.weight.normal_(0.0, 1.0, generator=generator)

    @property
    def end_token_id(self) -> int:
        # BOS/EOS share an id in the default convertor layout (id 91)
        return self.start_idx

    def forward(self, out_enc, targets=None, train_mode: bool = True):
        if train_mode:
            return self.forward_train(out_enc, targets)
        return self.decode_greedy(out_enc)

    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return self.trg_word_emb(tokens).to(self.dtype) + pos.to(self.dtype)

    # ------------------------------------------------------------- train
    def forward_train(self, out_enc: torch.Tensor, targets: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decode: (B, S, Dm) enc + (B, T) targets -> (B, T, C-1)."""
        b, t = targets.shape
        x = self.emb_drop(self._embed(targets, self.pos_table[:, :t]))

        pad_mask = (targets != self.padding_idx)[:, None, None, :]  # key mask
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=targets.device))[None, None]
        self_mask = pad_mask & causal

        attn = None
        for layer in self.layer_stack:
            x, attn = layer(x, out_enc, self_mask, None)
        return self.classifier(self.layer_norm(x)), attn

    # ------------------------------------------------------------- greedy
    def _decode_state(self, out_enc: torch.Tensor):
        """Cross-attention keys/values per layer, zeroed self-attention caches
        of length max_seq_len + 1 (all head-major, (B, H, L, d*), contiguous),
        the start tokens and the key positions."""
        b = out_enc.shape[0]
        l = self.max_seq_len + 1
        dev = out_enc.device
        enc_kvs = [(lyr.enc_attn.k_heads(out_enc).transpose(1, 2).contiguous(),
                    lyr.enc_attn.v_heads(out_enc).transpose(1, 2).contiguous())
                   for lyr in self.layer_stack]
        caches = [(torch.zeros((b, self.n_head, l, self.d_k), dtype=self.dtype, device=dev),
                   torch.zeros((b, self.n_head, l, self.d_v), dtype=self.dtype, device=dev))
                  for _ in self.layer_stack]
        tok = torch.full((b,), self.start_idx, dtype=torch.long, device=dev)
        positions = torch.arange(l, device=dev)
        return enc_kvs, caches, tok, positions

    def _decode_step(self, tok, t: int, enc_kvs, caches, positions
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One greedy step at position t -> (fp32 softmax (B, C-1), next tokens)."""
        x = self._embed(tok, self.pos_table[:, t])[:, None]  # (B, 1, E)
        key_mask = (positions <= t)[None, None, None, :]
        for layer, (ck, cv), (ek, ev) in zip(self.layer_stack, caches, enc_kvs):
            x = layer.step(x, ck, cv, t, ek, ev, key_mask)
        x = self.layer_norm(x)
        probs = torch.softmax(self.classifier(x[:, 0]).float(), dim=-1)
        return probs, probs.argmax(dim=-1)

    def decode_greedy(self, out_enc: torch.Tensor) -> torch.Tensor:
        """KV-cached greedy decode -> (B, max_seq_len, C-1) per-step softmax, fp32.

        Output-equivalent to the reference full-recompute loop
        (nrtr_decoder.py:151-175): the reference seeds [BOS, PAD, ...] and the
        pad+causal mask restricts position t to keys <= t that are non-PAD;
        generated tokens can never be PAD (classifier has no PAD output), so
        incremental decoding attends to exactly the same keys.
        """
        enc_kvs, caches, tok, positions = self._decode_state(out_enc)
        steps: List[torch.Tensor] = []
        for t in range(self.max_seq_len):
            probs, tok = self._decode_step(tok, t, enc_kvs, caches, positions)
            steps.append(probs)
        return torch.stack(steps, dim=1)  # (B, T, C-1)

    def decode_greedy_early_stop(self, out_enc: torch.Tensor) -> torch.Tensor:
        """Early-exit greedy decode (the ``forward_test_speed`` counterpart,
        nrtr_decoder.py:177-203): stops as soon as every sequence in the batch
        has emitted EOS (a saner stopping rule than the reference's
        batch-global argmax check). Output is the same fixed
        (B, max_seq_len, C-1) buffer; steps after the stop stay zero.

        Observable difference vs the reference rule: NONE at b=1 (both stop at
        the first EOS). For b>1 this variant runs until every row has emitted
        EOS, so rows never truncate early but trailing positions of short rows
        stay zero. The stopping test reads a flag back from the device, one
        host synchronisation per step; that is accepted on this
        ``--test_speed``-only path. The default eval path uses the exact full
        decode and is unaffected.
        """
        enc_kvs, caches, tok, positions = self._decode_state(out_enc)
        b = out_enc.shape[0]
        probs_buf = torch.zeros((b, self.max_seq_len, self.num_classes - 1),
                                dtype=torch.float32, device=out_enc.device)
        done = torch.zeros((b,), dtype=torch.bool, device=out_enc.device)
        for t in range(self.max_seq_len):
            probs, tok = self._decode_step(tok, t, enc_kvs, caches, positions)
            probs_buf[:, t] = probs
            done |= tok == self.end_token_id
            if bool(done.all()):
                break
        return probs_buf
