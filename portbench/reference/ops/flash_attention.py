"""Packed multi-head attention (K1) in plain PyTorch: the port's
``mha_packed_bias_plain`` and ``mha_packed_bias_bwd_plain`` under one
autograd Function, as the port runs them on the CPU. Nothing of size S x S is
saved: the backward recomputes the probabilities from each row's
log-sum-exp."""

from __future__ import annotations

import math
from typing import Optional

import torch

_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_LOG2E = math.log2(math.e)


def _check(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int) -> None:
    if qkv.ndim != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"qkv must be (B, S, 3C), got {tuple(qkv.shape)}")
    c = qkv.shape[-1] // 3
    if heads <= 0 or c % heads != 0:
        raise ValueError(f"C = {c} is not divisible by heads = {heads}")
    if qkv.dtype not in _SUPPORTED_DTYPES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if bias is not None:
        if bias.shape != (3 * c,):
            raise ValueError(f"bias must be ({3 * c},), got {tuple(bias.shape)}")
        if bias.device != qkv.device:
            raise ValueError(f"bias on {bias.device}, qkv on {qkv.device}")




def _split_heads(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int):
    """(B, H, S, D) views of q + bq (rounded once to the input type, as the
    kernels round it), k and v without their biases, and bv (1, H, 1, D) in
    the input type or None."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    if bias is None:
        return q, k, v, None
    bq, _, bv = bias.to(qkv.dtype).view(3, 1, heads, 1, d)
    return q + bq, k, v, bv




def _lse_plain(logits: torch.Tensor) -> torch.Tensor:
    """Base-2 log-sum-exp over the last axis of fp32 natural-unit logits."""
    return torch.logsumexp(logits, dim=-1) * _LOG2E




def mha_packed_bias_plain(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                          scale: float, heads: int, *, return_lse: bool = False):
    """Plain PyTorch version of the kernel, any device: (B, S, 3C) -> (B, S, C).
    ``return_lse``: also each row's base-2 log-sum-exp (B, H, S) fp32 of the
    logits without the key bias, as the kernel saves it for the backward."""
    _check(qkv, bias, heads)
    b, s, c3 = qkv.shape
    c = c3 // 3
    biased = qkv if bias is None else qkv + bias.to(qkv.dtype)
    q, k, v = biased.view(b, s, 3, heads, c // heads).permute(2, 0, 3, 1, 4)  # (B,H,S,D)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # fp32 accumulation
    out = out.permute(0, 2, 1, 3).reshape(b, s, c)
    if not return_lse:
        return out
    if bias is not None:  # the logits again, without bk
        qb, k, _, _ = _split_heads(qkv, bias, heads)
        logits = torch.matmul(qb.float(), k.float().transpose(-1, -2)) * scale
    return out, _lse_plain(logits)




def _bwd_plain(q, k, v, o, do, lse, scale: float, dtype):
    """The backward's arithmetic on fp32 (.., S, D) operands: q with bq, k and
    v without their biases, o the output less bv, do its cotangent, lse
    (.., S). Returns fp32 (dq, dk, dv) before their rounding to ``dtype``."""
    p = torch.exp2(torch.matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E) - lse.unsqueeze(-1))
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (do * o).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dtype).float()
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.to(dtype).float().transpose(-1, -2), do))




def mha_packed_bias_bwd_plain(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                              dout: torch.Tensor, scale: float, heads: int, *,
                              out: Optional[torch.Tensor] = None,
                              lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, any device: the cotangent
    ``dqkv`` (B, S, 3C) of the un-biased projection, from ``dout`` (B, S, C),
    the forward's output ``out`` and its saved ``lse`` (computed here by the
    plain forward when not given). The algebra and the rounding points are
    the kernel's (module docstring)."""
    _check(qkv, bias, heads)
    if out is None or lse is None:
        out, lse = mha_packed_bias_plain(qkv, bias, scale, heads, return_lse=True)
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v, bv = _split_heads(qkv, bias, heads)
    o = out.view(b, s, heads, d).permute(0, 2, 1, 3).float()
    if bv is not None:
        o = o - bv.float()
    do = dout.view(b, s, heads, d).permute(0, 2, 1, 3).float()
    grads = _bwd_plain(q.float(), k.float(), v.float(), o, do, lse, scale, qkv.dtype)
    dqkv = torch.stack(grads).to(qkv.dtype)                             # (3,B,H,S,D)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, s, c3)




class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, scale, heads):
        out, lse = mha_packed_bias_plain(qkv, bias, scale, heads, return_lse=True)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.scale, ctx.heads = scale, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv = mha_packed_bias_bwd_plain(qkv, bias, dout, ctx.scale, ctx.heads, out=out, lse=lse)
        dbias = None
        if bias is not None and ctx.needs_input_grad[1]:
            dbias = dqkv.float().sum((0, 1)).to(bias.dtype)
        return dqkv, dbias, None, None


def mha_packed_bias(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
                    heads: int) -> torch.Tensor:
    """Attention on the unbiased qkv projection (B, S, 3C) plus its bias (3C,)
    (or None) -> (B, S, C); differentiable with respect to qkv and bias."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (qkv, bias)):
        return _PackedAttention.apply(qkv, bias, scale, heads)
    return mha_packed_bias_plain(qkv, bias, scale, heads)


def mha_packed(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    return mha_packed_bias(qkv, None, scale, heads)
