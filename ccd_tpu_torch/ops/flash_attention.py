"""Packed multi-head attention: ``softmax((q+bq)(k+bk)^T * scale) (v+bv)``
per head, straight from the qkv projection ``(B, S, 3C)`` to ``(B, S, C)``.

Counterpart of ``ccd_tpu/ops/flash_attention.py::mha_packed_bias`` /
``mha_packed`` (the Pallas kernel ``_packed_fwd_kernel``). Channel order
within 3C is torch's qkv packing: ``[q h0..hH | k h0..hH | v h0..hH]``, each
head D wide (``vision_transformer.py:160-167``), so no transpose happens on
the way in or out.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/packed_attention.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``) or raises; there is no fallback. On a CPU tensor it computes
:func:`mha_packed_bias_plain`, the same arithmetic in plain PyTorch: fp32
logits and softmax, probabilities cast to the input type before ``p @ v``,
fp32 accumulation. (The kernel normalises by the fp32 row sum after the
second product rather than before the cast, which differs from the plain
version only by the rounding of ``p``.)

Bound on an H100, for the ViT-Small evaluation shape (B, S, C, H) =
(288, 256, 384, 6) in bf16: the call must read 169.9 MB and write 56.6 MB,
0.068 ms at 3.35 TB/s, against 29.0 GFLOP, 0.029 ms at 989 TFLOP/s — bytes
bound it, so the kernel's job is to touch qkv and the output once and
nothing else. Forward only: the backward arrives with the training path.
"""

from __future__ import annotations

from typing import Optional

import torch

_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_ROW_TILE = 64                # S must be a multiple of this on the card
_HEAD_DIMS = (32, 64)
# what packed_attention_forward returns besides CUDA's own (positive) error codes
_REFUSALS = {-1: "unsupported head dim",
             -2: "S too large: one head's K and V do not fit in shared memory"}


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


def mha_packed_bias_plain(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                          scale: float, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, any device: (B, S, 3C) -> (B, S, C)."""
    _check(qkv, bias, heads)
    b, s, c3 = qkv.shape
    c = c3 // 3
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = qkv.view(b, s, 3, heads, c // heads).permute(2, 0, 3, 1, 4)  # (B,H,S,D)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # fp32 accumulation
    return out.permute(0, 2, 1, 3).reshape(b, s, c)


def _launch(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
            heads: int) -> torch.Tensor:
    import ctypes

    from ccd_tpu_torch.ops._build import load_library

    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {_HEAD_DIMS})")
    if s % _ROW_TILE != 0:
        raise ValueError(f"S = {s} must be a multiple of {_ROW_TILE}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        raise NotImplementedError("the packed-attention kernel is forward only; "
                                  "call it under torch.no_grad()")
    if bias is not None:
        bias = bias.detach().to(qkv.dtype).contiguous()
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    for name, t in (("qkv", qkv), ("bias", bias), ("out", out)):
        if t is not None and t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} is not 16-byte aligned")

    lib = load_library("packed_attention")
    fn = lib.packed_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), b, s, heads, d, int(qkv.dtype == torch.bfloat16),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"packed_attention_forward refused or failed at launch: "
                           f"{_REFUSALS.get(err, f'CUDA error {err}')} "
                           f"(qkv {tuple(qkv.shape)} {qkv.dtype}, heads {heads})")
    mha_packed_bias.launches += 1
    return out


def mha_packed_bias(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
                    heads: int) -> torch.Tensor:
    """Fused attention on the raw UNBIASED qkv projection (B, S, 3C) plus its
    bias (3C,) (or None) -> (B, S, C). The bias add happens inside the kernel.

    ``mha_packed_bias.launches`` counts kernel launches (and nothing else)."""
    _check(qkv, bias, heads)
    if qkv.device.type == "cpu":
        return mha_packed_bias_plain(qkv, bias, scale, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    return _launch(qkv, bias, scale, heads)


mha_packed_bias.launches = 0


def mha_packed(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """Fused attention on the raw (already-biased) qkv projection
    (B, S, 3C) -> (B, S, C)."""
    return mha_packed_bias(qkv, None, scale, heads)
