"""Multi-head attention with its gradient, in two layouts over one pair of
kernels.

* Packed (K1): ``softmax((q+bq)(k+bk)^T * scale) (v+bv)`` per head, straight
  from the qkv projection ``(B, S, 3C)`` to ``(B, S, C)``: :func:`mha_packed_bias`,
  :func:`mha_packed`, :func:`mha_packed_bias_bwd`.
* Folded or head-split (K1b): ``softmax(q k^T * scale) v`` on ``(B*H, S, D)``
  tensors (:func:`flash_attention`, :func:`flash_attention_bwd`) or on
  ``(B, S, H, D)`` tensors (:func:`mha`), read and written where they lie:
  counterparts of ``ccd_tpu/ops/flash_attention.py::flash_attention`` /
  ``mha`` (the Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel``). The JAX
  ``mha`` transposes q, k, v into the folded layout and the output back; here
  the kernels take strides and no transpose happens.

The CUDA kernels take every operand as a base pointer with a batch stride, a
row stride and a per-head column offset, so both layouts run the same device
code through two C entries per direction.

Counterpart of ``ccd_tpu/ops/flash_attention.py::mha_packed_bias`` /
``mha_packed`` (the Pallas kernels ``_packed_fwd_kernel`` and
``_packed_bwd_kernel`` under one custom VJP). Channel order within 3C is
torch's qkv packing: ``[q h0..hH | k h0..hH | v h0..hH]``, each head D wide
(``vision_transformer.py:160-167``), so no transpose happens on the way in or
out, in either direction: the backward emits the ``(B, S, 3C)`` cotangent of
the projection's output as it stands.

On a CUDA tensor the wrapper launches the hand-written Hopper kernels in
``csrc/packed_attention.cu`` and ``csrc/packed_attention_bwd.cu`` (built with
``nvcc`` at first use, bound with ``ctypes``) or raises; there is no
fallback. On a CPU tensor it computes :func:`mha_packed_bias_plain` and
:func:`mha_packed_bias_bwd_plain`, the same arithmetic in plain PyTorch: fp32
logits and softmax, probabilities cast to the input type before ``p @ v``,
fp32 accumulation; in the backward ``ds`` cast to the input type before the
``dq``/``dk`` products and ``p`` before ``dv``.

When a gradient is wanted the forward also returns each row's log-sum-exp
``lse`` (B, H, S) fp32, in the kernels' units: ``log2(sum_j 2^x_ij)`` with
``x_ij = (q_i + bq) . k_j * scale * log2(e)``, the key bias left out (the
softmax cancels it). The autograd Functions save the inputs, the output and
``lse`` (nothing of size S x S), and the backward reads them instead of
recomputing the softmax: ``p = 2^(x - lse)``, ``delta = rowsum(dO * (out -
bv))``, ``dP = dO v^T`` without bv, ``dq = dS k`` without bk and ``dk = dS^T
(q + bq)``. Leaving bk and bv out is exact in real arithmetic (bk's term in
dq is ``(sum_j dS_ij) bk``, and that sum is 0; bv cancels in ``dP - delta``),
and the plain backward does the same algebra.

The bf16 forward kernel (``wgmma`` products, K and V streamed through a ring
of shared-memory stages by asynchronous copies) differs from the plain
version only in where it rounds: it normalises by the fp32 row sum after the
second product rather than before the cast of ``p``, and it folds the bias
in algebraically, exact in real arithmetic: ``q + bq`` rounded once as here,
``bk`` dropped (it adds ``(q + bq) . bk`` to every logit of a row, which the
softmax cancels), ``bv`` added after the normalisation (each row of ``p``
sums to 1), where the plain version rounds ``k + bk`` and ``v + bv`` to the
input type first. The bf16 backward kernels (``wgmma``, the same ring, seven
tile products, deterministic) differ from the plain backward in the same
way only: where they sum and where the exponential rounds.

Bound on an H100 in bf16, bytes in both directions: at the ViT-Small
evaluation shape (B, S, C, H) = (288, 256, 384, 6) the forward must read
169.9 MB and write 56.6 MB, 0.068 ms at 3.35 TB/s, against 29.0 GFLOP,
0.029 ms at 989 TFLOP/s; at the pretraining shape B = 128 the backward must
read qkv and dO and write dqkv, 176.2 MB, 0.053 ms, against 32.2 GFLOP,
0.033 ms (the saved output and lse add 26.0 MB of reads). So the kernels' job
is to touch qkv, dO, dqkv and the output once and nothing else.

In fp32 (exact, no TF32) the bound is the fp32 pipe's 67 TFLOP/s: 0.433 ms
for the forward at the evaluation shape, 0.481 ms for the backward's five
products at the pretraining shape. The fp32 kernels (``attention_f32.cuh``)
are register-tiled on that pipe, add bq and bv as they stage q and v (one
fp32 add, as here) and drop bk; they differ from the plain version only in
the order of their sums and in the exponential's rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ccd_tpu_torch.ops._build import kernel_attributes

_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_ROW_TILE = 64                # S must be a multiple of this on the card
_HEAD_DIMS = (32, 64)
_MAX_BATCH = 65535            # the grid's z extent carries the batch
_LOG2E = math.log2(math.e)    # lse is kept in base 2, as the kernels keep their logits
# what the C entry points return besides CUDA's own (positive) error codes
_REFUSALS = {-1: "unsupported head dim",
             -3: f"batch too large for the grid (at most {_MAX_BATCH})"}


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


def _check_batch(b: int) -> None:
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} too large for the kernels' grid (at most {_MAX_BATCH})")


def _kernel_args(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int):
    """Checks what the kernels do not take; returns the bias as they want it."""
    d = qkv.shape[-1] // 3 // heads
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {_HEAD_DIMS})")
    if qkv.shape[1] % _ROW_TILE != 0:
        raise ValueError(f"S = {qkv.shape[1]} must be a multiple of {_ROW_TILE}")
    _check_batch(qkv.shape[0])
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if bias is not None:
        bias = bias.to(qkv.dtype).contiguous()
    return bias


_entries = {}  # (library, entry) -> its ctypes function, argument types set


def _entry(library: str, entry: str, pointers: int):
    fn = _entries.get((library, entry))
    if fn is None:
        import ctypes

        from ccd_tpu_torch.ops._build import load_library

        fn = getattr(load_library(library), entry)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[(library, entry)] = fn
    return fn


def _c_call(entry: str, library: str, tensors, dims, scale: float, device: torch.device,
            strides=None, what=lambda: "") -> None:
    """Launch C entry point ``entry`` of ``csrc/<library>.cu`` on the current
    stream: the pointers of ``tensors`` ((name, tensor or None) pairs), then
    the host array of ``strides`` (int64 element strides) where given, then
    ``dims`` (B, S, H, D), is_bf16, scale, stream. ``what()`` describes the
    call in an error. Kept lean: the host time of a call is paid on every
    launch and the steps that make them are host-bound."""
    args, dtype = [], None
    for name, t in tensors:
        if t is None:
            args.append(None)
            continue
        ptr = t.data_ptr()
        if ptr % 16 != 0:
            raise ValueError(f"{name} is not 16-byte aligned")
        args.append(ptr)
        dtype = dtype or t.dtype
    if strides is not None:
        import ctypes
        args.append((ctypes.c_longlong * len(strides))(*strides))
    fn = _entry(library, entry, len(args))
    index = device.index
    # the raw handle of the device's current stream (what Triton's launcher
    # reads): torch.cuda.current_stream() builds a Python object per call
    args += [*dims, int(dtype == torch.bfloat16), float(scale),
             torch._C._cuda_getCurrentRawStream(index)]
    if torch.cuda.current_device() == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry} refused or failed at launch: "
                           f"{_REFUSALS.get(err, f'CUDA error {err}')} ({what()})")


def _call(entry: str, library: str, tensors, qkv: torch.Tensor, scale: float,
          heads: int) -> None:
    """Launch a packed entry point: the pointers of ``tensors``, then B, S,
    H, D, is_bf16, scale, stream."""
    b, s, c3 = qkv.shape
    _c_call(entry, library, tensors, (b, s, heads, c3 // 3 // heads), scale, qkv.device,
            what=lambda: f"qkv {tuple(qkv.shape)} {qkv.dtype}, heads {heads}")


def _launch(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
            heads: int, with_lse: bool = False):
    """The forward kernel; with ``with_lse`` also the rows' log-sum-exp."""
    bias = _kernel_args(qkv, bias, heads)
    b, s, c3 = qkv.shape
    out = torch.empty((b, s, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device) \
        if with_lse else None
    _call("packed_attention_forward", "packed_attention",
          (("qkv", qkv), ("bias", bias), ("out", out), ("lse", lse)), qkv, scale, heads)
    mha_packed_bias.launches += 1
    return (out, lse) if with_lse else out


def _check_saved(out: torch.Tensor, lse: torch.Tensor, out_shape, lse_shape,
                 like: torch.Tensor) -> None:
    """The forward's output and log-sum-exp, as the backward kernels take them."""
    if out.shape != out_shape or out.dtype != like.dtype or out.device != like.device \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {out_shape} {like.dtype} on {like.device}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if lse.shape != lse_shape or lse.dtype != torch.float32 or lse.device != like.device \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous {lse_shape} float32 on {like.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")


def _launch_bwd(qkv: torch.Tensor, bias: Optional[torch.Tensor], dout: torch.Tensor,
                scale: float, heads: int, out: Optional[torch.Tensor],
                lse: Optional[torch.Tensor]) -> torch.Tensor:
    bias = _kernel_args(qkv, bias, heads)
    b, s, c3 = qkv.shape
    if dout.shape != (b, s, c3 // 3) or dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise ValueError(f"dout must be {(b, s, c3 // 3)} {qkv.dtype} on {qkv.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dout = dout.contiguous()
    if out is None or lse is None:
        out, lse = _launch(qkv, bias, scale, heads, with_lse=True)
    else:
        _check_saved(out, lse, (b, s, c3 // 3), (b, heads, s), qkv)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)  # rowsum(dO * (out - bv)): the first kernel's note to the second
    _call("packed_attention_backward", "packed_attention_bwd",
          (("qkv", qkv), ("bias", bias), ("out", out), ("lse", lse), ("dout", dout),
           ("dqkv", dqkv), ("delta", delta)), qkv, scale, heads)
    mha_packed_bias_bwd.launches += 1
    return dqkv


def mha_packed_bias_bwd(qkv: torch.Tensor, bias: Optional[torch.Tensor], dout: torch.Tensor,
                        scale: float, heads: int, *, out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dqkv`` (B, S, 3C) from ``dout`` (B, S, C): the backward of
    :func:`mha_packed_bias` with respect to qkv (the bias' cotangent is
    ``dqkv`` summed over B and S). ``out`` and ``lse`` are what the forward
    returned and saved for these inputs, as autograd passes them; without
    them the forward runs first to make them.

    ``mha_packed_bias_bwd.launches`` counts kernel launches (and nothing else)."""
    _check(qkv, bias, heads)
    if qkv.device.type == "cpu":
        return mha_packed_bias_bwd_plain(qkv, bias, dout, scale, heads, out=out, lse=lse)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    return _launch_bwd(qkv, bias, dout, scale, heads, out, lse)


mha_packed_bias_bwd.launches = 0


def _needs_graph(*tensors) -> bool:
    """Whether a call must go through its autograd.Function: only when a
    gradient is wanted (the Function's host time is paid on every call)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _forward(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
             heads: int, with_lse: bool = False):
    if qkv.device.type == "cpu":
        return mha_packed_bias_plain(qkv, bias, scale, heads, return_lse=with_lse)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    return _launch(qkv, bias, scale, heads, with_lse)


def mha_packed_bias_fwd(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
                        heads: int):
    """The forward as autograd runs it: ``(out, lse)``, the output of
    :func:`mha_packed_bias` and each row's base-2 log-sum-exp (B, H, S) fp32
    (module docstring), which :func:`mha_packed_bias_bwd` takes. Its
    launches count in ``mha_packed_bias.launches``."""
    _check(qkv, bias, heads)
    return _forward(qkv, bias, scale, heads, with_lse=True)


class _PackedAttention(torch.autograd.Function):
    """Forward and backward kernels under one differentiable call; saves the
    inputs, the output and the rows' log-sum-exp (B, H, S)."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, heads):
        out, lse = _forward(qkv, bias, scale, heads, with_lse=True)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.scale, ctx.heads = scale, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv = mha_packed_bias_bwd(qkv, bias, dout, ctx.scale, ctx.heads, out=out, lse=lse)
        dbias = None
        if bias is not None and ctx.needs_input_grad[1]:
            dbias = dqkv.float().sum((0, 1)).to(bias.dtype)
        return dqkv, dbias, None, None


def mha_packed_bias(qkv: torch.Tensor, bias: Optional[torch.Tensor], scale: float,
                    heads: int) -> torch.Tensor:
    """Fused attention on the raw UNBIASED qkv projection (B, S, 3C) plus its
    bias (3C,) (or None) -> (B, S, C). The bias add happens inside the kernel.
    Differentiable with respect to qkv and bias.

    ``mha_packed_bias.launches`` counts launches of the forward kernel (and
    nothing else)."""
    _check(qkv, bias, heads)
    if _needs_graph(qkv, bias):
        return _PackedAttention.apply(qkv, bias, scale, heads)
    return _forward(qkv, bias, scale, heads)


mha_packed_bias.launches = 0


def mha_packed(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """Fused attention on the raw (already-biased) qkv projection
    (B, S, 3C) -> (B, S, C)."""
    return mha_packed_bias(qkv, None, scale, heads)


# --------------------------------------------------- folded and (B, S, H, D)
#
# K1b: the same kernels through their strided entries. A folded (B*H, S, D)
# tensor is B*H batches of one head; a (B, S, H, D) tensor is read with row
# stride H*D and head offset D, so `mha` moves no data before or after.


_LAYOUTS = {3: "(BH, S, D)", 4: "(B, S, H, D)"}


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ndims=(3, 4)) -> None:
    if q.ndim not in ndims or k.shape != q.shape or v.shape != q.shape:
        layout = " or ".join(_LAYOUTS[n] for n in ndims)
        raise ValueError(f"q, k, v must be one {layout} shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be one of float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D) view; a folded (BH, S, D) stays as it is."""
    return x.permute(0, 2, 1, 3) if x.ndim == 4 else x


def _heads_back(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).contiguous() if ndim == 4 else x


def _lse_shape(q: torch.Tensor):
    """Shape of K1b's saved log-sum-exp: (BH, S) for folded q, (B, H, S) for
    (B, S, H, D) q (the kernel's (B, H, S) with H = 1 in the folded case)."""
    return (q.shape[0], q.shape[1]) if q.ndim == 3 else (q.shape[0], q.shape[2], q.shape[1])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, *, return_lse: bool = False):
    """Plain PyTorch version of the K1b forward, any device, on (BH, S, D) or
    (B, S, H, D): fp32 logits and softmax, p cast to the input type before
    ``p @ v``, fp32 accumulation, one rounding of the output. ``return_lse``:
    also each row's base-2 log-sum-exp (:func:`_lse_shape`), as the kernel
    saves it for the backward."""
    _check_qkv(q, k, v)
    qh, kh, vh = (_heads_first(x).float() for x in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = _heads_back(torch.matmul(p.float(), vh).to(q.dtype), q.ndim)
    return (out, _lse_plain(logits)) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              dout: torch.Tensor, scale: float, *,
                              out: Optional[torch.Tensor] = None,
                              lse: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the K1b backward, any device: ``(dq, dk, dv)``
    in the layout of q, from the forward's ``out`` and saved ``lse``
    (computed here by the plain forward when not given). The algebra and the
    rounding points are the kernel's: p from lse, delta from out, ``dS``
    cast to the input type before the dq and dk products, ``p`` before dv."""
    _check_qkv(q, k, v)
    if out is None or lse is None:
        out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    qh, kh, vh, o, do = (_heads_first(x).float() for x in (q, k, v, out, dout))
    grads = _bwd_plain(qh, kh, vh, o, do, lse, scale, q.dtype)
    return tuple(_heads_back(g.to(q.dtype), q.ndim) for g in grads)


def _strided_args(tensors):
    """Checks what the kernels do not take; returns (B, S, H, D) and the
    (batch, row, head) element strides of ``tensors`` ((name, tensor) pairs,
    all of q's shape): (BH, S, D) is B = BH batches of H = 1 head, and
    (B, S, H, D) is read with row stride and head offset as they lie."""
    q = tensors[0][1]
    s, d = q.shape[1], q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {_HEAD_DIMS})")
    if s % _ROW_TILE != 0:
        raise ValueError(f"S = {s} must be a multiple of {_ROW_TILE}")
    b, h = q.shape[0], (q.shape[2] if q.ndim == 4 else 1)
    _check_batch(b)
    per_16_bytes = 16 // q.element_size()
    strides = []
    for name, t in tensors:
        st = t.stride()
        head = st[2] if len(st) == 4 else 0
        if st[-1] != 1 or st[0] % per_16_bytes or st[1] % per_16_bytes or head % per_16_bytes:
            raise ValueError(f"{name}: D must be contiguous and rows 16 bytes apart, got "
                             f"strides {st}")
        strides += (st[0], st[1], head)
    return (b, s, h, d), strides


def _launch_flash(q, k, v, scale: float, with_lse: bool = False):
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(_lse_shape(q), dtype=torch.float32, device=q.device) if with_lse else None
    dims, strides = _strided_args((("q", q), ("k", k), ("v", v), ("out", out)))
    _c_call("flash_attention_forward", "packed_attention",
            (("q", q), ("k", k), ("v", v), ("out", out), ("lse", lse)), dims, scale, q.device,
            strides=strides, what=lambda: f"q {tuple(q.shape)} {q.dtype}")
    flash_attention.launches += 1
    if q.ndim == 4:
        mha.launches += 1
    return (out, lse) if with_lse else out


def forward_kernel_attributes(head_dim: int, rows: int,
                              dtype: torch.dtype = torch.bfloat16) -> dict:
    """Launch resources of the forward kernel on the current card, for
    ``head_dim`` (32 or 64), ``rows``-row tiles and ``dtype``: bf16 runs
    128-row tiles where S is a multiple of 128, else 64; fp32 runs 64-row
    tiles. Registers and local (spill) bytes per thread, shared memory per
    block, resident blocks per SM, threads per block."""
    tiles = (64, 128) if dtype == torch.bfloat16 else (64,)
    if head_dim not in _HEAD_DIMS or dtype not in _SUPPORTED_DTYPES or rows not in tiles:
        raise ValueError(f"no forward kernel for head dim {head_dim}, {rows}-row tiles "
                         f"and {dtype}")
    if dtype == torch.bfloat16:
        return kernel_attributes("packed_attention", "attention_forward_attributes", head_dim,
                                 int(rows == 128))
    return kernel_attributes("packed_attention", "attention_forward_f32_attributes", head_dim)


def backward_kernel_attributes(head_dim: int, dtype: torch.dtype, kernel: str) -> dict:
    """Launch resources of one backward kernel (``kernel`` "dq" or "dkdv") on
    the current card for ``head_dim`` (32 or 64) and ``dtype``, as
    :func:`forward_kernel_attributes` gives them (64-row tiles in both
    types)."""
    if head_dim not in _HEAD_DIMS or kernel not in ("dq", "dkdv") \
            or dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f"no {kernel} backward kernel for head dim {head_dim} and {dtype}")
    return kernel_attributes("packed_attention_bwd", "attention_backward_attributes", head_dim,
                       int(dtype == torch.bfloat16), int(kernel == "dkdv"))


def _launch_flash_bwd(q, k, v, dout, scale: float, out, lse):
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    if out is None or lse is None:
        out, lse = _launch_flash(q, k, v, scale, with_lse=True)
    else:
        _check_saved(out, lse, q.shape, _lse_shape(q), q)
    grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v)]
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("dq", grads[0]),
             ("dk", grads[1]), ("dv", grads[2]))
    dims, strides = _strided_args(named)
    delta = torch.empty_like(lse)  # rowsum(dO * out): the first kernel's note to the second
    _c_call("flash_attention_backward", "packed_attention_bwd",
            named + (("lse", lse), ("delta", delta)), dims, scale, q.device,
            strides=strides, what=lambda: f"q {tuple(q.shape)} {q.dtype}")
    flash_attention_bwd.launches += 1
    return tuple(grads)


def _flash_forward(q, k, v, scale: float, with_lse: bool = False):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, return_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_flash(q, k, v, scale, with_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, scale: float, *,
                        out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` from ``dout``: the backward of :func:`flash_attention`
    (on (BH, S, D)) or :func:`mha` (on (B, S, H, D)). ``out`` and ``lse`` are
    what the forward returned and saved, as autograd passes them; without
    them the forward runs first to make them.

    ``flash_attention_bwd.launches`` counts kernel launches (and nothing else)."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, scale, out=out, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_flash_bwd(q, k, v, dout, scale, out, lse)


flash_attention_bwd.launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """The K1b forward as autograd runs it, on (BH, S, D) or (B, S, H, D):
    ``(out, lse)``, lse of :func:`_lse_shape`, which
    :func:`flash_attention_bwd` takes. Its launches count in
    ``flash_attention.launches`` (and ``mha.launches`` for (B, S, H, D))."""
    _check_qkv(q, k, v)
    return _flash_forward(q, k, v, scale, with_lse=True)


class _FlashAttention(torch.autograd.Function):
    """K1b forward and backward under one differentiable call; saves q, k, v,
    the output and the rows' log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.contiguous(), ctx.scale, out=out,
                                         lse=lse)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Fused attention on folded tensors: q, k, v (BH, S, D) -> (BH, S, D),
    ``softmax(q k^T * scale) v``. Differentiable with respect to q, k and v.

    ``flash_attention.launches`` counts launches of the forward kernel (and
    nothing else), through this function and through :func:`mha`."""
    _check_qkv(q, k, v, (3,))
    if _needs_graph(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale)


flash_attention.launches = 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, S, H, D) attention through the same kernels, read and written in
    that layout; returns (B, S, H, D). Differentiable.

    ``mha.launches`` counts the forward kernel's launches made through this
    function (they are counted in ``flash_attention.launches`` too)."""
    _check_qkv(q, k, v, (4,))
    if _needs_graph(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale)


mha.launches = 0
