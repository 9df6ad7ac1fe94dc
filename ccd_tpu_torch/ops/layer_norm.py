"""LayerNorm over the last axis with fp32 statistics and arithmetic, the
output in a given type: what Flax's ``nn.LayerNorm(dtype=...)`` computes and
``models/layers.py::LayerNorm`` runs.

It replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA, which
fuses the casts around it into one pass. On a CUDA tensor the wrapper
launches the hand-written kernels of ``csrc/layer_norm.cu`` (built with
``nvcc`` at first use, bound with ``ctypes``) or raises; there is no
fallback. It takes bf16 or fp32 input of any width C with C % 8 == 0 and
8 <= C <= 1024, contiguous and 16-byte aligned, fp32 weight and bias of (C,),
and writes bf16 or fp32. The forward reads the input once and writes the
output once, one warp a row with the row in registers; where a gradient is
wanted it also saves each row's fp32 mean and rstd, and the backward reads
the input, the output's cotangent and those to write the input's cotangent
in the input's type, with the weight's and bias's gradients summed in a
fixed order (no atomics: the same bits every run).

On a CPU tensor it computes :func:`layer_norm_plain`, the chain the port ran
on the card before the kernel, ``F.layer_norm(x.float(), ...).to(dtype)``,
whose autograd is the backward.

Bound on an H100: bytes. At the recognition batch (1024 images of 256
tokens, C = 384, bf16) a norm must read 201 MB and write 201 MB, 0.120 ms at
3.35 TB/s, where the chain moved 1007 MB (a cast to fp32, the fp32 norm, a
cast back); its operations (about 8 an element) take an eighth of that on
the fp32 pipe.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
VECTOR = 8            # values a lane loads at once: C % VECTOR == 0
MAX_WIDTH = 1024      # 32 lanes x VECTOR x 4 loads a lane a row


def layer_norm_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version, any device: the fp32 LayerNorm of ``x`` over its last
    axis, cast to ``out_dtype`` (differentiable through autograd)."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias, eps).to(out_dtype)


def check_kernel_inputs(x: torch.Tensor, weight: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> None:
    """Raise unless the kernels take these operands: ``x`` bf16 or fp32,
    contiguous and 16-byte aligned, its width C a multiple of 8 in [8,
    1024]; ``weight`` and ``bias`` fp32 (C,), contiguous and 16-byte aligned
    on ``x``'s device; ``out_dtype`` bf16 or fp32."""
    if x.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"the LayerNorm kernels take and write bfloat16 or float32, got "
                        f"{x.dtype} -> {out_dtype}")
    if x.ndim < 1:
        raise ValueError("x must have a last axis to normalise")
    c = x.shape[-1]
    if c % VECTOR or not VECTOR <= c <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernels take widths that are multiples of {VECTOR} "
                         f"in [{VECTOR}, {MAX_WIDTH}], got {c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be contiguous and 16-byte aligned (shape {tuple(x.shape)}, "
                         f"strides {x.stride()})")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None or p.dtype != torch.float32 or tuple(p.shape) != (c,) \
                or not p.is_contiguous() or p.data_ptr() % 16 or p.device != x.device:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 ({c},) "
                             f"on {x.device}, got "
                             f"{None if p is None else (p.dtype, tuple(p.shape), p.device)}")


# each C entry's arguments: p a pointer, i an int, f a float
_SIGNATURES = {"layer_norm_forward": "pppppiifiiip", "layer_norm_backward": "pppppppiiiiip"}
_FNS = {}


def _entry(name: str):
    """C entry ``name`` of ``csrc/layer_norm.cu`` (built and loaded at first use)."""
    fn = _FNS.get(name)
    if fn is None:
        import ctypes

        from ccd_tpu_torch.ops._build import load_library

        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        fn = getattr(load_library("layer_norm"), name)
        fn.argtypes = [kinds[k] for k in _SIGNATURES[name]]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _device(x: torch.Tensor):
    """The launch's device made current where it is not (a no-op context
    where it is, the usual case: one process a card)."""
    index = x.get_device()
    return _SAME if index == torch.cuda.current_device() else torch.cuda.device(index)


_SAME = contextlib.nullcontext()


def _stream(x: torch.Tensor) -> int:
    # the current stream's handle without building a torch.cuda.Stream (host
    # time: a training step makes ~90 of these calls)
    return torch._C._cuda_getCurrentRawStream(x.get_device())


_grids = {}


def _blocks(x: torch.Tensor, out_dtype: torch.dtype, backward: bool) -> int:
    """Blocks of a launch of the forward (or the backward's dx) kernel for
    ``x``: one a block's rows (a warp a row), at most as many as the card
    holds at once, from :func:`kernel_attributes` (asked once a width, pair
    of types and card). The backward's blocks are also its partial rows of
    the parameters' gradients."""
    c = x.shape[-1]
    key = (c, x.dtype, out_dtype, backward, x.get_device())
    grid = _grids.get(key)
    if grid is None:
        with _device(x):
            a = kernel_attributes(c, x.dtype, out_dtype, backward)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        if a["blocks_per_sm"] <= 0:
            raise RuntimeError(f"no LayerNorm block fits an SM: {a} (C {c})")
        grid = _grids[key] = (a["blocks_per_sm"] * sms, a["threads"] // 32)
    card, rows_per_block = grid
    return min(-(-(x.numel() // c) // rows_per_block), card)


def _launch_forward(x, weight, bias, y, stats, eps: float, blocks: int) -> None:
    fn = _entry("layer_norm_forward")
    c = x.shape[-1]
    with _device(x):
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 None if stats is None else stats.data_ptr(), x.numel() // c, c, eps, blocks,
                 x.dtype is torch.bfloat16, y.dtype is torch.bfloat16, _stream(x))
    if err != 0:
        raise RuntimeError(f"layer_norm_forward failed at launch: error {err} "
                           f"(x {tuple(x.shape)} {x.dtype} -> {y.dtype}, {blocks} blocks)")


def _launch_backward(x, dy, weight, stats, dx, partial, grads, blocks: int) -> None:
    fn = _entry("layer_norm_backward")
    c = x.shape[-1]
    with _device(x):
        err = fn(x.data_ptr(), dy.data_ptr(), weight.data_ptr(), stats.data_ptr(),
                 dx.data_ptr(), partial.data_ptr(), grads.data_ptr(), x.numel() // c, c,
                 blocks, x.dtype is torch.bfloat16, dy.dtype is torch.bfloat16, _stream(x))
    if err != 0:
        raise RuntimeError(f"layer_norm_backward failed at launch: error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, dy {dy.dtype}, {blocks} blocks)")


def _forward(x, weight, bias, eps: float, out_dtype: torch.dtype, save: bool):
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stats = torch.empty((2,) + x.shape[:-1], dtype=torch.float32, device=x.device) \
        if save else None
    if x.numel():
        _launch_forward(x, weight, bias, y, stats, eps, _blocks(x, out_dtype, False))
        layer_norm.launches += 1
    return y, stats


def _backward(x, dy, weight, stats):
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.contiguous_format)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if not x.numel():
        return dx, grads.zero_()
    blocks = _blocks(x, dy.dtype, True)
    partial = torch.empty((2, blocks, c), dtype=torch.float32, device=x.device)
    _launch_backward(x, dy, weight, stats, dx, partial, grads, blocks)
    layer_norm.bwd_launches += 1
    return dx, grads


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        y, stats = _forward(x, weight, bias, eps, out_dtype, save=True)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, grads = _backward(x, dy, weight, stats)
        want = ctx.needs_input_grad
        return dx if want[0] else None, grads[0] if want[1] else None, \
            grads[1] if want[2] else None, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis with fp32 ``weight`` and
    ``bias``: fp32 statistics and arithmetic, the result in ``out_dtype``;
    differentiable in ``x``, ``weight`` and ``bias``. On the card the
    kernels' inputs are checked once, in the forward, and the statistics
    saved only where a gradient is wanted.

    ``layer_norm.launches`` and ``layer_norm.bwd_launches`` count the
    forward kernel's launches and the backward's (one a backward: its dx
    kernel and the parameters' sums), and nothing else."""
    if x.is_cuda:
        return _on_card(x, weight, bias, eps, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return layer_norm_plain(x, weight, bias, eps, out_dtype)


def _on_card(x, weight, bias, eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    check_kernel_inputs(x, weight, bias, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps, out_dtype)
    return _forward(x, weight, bias, eps, out_dtype, save=False)[0]


layer_norm.launches = 0
layer_norm.bwd_launches = 0


def kernel_attributes(c: int, dtype: torch.dtype, out_dtype: torch.dtype,
                      backward: bool = False) -> dict:
    """Launch resources of the forward (or the backward's dx) kernel built
    for width ``c`` and these types on the current card: registers and local
    (spill) bytes per thread, shared memory per block, resident blocks per
    SM, threads per block."""
    from ccd_tpu_torch.ops._build import kernel_attributes as attributes

    if dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"no LayerNorm kernel for {dtype} -> {out_dtype}")
    return attributes("layer_norm", "layer_norm_attributes", int(backward), int(c),
                      int(dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
