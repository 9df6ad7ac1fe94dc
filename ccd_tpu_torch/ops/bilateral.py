"""Bilateral filter with cv2 semantics on a disc window (the augmentation's
``BilateralBlur``).

Counterpart of ``ccd_tpu/data/aug_ops.py::_bilateral_pallas`` (K3, the Pallas
kernel under ``bilateral_filter``). Per sample: a disc window of static max
radius ``max_radius`` (at most 5: 81 taps) with a per-sample radius² mask
(the centre tap is never masked; a radius² that is no square, as 8, admits
the taps with d² <= 8), per-sample ``sigma_color`` and ``sigma_space``, colour
distance = L1 over the 3 channels × 255, weight ``exp(gc·cd² + gs·d²)``,
edge-replicate padding, ``num / den`` in fp32.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/bilateral.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``) or raises: it takes fp32 (B, H, W, 3) only; there is no fallback.
The kernel is a template on the max radius, so every tap's offset is a
constant; a thread filters 4 adjacent pixels from a float4 tile that a block
of 32 x 16 pixels stages with asynchronous 16-byte copies, and a weight is one
multiply-add chain and one ``ex2.approx``. On a CPU tensor the wrapper
computes :func:`bilateral_filter_plain`, the shifted-tap loop of the JAX
package's XLA path.

Bound on an H100 at the pretraining shape (64, 32, 128, 3): one image read
and one written, 6.3 MB (0.0019 ms at 3.35 TB/s), against 11 fp32-pipe
instructions and one exponential for each of up to 81 taps a pixel (0.0070
ms at 128 fp32 lanes an SM and 1.98 GHz with every sample at radius 5):
operations.
"""

from __future__ import annotations

import torch

MAX_RADIUS = 5


def _check(x: torch.Tensor, sigma_color: torch.Tensor, sigma_space: torch.Tensor,
           rad2: torch.Tensor, max_radius: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b = x.shape[0]
    for name, t in (("sigma_color", sigma_color), ("sigma_space", sigma_space), ("rad2", rad2)):
        if t.numel() != b:
            raise ValueError(f"{name} must hold one value per sample ({b}), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not 0 <= int(max_radius) <= MAX_RADIUS:
        raise ValueError(f"max_radius must be in [0, {MAX_RADIUS}], got {max_radius}")


def _gains(sigma_color: torch.Tensor, sigma_space: torch.Tensor):
    """The exponent's per-sample factors, -1 / (2 sigma²), as (B, 1, 1, 1)."""
    b = sigma_color.numel()
    sc = sigma_color.reshape(b, 1, 1, 1)
    ss = sigma_space.reshape(b, 1, 1, 1)
    return -0.5 / (sc * sc), -0.5 / (ss * ss)


def bilateral_filter_plain(x: torch.Tensor, sigma_color: torch.Tensor,
                           sigma_space: torch.Tensor, rad2: torch.Tensor,
                           max_radius: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, any device: the shifted-tap loop
    of ``ccd_tpu/data/aug_ops.py::bilateral_filter`` (its XLA path). x:
    (B, H, W, C); sigmas, rad2: B values each."""
    _check(x, sigma_color, sigma_space, rad2, max_radius)
    b, h, w, _ = x.shape
    r = int(max_radius)
    gc, gs = _gains(sigma_color, sigma_space)
    rad2 = rad2.reshape(b, 1, 1, 1).to(x.dtype)
    rows = torch.arange(-r, h + r, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=x.device).clamp(0, w - 1)
    xp = x.index_select(1, rows).index_select(2, cols)
    num = torch.zeros_like(x)
    den = torch.zeros((b, h, w, 1), dtype=x.dtype, device=x.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d2 = dy * dy + dx * dx
            if d2 > r * r:
                continue  # cv2's circular window (static bound)
            nb = xp[:, r + dy:r + dy + h, r + dx:r + dx + w]
            cd = torch.sum(torch.abs(nb - x), dim=-1, keepdim=True) * 255.0
            wgt = torch.exp(gc * cd * cd + gs * float(d2))
            if d2 > 0:
                wgt = wgt * (float(d2) <= rad2)
            num = num + wgt * nb
            den = den + wgt
    return num / den


def _launch(x: torch.Tensor, gc: torch.Tensor, gs: torch.Tensor, rad2: torch.Tensor,
            r: int) -> torch.Tensor:
    import ctypes

    from ccd_tpu_torch.ops._build import load_library

    fn = load_library("bilateral").bilateral_filter_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    b, h, w, _ = x.shape
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), gc.data_ptr(), gs.data_ptr(), rad2.data_ptr(), out.data_ptr(),
                 b, h, w, r, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilateral_filter_forward failed at launch: error {err} "
                           f"(x {tuple(x.shape)}, max_radius {r})")
    return out


def bilateral_filter_fused(x: torch.Tensor, sigma_color: torch.Tensor,
                           sigma_space: torch.Tensor, rad2: torch.Tensor,
                           max_radius: int) -> torch.Tensor:
    """Bilateral filter of (B, H, W, 3) images in [0, 1]; sigmas in 8-bit
    units and ``rad2`` (the disc's radius squared) one value per sample;
    ``max_radius`` bounds the taps (at most 5).

    ``bilateral_filter_fused.launches`` counts launches of the kernel (and
    nothing else)."""
    _check(x, sigma_color, sigma_space, rad2, max_radius)
    if x.device.type == "cpu":
        return bilateral_filter_plain(x, sigma_color, sigma_space, rad2, max_radius)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[-1] != 3 or x.dtype != torch.float32:
        raise TypeError(f"the bilateral kernel takes float32 (B, H, W, 3), got "
                        f"{x.dtype} {tuple(x.shape)}")
    gc, gs = (g.reshape(-1).float().contiguous() for g in _gains(sigma_color, sigma_space))
    out = _launch(x.contiguous(), gc, gs, rad2.reshape(-1).float().contiguous(), int(max_radius))
    bilateral_filter_fused.launches += 1
    return out


bilateral_filter_fused.launches = 0


def kernel_attributes(max_radius: int = MAX_RADIUS) -> dict:
    """Launch resources of the kernel built for ``max_radius`` on the current
    card: registers and local (spill) bytes per thread, shared memory per
    block, resident blocks per SM, threads per block."""
    from ccd_tpu_torch.ops._build import kernel_attributes as attributes

    if not 0 <= int(max_radius) <= MAX_RADIUS:
        raise ValueError(f"max_radius must be in [0, {MAX_RADIUS}], got {max_radius}")
    return attributes("bilateral", "bilateral_filter_attributes", int(max_radius))
