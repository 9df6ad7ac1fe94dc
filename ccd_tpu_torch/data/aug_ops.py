"""Batched, on-device image ops of the augmentation chains.

Counterpart of ``ccd_tpu/data/aug_ops.py``: the ops that
``photometric_augment`` (severities 1-6) and ``supervised_augment`` reach,
the 21 ``ARITHMETIC_OPS``, the 9 ``COLOR_OPS``, the blur family
(``op_sharpen`` and ``op_gaussian_blur``, ``op_average_blur``,
``op_median_blur``, ``op_motion_blur``, ``op_bilateral_blur``), the 8
``CONTRAST_OPS``, the 4 ``WEATHER_OPS``, the colour and quantisation ops of
severities 4 and 6 and ``op_channel_shuffle``, with the helpers they use and
the combinators ``one_of``, ``sometimes`` and ``some_of_random_order``.
Images are (B, H, W, 3) float [0, 1] NHWC; every op draws its parameters per
sample from a key object
(``ccd_tpu_torch/data/random.py``) with the same calls, in the same order and
shapes, as the JAX op, then applies them with the same arithmetic. The
imgaug/cv2 semantics and the documented approximations are those of the JAX
module (its docstring and PARITY.md).

Two rules the JAX module did not need:

* **Selection is exact.** Where JAX multiplies candidates by a one-hot and
  sums (``one_of``, the blur-size and median-size picks, the k-means and
  histogram lookups), the port indexes or gathers. A matrix product on the
  card may run in TF32 and round pixel values.
* **No TF32 anywhere a value is rounded afterwards.** The JPEG DCT, the colour
  space matrices and the resizes are written as elementwise fp32 products
  and sums; there is no ``matmul``, ``einsum`` or cuDNN convolution in this
  module.

As in JAX, every candidate of a ``one_of`` is computed and ``sometimes``
computes its op for every sample: outputs are identical, and the number of
launches of a chain does not depend on its draws.

``bilateral_filter`` goes through ``ccd_tpu_torch/ops/bilateral.py``: the
hand-written CUDA kernel (K3) for a CUDA tensor, its plain version for a CPU
tensor.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.ops.bilateral import bilateral_filter_fused
from ccd_tpu_torch.ops.image import jax_image_resize
from ccd_tpu_torch.utils.device import device_constant
from ccd_tpu_torch.utils.tracing import span

Op = Callable[[TorchKey, torch.Tensor], torch.Tensor]  # (key, x) -> x'


# ------------------------------------------------------------------ helpers

def _u(key, b, lo, hi):
    return key.uniform((b, 1, 1, 1), lo, hi)


def _table(name: str) -> np.ndarray:
    return _TABLES[name]


def _const(name: str, x: torch.Tensor) -> torch.Tensor:
    """The module's fp32 table ``name`` on ``x``'s device (copied there once)."""
    return device_constant(_table, x.device, name)


def _select(cands: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """Row ``b`` of ``cands[choice[b]]``: (N, B, ...) x (B,) -> (B, ...), exact."""
    return cands[choice, torch.arange(cands.shape[1], device=cands.device)]


def one_of(key, x: torch.Tensor, ops: Sequence[Op]) -> torch.Tensor:
    """iaa.OneOf: per-sample uniform choice among ``ops`` (all candidates are
    computed; the pick is an index, not a one-hot product). A ``one_of``
    span bounds the candidates and the pick."""
    with span("one_of"):
        ks = key.split(len(ops) + 1)
        cands = torch.stack([op(ks[i], x) for i, op in enumerate(ops)])
        choice = ks[-1].randint((x.shape[0],), 0, len(ops))
        return _select(cands, choice)


def sometimes(key, x: torch.Tensor, p: float, op: Op) -> torch.Tensor:
    """iaa.Sometimes(p, op): per-sample Bernoulli gate."""
    k1, k2 = key.split()
    gate = k1.bernoulli(p, (x.shape[0], 1, 1, 1)).to(x.dtype)
    return x * (1.0 - gate) + op(k2, x) * gate


def some_of_random_order(key, x: torch.Tensor, ops: Sequence[Op]) -> torch.Tensor:
    """iaa.SomeOf((1, None), ops, random_order=True): per sample, a subset of
    uniform size in [1, len(ops)] applied one after another in a random order
    (the severity-2 chain). As in JAX: len(ops) slots; in slot s every op runs
    on the whole batch with its own key, each sample takes op perm[s] (an
    index, not a one-hot product) while s < its subset size: len(ops)**2 op
    evaluations, and no subset's size goes to the host."""
    n = len(ops)
    b = x.shape[0]
    k_perm, k_n, k_ops = key.split(3)
    perms = k_perm.permutations(b, n)
    n_apply = k_n.randint((b,), 1, n + 1)
    for s in range(n):
        ks = k_ops.fold_in(s).split(n)
        cands = torch.stack([op(ks[i], x) for i, op in enumerate(ops)])
        y = _select(cands, perms[:, s])
        active = (s < n_apply).to(x.dtype)[:, None, None, None]
        x = x * (1.0 - active) + y * active
    return x


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge-replicate padding of (B, H, W, C) by clamped indices."""
    h, w = x.shape[1:3]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def _conv3x3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 convolution with per-sample kernels via 9 shifted adds.

    x: (B, H, W, C); k: (B, 3, 3) or (3, 3). Edge padding."""
    b, h, w, _ = x.shape
    if k.ndim == 2:
        k = k.expand(b, 3, 3)
    xp = _pad_edge(x, 1, 1, 1, 1)
    out = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            out = out + k[:, i, j, None, None, None] * xp[:, i:i + h, j:j + w]
    return out


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) [0,1] RGB -> HSV with H in [0,1)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(mx == r, (g - b) / safe_d % 6.0,
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0)) / 6.0
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] % 1.0, hsv[..., 1], hsv[..., 2]

    def chan(n):
        k = (n + h * 6.0) % 6.0
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


def _with_channel(t: torch.Tensor, c: int, value: torch.Tensor) -> torch.Tensor:
    """``t.at[..., c].set(value)`` of a (..., 3) tensor."""
    parts = [t[..., i] for i in range(t.shape[-1])]
    parts[c] = value
    return torch.stack(parts, dim=-1)


def _luma(x: torch.Tensor) -> torch.Tensor:
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


# cv2 RGB<->Lab math (sRGB linearisation + D65 XYZ + Lab f-curve)
_LAB_M = np.array([[0.412453, 0.357580, 0.180423],
                   [0.212671, 0.715160, 0.072169],
                   [0.019334, 0.119193, 0.950227]], np.float32)
_LAB_WHITE = np.array([0.950456, 1.0, 1.088754], np.float32)
_LAB_M_INV_T = np.linalg.inv(_LAB_M).T.astype(np.float32)


def _mix3(v: torch.Tensor, m: np.ndarray, transpose: bool) -> torch.Tensor:
    """(..., 3) -> (..., 3): ``out[d] = sum_c v[c] * m[d, c]`` (or ``m[c, d]``
    with ``transpose``), elementwise fp32."""
    mm = m.T if transpose else m
    return torch.stack([v[..., 0] * float(mm[d, 0]) + v[..., 1] * float(mm[d, 1])
                        + v[..., 2] * float(mm[d, 2]) for d in range(3)], dim=-1)


def _srgb_linearize(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _srgb_delinearize(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.clamp_min(c, 1e-12) ** (1.0 / 2.4) - 0.055)


def _rgb_to_lab(x: torch.Tensor):
    """(B, H, W, 3) RGB [0,1] -> (L in [0,100], a, b centred at 0)."""
    xyz = _mix3(_srgb_linearize(x), _LAB_M, transpose=False)
    t = xyz / _const("lab_white", x)
    f = torch.where(t > 0.008856, torch.clamp_min(t, 1e-12) ** (1.0 / 3.0),
                    7.787 * t + 16.0 / 116.0)
    lum = torch.where(t[..., 1] > 0.008856, 116.0 * f[..., 1] - 16.0, 903.3 * t[..., 1])
    a = 500.0 * (f[..., 0] - f[..., 1])
    bb = 200.0 * (f[..., 1] - f[..., 2])
    return lum, a, bb


def _lab_to_rgb(lum: torch.Tensor, a: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    fy = (lum + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - bb / 200.0

    def finv(f):
        return torch.where(f > 0.206893, f * f * f, (f - 16.0 / 116.0) / 7.787)

    y = torch.where(lum > 7.9996248, fy * fy * fy, lum / 903.3)
    xyz = torch.stack([finv(fx), y, finv(fz)], dim=-1) * _const("lab_white", lum)
    rgb = _mix3(xyz, _LAB_M_INV_T, transpose=True)
    return torch.clamp(_srgb_delinearize(rgb), 0.0, 1.0)


def _smooth_field(key, b, h, w, device, octaves=((4, 8), (8, 32)), method="linear"):
    """Multi-octave smooth noise in [-1, 1], (B, H, W, 1)."""
    ks = key.split(len(octaves))
    field = torch.zeros((b, h, w, 1), device=device)
    amp = 1.0
    total = 0.0
    for k, (ch, cw) in zip(ks, octaves):
        coarse = k.uniform((b, ch, cw, 1), -1.0, 1.0)
        field = field + amp * jax_image_resize(coarse, (b, h, w, 1), method)
        total += amp
        amp *= 0.5
    return field / total


# ------------------------------------------------------------------ arithmetic

def op_add_elementwise(key, x):
    """iaa.AddElementwise((-40, 40)): per-pixel uniform add."""
    b, h, w, _ = x.shape
    add = key.uniform((b, h, w, 1), -40 / 255, 40 / 255)
    return torch.clamp(x + add, 0, 1)


def op_additive_gaussian(key, x, scale_max=0.2):
    """iaa.AdditiveGaussianNoise(scale=(0, 0.2*255))."""
    k1, k2 = key.split()
    b, h, w, _ = x.shape
    sigma = _u(k1, b, 0.0, scale_max)
    return torch.clamp(x + k2.normal((b, h, w, 1)) * sigma, 0, 1)


def op_additive_laplace(key, x, scale_max=0.2):
    """iaa.AdditiveLaplaceNoise(scale=(0, 0.2*255))."""
    k1, k2 = key.split()
    b, h, w, _ = x.shape
    sigma = _u(k1, b, 0.0, scale_max)
    return torch.clamp(x + k2.laplace((b, h, w, 1)) * sigma, 0, 1)


def poisson_counts(key, lam: torch.Tensor, shape, k_max: int = 128,
                   chunk: int = 32) -> torch.Tensor:
    """Exact Poisson sampling by inverse-CDF compare-sum (see the JAX
    function): per-sample CDF table in log space, each uniform inverted as
    ``count = sum_n [u > cdf_n]``, ``chunk`` table entries at a time."""
    _k1, k2 = key.split()
    n = torch.arange(k_max, dtype=torch.float32, device=lam.device)
    logpmf = n[None, :] * torch.log(lam[:, None]) - lam[:, None] - torch.lgamma(n[None, :] + 1.0)
    cdf = torch.cumsum(torch.exp(logpmf), dim=-1)                  # (B, k_max)
    u = k2.uniform((lam.shape[0],) + tuple(shape))
    bshape = (lam.shape[0],) + (1,) * len(shape)
    count = torch.zeros_like(u)
    for c in range(k_max // chunk):
        cc = cdf[:, c * chunk:(c + 1) * chunk].reshape(bshape + (chunk,))
        count = count + (u[..., None] > cc).sum(dim=-1, dtype=torch.float32)
    return count


def op_additive_poisson(key, x, lam_max=40.0):
    """iaa.AdditivePoissonNoise(lam=(0, 40)): adds Poisson(lam)/255 samples."""
    k1, k2 = key.split()
    b, h, w, _ = x.shape
    lam = torch.clamp_min(_u(k1, b, 0.0, lam_max).reshape(b), 1e-3)
    noise = poisson_counts(k2, lam, (h, w, 1))
    return torch.clamp(x + noise.to(x.dtype) / 255.0, 0, 1)


def _maybe_per_channel(key, b, lo, hi, p_per_channel):
    k1, k2, k3 = key.split(3)
    per_px = k1.uniform((b, 1, 1, 3), lo, hi)
    single = k2.uniform((b, 1, 1, 1), lo, hi)
    pc = k3.bernoulli(p_per_channel, (b, 1, 1, 1))
    return torch.where(pc, per_px, single.expand(per_px.shape))


def op_multiply(key, x):
    """iaa.Multiply((0.5, 1.5), per_channel=0.5)."""
    mul = _maybe_per_channel(key, x.shape[0], 0.5, 1.5, 0.5)
    return torch.clamp(x * mul, 0, 1)


def op_multiply_elementwise(key, x, p_per_channel=0.5):
    """iaa.MultiplyElementwise((0.5, 1.5), per_channel=0.5)."""
    k1, k2, k3 = key.split(3)
    b, h, w, c = x.shape
    per = k1.uniform((b, h, w, c), 0.5, 1.5)
    mono = k2.uniform((b, h, w, 1), 0.5, 1.5)
    pc = k3.bernoulli(p_per_channel, (b, 1, 1, 1))
    return torch.clamp(x * torch.where(pc, per, mono.expand(per.shape)), 0, 1)


def op_dropout(key, x, p_max=0.1):
    """iaa.Dropout(p=(0, 0.1), per_channel=0.5)."""
    k1, k2, k3, k4 = key.split(4)
    b, h, w, c = x.shape
    p = _u(k1, b, 0.0, p_max)
    drop_pc = k2.uniform((b, h, w, c)) < p
    drop_mono = k3.uniform((b, h, w, 1)) < p
    pc = k4.bernoulli(0.5, (b, 1, 1, 1))
    drop = torch.where(pc, drop_pc, drop_mono.expand(drop_pc.shape))
    return torch.where(drop, torch.zeros_like(x), x)


def op_coarse_dropout(key, x, p=0.02, size_percent=0.15, per_channel=0.5):
    """iaa.CoarseDropout(0.02, size_percent=..., per_channel=...)."""
    k1, k2, k3 = key.split(3)
    b, h, w, c = x.shape
    ch = max(int(h * size_percent), 2)
    cw = max(int(w * size_percent), 2)
    drop_pc = k1.uniform((b, ch, cw, c)) < p
    drop_mono = k2.uniform((b, ch, cw, 1)) < p
    pc = k3.bernoulli(per_channel, (b, 1, 1, 1))
    drop = torch.where(pc, drop_pc, drop_mono.expand(drop_pc.shape))
    big = jax_image_resize(drop.to(x.dtype), (b, h, w, c), "nearest")
    return x * (1.0 - big)


def op_dropout2d(key, x, p=0.5):
    """iaa.Dropout2d(p=0.5): drop whole channels, always keeping >= 1."""
    k1, k2 = key.split()
    b = x.shape[0]
    keep = ~k1.bernoulli(p, (b, 1, 1, 3))
    any_kept = keep.any(dim=-1, keepdim=True)
    forced = k2.randint((b, 1, 1), 0, 3)[..., None] == torch.arange(3, device=x.device)
    keep = torch.where(any_kept, keep, forced)
    return x * keep.to(x.dtype)


def _salt_pepper(key, x, p, salt=True, pepper=True, per_channel=False):
    b, h, w, c = x.shape
    shape = (b, h, w, c) if per_channel else (b, h, w, 1)
    u = key.uniform(shape)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    out = x
    if salt and pepper:
        out = torch.where(u < p / 2, zero, torch.where(u > 1 - p / 2, one, out))
    elif salt:
        out = torch.where(u < p, one, out)
    elif pepper:
        out = torch.where(u < p, zero, out)
    return out


def op_impulse_noise(key, x, p=0.1):
    """iaa.ImpulseNoise(0.1) = salt&pepper with per-channel randomness."""
    return _salt_pepper(key, x, p, per_channel=True)


def op_salt_and_pepper(key, x, p=0.1):
    return _salt_pepper(key, x, p)


def op_salt(key, x, p=0.1):
    return _salt_pepper(key, x, p, pepper=False)


def op_pepper(key, x, p=0.1):
    return _salt_pepper(key, x, p, salt=False)


def op_invert(key, x, p=0.15):
    """iaa.Invert(0.15): per-sample invert with internal probability p."""
    gate = key.bernoulli(p, (x.shape[0], 1, 1, 1)).to(x.dtype)
    return x * (1 - gate) + (1.0 - x) * gate


def op_solarize(key, x, p=0.5, thresh=(32 / 255, 128 / 255)):
    """iaa.Solarize(0.5, threshold=(32, 128)): invert pixels >= threshold."""
    k1, k2 = key.split()
    b = x.shape[0]
    t = _u(k1, b, thresh[0], thresh[1])
    sol = torch.where(x >= t, 1.0 - x, x)
    gate = k2.bernoulli(p, (b, 1, 1, 1)).to(x.dtype)
    return x * (1 - gate) + sol * gate


# --------------- JPEG compression (real blockwise DCT quantisation)

_DCT8 = np.stack([
    (np.sqrt((1.0 if k == 0 else 2.0) / 8.0)
     * np.cos((2 * np.arange(8) + 1) * k * np.pi / 16.0))
    for k in range(8)
]).astype(np.float32)  # (8, 8) orthonormal DCT-II matrix

# ITU-T T.81 Annex K quantisation tables
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99], [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99], [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99], [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99], [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def _mm8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) @ (..., 8, 8) as fp32 products and sums (no TF32 path)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _jpeg_channel(chan: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Blockwise DCT -> quantise(round) -> inverse. chan: (B, H, W) in
    [-128, 127] level-shifted units; qtable: (B, 8, 8)."""
    b, h, w = chan.shape
    blocks = chan.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    d = _const("dct8", chan)
    coef = _mm8(_mm8(d, blocks), d.T)
    q = qtable[:, None, None]
    coef = torch.round(coef / q) * q
    out = _mm8(_mm8(d.T, coef), d)
    return out.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def op_jpeg_compression(key, x, compression=(70, 99)):
    """iaa.JpegCompression(compression=(70, 99)): 8x8 DCT quantisation with
    the T.81 tables at quality = 100 - compression, 4:2:0 chroma. H and W
    must be multiples of 16."""
    b, h, w, _ = x.shape
    if h % 16 or w % 16:
        raise ValueError(f"JPEG compression needs H and W multiples of 16, got {h}x{w}")
    comp = key.uniform((b,), compression[0], compression[1])
    quality = 100.0 - comp
    scale = torch.where(quality < 50, 5000.0 / quality, 200.0 - 2.0 * quality)
    ql = torch.clamp(torch.floor((_const("q_luma", x) * scale[:, None, None] + 50.0) / 100.0),
                     1, 255)
    qc = torch.clamp(torch.floor((_const("q_chroma", x) * scale[:, None, None] + 50.0) / 100.0),
                     1, 255)

    r, g, bch = x[..., 0] * 255, x[..., 1] * 255, x[..., 2] * 255
    y = 0.299 * r + 0.587 * g + 0.114 * bch - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * bch
    cr = 0.5 * r - 0.418688 * g - 0.081312 * bch

    y = _jpeg_channel(y, ql)

    def sub(c):  # 4:2:0 chroma subsampling
        small = jax_image_resize(c[..., None], (b, h // 2, w // 2, 1), "linear")
        small = _jpeg_channel(small[..., 0], qc)
        return jax_image_resize(small[..., None], (b, h, w, 1), "linear")[..., 0]

    cb, cr = sub(cb), sub(cr)
    y = y + 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    bch = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, bch], dim=-1) / 255.0, 0, 1)


def op_emboss(key, x):
    """iaa.Emboss(alpha=(0,1), strength=(0.5,1.5))."""
    k1, k2 = key.split()
    b = x.shape[0]
    s = k1.uniform((b,), 0.5, 1.5)
    alpha = _u(k2, b, 0.0, 1.0)
    z = torch.zeros_like(s)
    one = torch.ones_like(s)
    kern = torch.stack([torch.stack([-1 - s, -s, z], -1),
                        torch.stack([-s, one, s], -1),
                        torch.stack([z, s, 1 + s], -1)], -2)
    emb = torch.clamp(_conv3x3(x, kern), 0, 1)
    return x * (1 - alpha) + emb * alpha


_EDGE_KERNEL = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)


def op_edge_detect(key, x):
    """iaa.EdgeDetect(alpha=(0,1))."""
    alpha = _u(key, x.shape[0], 0.0, 1.0)
    edge = torch.clamp(torch.abs(_conv3x3(x, _const("edge", x))), 0, 1)
    return x * (1 - alpha) + edge * alpha


# the 8 neighbour cells of a 3x3 kernel, (x, y) offsets in row-major order
_DED_CELLS = np.array([(xx, yy) for yy in (-1, 0, 1) for xx in (-1, 0, 1)
                       if not (xx == 0 and yy == 0)], np.float32)
_DED_CELLS_N = _DED_CELLS / np.linalg.norm(_DED_CELLS, axis=1, keepdims=True)


def directed_edge_kernel(alpha: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The imgaug DirectedEdgeDetect kernel (see the JAX function): centre 1,
    neighbours ``-alpha * w`` with ``w`` the normalised angular similarity.
    alpha, direction: (B,) in [0,1]. Returns (B, 3, 3)."""
    deg = torch.floor(direction * 360.0) % 360.0
    rad = torch.deg2rad(deg)
    dvec = torch.stack([torch.cos(rad - 0.5 * np.pi), torch.sin(rad - 0.5 * np.pi)], dim=-1)
    cells = _const("ded_cells", alpha)                                # (8, 2)
    cos = torch.clamp(dvec[:, None, 0] * cells[:, 0] + dvec[:, None, 1] * cells[:, 1],
                      -1.0, 1.0)                                      # (B, 8)
    dist = torch.rad2deg(torch.arccos(cos)) / 180.0
    sim = (1.0 - dist) ** 4
    sim = sim / torch.sum(sim, dim=-1, keepdim=True)
    w = -alpha[:, None] * sim
    b = alpha.shape[0]
    rows = [w[:, 0:3],
            torch.stack([w[:, 3], torch.ones((b,), device=w.device), w[:, 4]], dim=-1),
            w[:, 5:8]]
    return torch.stack(rows, dim=-2)


def op_directed_edge_detect(key, x):
    """iaa.DirectedEdgeDetect(alpha=(0,1), direction=(0,1))."""
    k1, k2 = key.split()
    b = x.shape[0]
    alpha = k1.uniform((b,))
    direction = k2.uniform((b,))
    kern = directed_edge_kernel(alpha, direction)
    return torch.clamp(_conv3x3(x, kern), 0, 1)


_EDGE_ENHANCE_MORE = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)
_CONTOUR = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float32)


def op_edge_enhance_more(key, x):
    """iaa.pillike.FilterEdgeEnhanceMore (PIL EDGE_ENHANCE_MORE kernel)."""
    del key
    return torch.clamp(_conv3x3(x, _const("edge_enhance_more", x)), 0, 1)


def op_contour(key, x):
    """iaa.pillike.FilterContour (PIL CONTOUR: 8-neighbour kernel, offset 255)."""
    del key
    return torch.clamp(_conv3x3(1.0 - x, _const("contour", x)), 0, 1)


ARITHMETIC_OPS: List[Op] = [
    op_add_elementwise, op_additive_gaussian, op_additive_laplace,
    op_additive_poisson, op_multiply, op_multiply_elementwise, op_dropout,
    op_coarse_dropout, op_dropout2d, op_impulse_noise, op_salt_and_pepper,
    op_salt, op_pepper, op_invert, op_solarize, op_jpeg_compression,
    op_emboss, op_edge_detect, op_directed_edge_detect, op_edge_enhance_more,
    op_contour,
]


# ------------------------------------------------------------------ colour

def op_hue_add(key, x, add=(0, 50)):
    """WithColorspace(HSV, WithChannels(0, Add((0,50)))): OpenCV H is
    0..179, so the add is delta/180 of a full turn."""
    b = x.shape[0]
    delta = key.uniform((b, 1, 1), add[0] / 180, add[1] / 180)
    hsv = _rgb_to_hsv(x)
    return _hsv_to_rgb(_with_channel(hsv, 0, hsv[..., 0] + delta))


def op_hue_add_strong(key, x):
    """Sequential(RGB->HSV, H += (50,100), HSV->RGB)."""
    return op_hue_add(key, x, add=(50, 100))


def op_multiply_and_add_to_brightness(key, x):
    """iaa.MultiplyAndAddToBrightness(mul=(0.5,1.5), add=(-30,30)) on V."""
    k1, k2 = key.split()
    b = x.shape[0]
    mul = k1.uniform((b, 1, 1), 0.5, 1.5)
    add = k2.uniform((b, 1, 1), -30 / 255, 30 / 255)
    hsv = _rgb_to_hsv(x)
    v = torch.clamp(hsv[..., 2] * mul + add, 0, 1)
    return _hsv_to_rgb(_with_channel(hsv, 2, v))


def op_multiply_brightness(key, x):
    """iaa.MultiplyBrightness((0.5, 1.5))."""
    mul = key.uniform((x.shape[0], 1, 1), 0.5, 1.5)
    hsv = _rgb_to_hsv(x)
    return _hsv_to_rgb(_with_channel(hsv, 2, torch.clamp(hsv[..., 2] * mul, 0, 1)))


def op_multiply_hue_saturation(key, x):
    """iaa.MultiplyHueAndSaturation((0.5,1.5), per_channel=True)."""
    k1, k2 = key.split()
    b = x.shape[0]
    mh = k1.uniform((b, 1, 1), 0.5, 1.5)
    ms = k2.uniform((b, 1, 1), 0.5, 1.5)
    hsv = _rgb_to_hsv(x)
    hsv = _with_channel(hsv, 0, hsv[..., 0] * mh)
    hsv = _with_channel(hsv, 1, torch.clamp(hsv[..., 1] * ms, 0, 1))
    return _hsv_to_rgb(hsv)


def op_add_hue_saturation(key, x):
    """iaa.AddToHueAndSaturation((-50,50), per_channel=True): H delta/180,
    S delta/255."""
    k1, k2 = key.split()
    b = x.shape[0]
    dh = k1.uniform((b, 1, 1), -50 / 180, 50 / 180)
    ds = k2.uniform((b, 1, 1), -50 / 255, 50 / 255)
    hsv = _rgb_to_hsv(x)
    hsv = _with_channel(hsv, 0, hsv[..., 0] + dh)
    hsv = _with_channel(hsv, 1, torch.clamp(hsv[..., 1] + ds, 0, 1))
    return _hsv_to_rgb(hsv)


def op_grayscale(key, x):
    """iaa.Grayscale(alpha=(0.0, 1.0))."""
    alpha = _u(key, x.shape[0], 0.0, 1.0)
    return x * (1 - alpha) + _luma(x) * alpha


def op_kmeans_color_quantization(key, x, n_iters=4):
    """iaa.KMeansColorQuantization(): joint-RGB Lloyd with k ~ U{2..16},
    initialised from random pixels. Cluster sums by scatter-add and the
    final lookup by gather (JAX: one-hot products)."""
    k1, k2, _k3 = key.split(3)
    b, h, w, c = x.shape
    kmax = 16
    flat = x.reshape(b, h * w, c)
    idx = k1.randint((b, kmax), 0, h * w)
    centers = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))   # (B, K, 3)
    k_eff = k2.randint((b, 1), 2, kmax + 1)
    slot_ok = torch.arange(kmax, device=x.device)[None] < k_eff        # (B, K)

    def assign_to(centers):
        d = torch.sum((flat[:, :, None] - centers[:, None]) ** 2, dim=-1)
        return torch.argmin(torch.where(slot_ok[:, None], d, float("inf")), dim=-1)  # (B, HW)

    for _ in range(n_iters):
        assign = assign_to(centers)
        counts = torch.zeros((b, kmax), device=x.device).scatter_add_(
            1, assign, torch.ones_like(flat[..., 0]))[..., None]
        sums = torch.zeros((b, kmax, c), device=x.device).scatter_add_(
            1, assign[..., None].expand(-1, -1, c), flat)
        centers = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centers)
    out = torch.gather(centers, 1, assign_to(centers)[..., None].expand(-1, -1, c))
    return out.reshape(b, h, w, c)


def op_uniform_color_quantization(key, x):
    """iaa.UniformColorQuantization(): k ~ U{2..16} uniform levels/channel."""
    b = x.shape[0]
    k = key.randint((b, 1, 1, 1), 2, 17).to(x.dtype)
    return torch.clamp(torch.round(x * (k - 1)) / torch.clamp_min(k - 1, 1), 0, 1)


def _kelvin_to_rgb(t):
    """Tanner Helland blackbody approximation; t (B,) kelvin -> (B,3) [0,1]."""
    t = t / 100.0
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    r = torch.where(t <= 66, one,
                    torch.clamp(1.292936 * torch.clamp_min(t - 60, 1e-3) ** -0.1332047, 0, 1))
    g = torch.where(t <= 66,
                    torch.clamp(0.3900816 * torch.log(torch.clamp_min(t, 1e-3)) - 0.6318414, 0, 1),
                    torch.clamp(1.1298909 * torch.clamp_min(t - 60, 1e-3) ** -0.0755148, 0, 1))
    b = torch.where(t >= 66, one,
                    torch.where(t <= 19, zero,
                                torch.clamp(0.5432068 * torch.log(torch.clamp_min(t - 10, 1e-3))
                                            - 1.1962541, 0, 1)))
    return torch.stack([r, g, b], -1)


def op_change_color_temperature(key, x):
    """iaa.ChangeColorTemperature((1100, 10000))."""
    t = key.uniform((x.shape[0],), 1100.0, 10000.0)
    rgb = _kelvin_to_rgb(t)[:, None, None]
    return torch.clamp(x * rgb, 0, 1)


COLOR_OPS: List[Op] = [
    op_hue_add, op_multiply_and_add_to_brightness, op_multiply_hue_saturation,
    op_add_hue_saturation, op_hue_add_strong, op_grayscale,
    op_kmeans_color_quantization, op_uniform_color_quantization,
    op_change_color_temperature,
]


# ------------------------------------------------------------------ blur

def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, taps: int = 5) -> torch.Tensor:
    """Separable per-sample gaussian blur; sigma (B,) or (B,1,1,1)."""
    b, h, w, _ = x.shape
    r = taps // 2
    offsets = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    sig = torch.clamp_min(sigma.reshape(b, 1), 1e-3)
    k = torch.exp(-0.5 * (offsets[None, :] / sig) ** 2)
    k = k / k.sum(dim=1, keepdim=True)
    kt = [k[:, t, None, None, None] for t in range(taps)]
    xp = _pad_edge(x, r, r, 0, 0)
    x = sum(kt[t] * xp[:, t:t + h] for t in range(taps))
    xp = _pad_edge(x, 0, 0, r, r)
    return sum(kt[t] * xp[:, :, t:t + w] for t in range(taps))


def op_sharpen(key, x):
    """iaa.Sharpen(alpha=(0,0.5), lightness=(0,0.5)): PIL-style kernel
    [[-1,-1,-1],[-1,8+l,-1],[-1,-1,-1]] blended by alpha."""
    k1, k2 = key.split()
    b = x.shape[0]
    light = k1.uniform((b,), 0.0, 0.5)
    alpha = _u(k2, b, 0.0, 0.5)
    kern = _const("sharpen", x)[None] + light[:, None, None] * _const("centre", x)
    sharp = torch.clamp(_conv3x3(x, kern), 0, 1)
    return x * (1 - alpha) + sharp * alpha


def op_gaussian_blur(key, x):
    """iaa.GaussianBlur((0.5, 1.5))."""
    sigma = key.uniform((x.shape[0],), 0.5, 1.5)
    return gaussian_blur(x, sigma)


def op_average_blur(key, x):
    """iaa.AverageBlur(k=(2, 6)): cv2.blur with the per-sample k in
    {2, ..., 6}, cv2's anchor k//2 for even k; separable sliding sums, edge
    padding."""
    b, h, w, _ = x.shape
    ks = (2, 3, 4, 5, 6)

    def box(k):
        a = k // 2
        lp, rp = a, k - a - 1
        xp = _pad_edge(x, lp, rp, 0, 0)
        rows = sum(xp[:, i:i + h] for i in range(k)) / k
        xp2 = _pad_edge(rows, 0, 0, lp, rp)
        return sum(xp2[:, :, j:j + w] for j in range(k)) / k

    outs = torch.stack([box(k) for k in ks])
    kk = key.randint((b,), ks[0], ks[-1] + 1)
    return _select(outs, kk - ks[0])


def _med3(a, b, c):
    return torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))


def _med5(a, b, c, d, e):
    f = torch.maximum(torch.minimum(a, b), torch.minimum(c, d))
    g = torch.minimum(torch.maximum(a, b), torch.maximum(c, d))
    return _med3(e, f, g)


def _median3x3(x):
    """Exact 3x3 median via the 19-exchange min/max network."""
    b, h, w, _ = x.shape
    xp = _pad_edge(x, 1, 1, 1, 1)
    v = [xp[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    # directional exchanges: min lands at i, max at j ((4,2) is not (2,4))
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def _axis_taps(x, k, axis):
    """k edge-padded shifted views of x along spatial axis 1 or 2."""
    r = k // 2
    n = x.shape[axis]
    xp = _pad_edge(x, r, r, 0, 0) if axis == 1 else _pad_edge(x, 0, 0, r, r)
    return [xp.narrow(axis, t, n) for t in range(k)]


def _median5_axis(x, axis):
    return _med5(*_axis_taps(x, 5, axis))


def _med7(*v):
    """Median of 7 via Devillard's 13-exchange network (opt_med7)."""
    v = list(v)
    for i, j in ((0, 5), (0, 3), (1, 6), (2, 4), (0, 1), (3, 5), (2, 6),
                 (2, 3), (3, 6), (4, 5), (1, 4), (1, 3), (3, 4)):
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[3]


def _median7_axis(x, axis):
    return _med7(*_axis_taps(x, 7, axis))


def op_median_blur(key, x):
    """iaa.MedianBlur(k=(3, 7)): per-sample k from {3..7}, even draws bumped
    to the next odd; k=3 exact 2-D median, k=5/7 separable medians."""
    b = x.shape[0]
    kk = key.randint((b,), 3, 8)
    kk = kk + (kk % 2 == 0).to(kk.dtype)
    m3 = _median3x3(x)
    m5 = _median5_axis(_median5_axis(x, 2), 1)
    m7 = _median7_axis(_median7_axis(x, 2), 1)
    return _select(torch.stack([m3, m5, m7]), (kk - 3) // 2)


def motion_blur_kernel(angle_deg: torch.Tensor, direction: torch.Tensor, k: int = 5
                       ) -> torch.Tensor:
    """Per-sample k x k motion-blur kernels, imgaug construction with both
    uint8 quantisation steps (see the JAX function). (B,) x2 -> (B, k, k)."""
    r = k // 2
    dev = angle_deg.device
    d = (torch.clamp(direction, -1.0, 1.0) + 1.0) / 2.0
    wline = d[:, None] + (1.0 - 2.0 * d[:, None]) * (
        torch.arange(k, dtype=angle_deg.dtype, device=dev) / (k - 1))
    wline = torch.floor(wline * 255.0 + 1e-3) / 255.0
    theta = angle_deg * (np.pi / 180.0)
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    offs = torch.arange(k, dtype=angle_deg.dtype, device=dev) - r
    cy, cx = torch.meshgrid(offs, offs, indexing="ij")
    sy = c * cy - s * cx
    sx = s * cy + c * cx

    def tri(t):
        return torch.clamp_min(1.0 - torch.abs(t), 0.0)

    row = torch.sum(wline[:, None, None, :] * tri(sy[..., None] - offs), dim=-1)
    kern = tri(sx) * row
    kern = torch.round(kern * 255.0) / 255.0
    return kern / torch.sum(kern, dim=(1, 2), keepdim=True)


def op_motion_blur(key, x, k=5):
    """iaa.MotionBlur(k=5, angle=(0, 360), direction=(-1.0, 1.0)): the
    per-sample rotated line kernel as 25 shifted multiply-adds, edge padding."""
    b, h, w, _ = x.shape
    k1, k2 = key.split()
    angle = k1.uniform((b,), 0.0, 360.0)
    direction = k2.uniform((b,), -1.0, 1.0)
    kern = motion_blur_kernel(angle, direction, k).to(x.dtype)
    r = k // 2
    xp = _pad_edge(x, r, r, r, r)
    out = torch.zeros_like(x)
    for i in range(k):
        for j in range(k):
            out = out + kern[:, i, j, None, None, None] * xp[:, i:i + h, j:j + w]
    return out


def bilateral_filter(x: torch.Tensor, sigma_color: torch.Tensor, sigma_space: torch.Tensor,
                     radius=2, max_radius: int = None) -> torch.Tensor:
    """True bilateral filter with cv2 semantics on a disc window.

    ``radius``: an int, or a per-sample (B, 1, 1, 1) integer tensor bounded
    by ``max_radius``; sigmas: (B, 1, 1, 1) in 8-bit units. A CUDA tensor goes
    through the hand-written kernel K3, a CPU tensor through its plain
    version (``ccd_tpu_torch/ops/bilateral.py``)."""
    b = x.shape[0]
    per_sample = not isinstance(radius, int)
    r = int(max_radius) if per_sample else radius
    rad2 = ((radius * radius).to(x.dtype) if per_sample
            else torch.full((b, 1, 1, 1), float(r * r), dtype=x.dtype, device=x.device))
    return bilateral_filter_fused(x, sigma_color, sigma_space, rad2, r)


def op_bilateral_blur(key, x):
    """iaa.BilateralBlur(d=(3,10), sigma_color=(10,250), sigma_space=(10,250))
    with the per-sample diameter d ~ DiscreteUniform(3, 10) and cv2's
    ``radius = d // 2``."""
    k1, k2, k3 = key.split(3)
    b = x.shape[0]
    sc = _u(k1, b, 10.0, 250.0)
    ss = _u(k2, b, 10.0, 250.0)
    d = k3.randint((b, 1, 1, 1), 3, 11)
    return bilateral_filter(x, sc, ss, radius=d // 2, max_radius=5)


BLUR_KINDS: List[Op] = [op_gaussian_blur, op_average_blur, op_median_blur, op_motion_blur]


def blur_family(key, x, kinds: Sequence[Op] = None):
    """OneOf([Sharpen, OneOf([blur kinds])]) (augmentation_pipelines.py:164)."""
    kinds = list(kinds) if kinds is not None else BLUR_KINDS + [op_bilateral_blur]
    k1, k2, k3 = key.split(3)
    sharp = op_sharpen(k1, x)
    blur = one_of(k2, x, kinds)
    use_sharp = k3.bernoulli(0.5, (x.shape[0], 1, 1, 1))
    return torch.where(use_sharp, sharp, blur)


# ------------------------------------------------------------------ contrast

def op_gamma_contrast(key, x):
    """iaa.GammaContrast((0.5, 2.0))."""
    gamma = _u(key, x.shape[0], 0.5, 2.0)
    return torch.clamp(x, 0, 1) ** gamma


def op_linear_contrast(key, x):
    """iaa.LinearContrast((0.5, 1.0)): 127.5 + alpha*(I - 127.5)."""
    alpha = _u(key, x.shape[0], 0.5, 1.0)
    return torch.clamp(0.5 + alpha * (x - 0.5), 0, 1)


def op_sigmoid_contrast(key, x):
    """iaa.SigmoidContrast(gain=(3,10), cutoff=(0.4,0.6))."""
    k1, k2 = key.split()
    b = x.shape[0]
    gain = _u(k1, b, 3.0, 10.0)
    cutoff = _u(k2, b, 0.4, 0.6)
    return 1.0 / (1.0 + torch.exp(gain * (cutoff - x)))


def op_log_contrast(key, x):
    """iaa.LogContrast(gain=(0.6, 1.4)): gain * log2(1 + I)."""
    gain = _u(key, x.shape[0], 0.6, 1.4)
    return torch.clamp(gain * torch.log2(1.0 + x), 0, 1)


def _equalize(v: torch.Tensor) -> torch.Tensor:
    """Exact 256-bin histogram equalisation of (B, H, W) values in [0,1]:
    histogram by scatter-add, LUT lookup by gather (JAX: one-hot products)."""
    b, h, w = v.shape
    bins = torch.clamp((v * 255.0).to(torch.int64), 0, 255).reshape(b, -1)
    hist = torch.zeros((b, 256), device=v.device).scatter_add_(
        1, bins, torch.ones_like(bins, dtype=torch.float32))
    cdf = torch.cumsum(hist, dim=-1)
    first = torch.argmax((hist > 0).to(torch.int32), dim=-1, keepdim=True)
    cdf_min = torch.gather(cdf, 1, first)
    denom = torch.clamp_min(cdf[:, -1:] - cdf_min, 1.0)
    lut = torch.clamp((cdf - cdf_min) / denom, 0, 1)
    return torch.gather(lut, 1, bins).reshape(b, h, w)


def op_histogram_equalization(key, x):
    """iaa.HistogramEqualization(): equalise luminance, rescale RGB by the
    luminance ratio."""
    del key
    y = _luma(x)[..., 0]
    y_eq = _equalize(y)
    ratio = (y_eq / torch.clamp_min(y, 1e-3))[..., None]
    return torch.clamp(x * ratio, 0, 1)


def op_allchannels_histogram_equalization(key, x):
    """iaa.AllChannelsHistogramEqualization(): per-RGB-channel equalise."""
    del key
    return torch.stack([_equalize(x[..., c]) for c in range(3)], dim=-1)


def _clahe_taps(h: int, w: int, gh: int, gw: int):
    """Per pixel, the (at most 4) tiles of CLAHE's bilinear interpolation and
    their weights, merged where clamping sends two taps to one tile (as the
    JAX function's dense (H*W, tiles) matrix does): (4, H*W) each; the flat
    LUT offset ``tile * 256`` stands in for the tile."""
    th, tw = h // gh, w // gw
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tyf = ys / th - 0.5
    txf = xs / tw - 0.5
    y0 = np.floor(tyf).astype(np.int64)
    x0 = np.floor(txf).astype(np.int64)
    fy = (tyf - y0).astype(np.float32)
    fx = (txf - x0).astype(np.float32)
    wmat = np.zeros((h * w, gh * gw), np.float32)
    flat = np.arange(h * w)
    for oy, wy in ((0, 1.0 - fy), (1, fy)):
        for ox, wx in ((0, 1.0 - fx), (1, fx)):
            ty = np.clip(y0 + oy, 0, gh - 1)
            tx = np.clip(x0 + ox, 0, gw - 1)
            np.add.at(wmat, (flat, (ty * gw + tx).ravel()), (wy * wx).ravel())
    index = np.zeros((4, h * w), np.int64)
    weight = np.zeros((4, h * w), np.float32)
    for p in range(h * w):
        nz = np.nonzero(wmat[p])[0]
        index[:len(nz), p] = nz
        weight[:len(nz), p] = wmat[p, nz]
    return index * 256, weight


def clahe_gray(v: torch.Tensor, clip_limit: torch.Tensor, grid=(8, 8)) -> torch.Tensor:
    """Tiled CLAHE with cv2 semantics (see the JAX function): per-tile
    256-bin histograms, cv2's clip and excess redistribution, LUT =
    round(cdf * 255 / area), bilinear interpolation between the 4 nearest
    tiles' LUTs. v: (B, H, W) in [0,1]; clip_limit: (B,)."""
    b, h, w = v.shape
    gh, gw = grid
    th, tw = h // gh, w // gw
    if th * gh != h or tw * gw != w:
        raise ValueError(f"CLAHE needs H, W divisible by the {gh}x{gw} grid, got {h}x{w}")
    area = float(th * tw)
    n_tiles = gh * gw
    bins = torch.clamp(torch.round(v * 255.0).to(torch.int64), 0, 255)
    tiles = bins.reshape(b, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(b, n_tiles, th * tw)
    hist = torch.zeros((b, n_tiles, 256), device=v.device).scatter_add_(
        2, tiles, torch.ones_like(tiles, dtype=torch.float32))

    clip = torch.clamp_min(torch.floor(clip_limit[:, None, None] * area / 256.0), 1.0)
    excess = torch.sum(torch.clamp_min(hist - clip, 0.0), dim=-1, keepdim=True)
    hist = torch.minimum(hist, clip)
    batch_incr = torch.floor(excess / 256.0)
    residual = excess - batch_incr * 256.0
    hist = hist + batch_incr
    step = torch.clamp_min(torch.floor(256.0 / torch.clamp_min(residual, 1.0)), 1.0)
    iota = torch.arange(256, dtype=torch.float32, device=v.device)
    bump = ((torch.remainder(iota, step) == 0.0)
            & (torch.floor(iota / step) < residual)).to(torch.float32)
    hist = hist + bump

    cdf = torch.cumsum(hist, dim=-1)
    lut = torch.clamp(torch.round(cdf * (255.0 / area)), 0.0, 255.0).reshape(b, n_tiles * 256)
    offsets, weight = device_constant(_clahe_taps, v.device, h, w, gh, gw)
    flat_bins = bins.reshape(b, h * w)
    out = None
    for off, wt in zip(offsets, weight):
        term = torch.gather(lut, 1, off[None] + flat_bins) * wt[None]
        out = term if out is None else out + term
    return torch.clamp(torch.round(out), 0.0, 255.0).reshape(b, h, w) / 255.0


def op_clahe(key, x):
    """iaa.CLAHE(clip_limit=(0.1, 8), 8x8 tiles) on the 8-bit Lab L channel
    (imgaug's Lab round trip, a/b rounded to uint8 as well), then back."""
    b = x.shape[0]
    clip_limit = key.uniform((b,), 0.1, 8.0)
    lum, a_ch, b_ch = _rgb_to_lab(x)
    l8 = torch.clamp(torch.round(lum * (255.0 / 100.0)), 0.0, 255.0)
    a8 = torch.clamp(torch.round(a_ch + 128.0), 0.0, 255.0)
    b8 = torch.clamp(torch.round(b_ch + 128.0), 0.0, 255.0)
    l_eq = clahe_gray(l8 / 255.0, clip_limit) * 255.0
    return _lab_to_rgb(l_eq * (100.0 / 255.0), a8 - 128.0, b8 - 128.0)


def op_allchannels_clahe(key, x):
    """iaa.AllChannelsCLAHE(clip_limit=(0.1, 8)): CLAHE per RGB channel, as
    one batched call over (3B, H, W)."""
    b, h, w, _ = x.shape
    clip_limit = key.uniform((b,), 0.1, 8.0)
    xc = x.permute(0, 3, 1, 2).reshape(3 * b, h, w)
    # each limit three times in a row (repeat_interleave would wait for the
    # card to size its output)
    out = clahe_gray(xc, clip_limit[:, None].expand(b, 3).reshape(3 * b))
    return out.reshape(b, 3, h, w).permute(0, 2, 3, 1)


CONTRAST_OPS: List[Op] = [
    op_gamma_contrast, op_linear_contrast, op_sigmoid_contrast,
    op_log_contrast, op_histogram_equalization,
    op_allchannels_histogram_equalization, op_clahe, op_allchannels_clahe,
]


# ------------------------------------------------------------------ weather

def op_fog(key, x):
    """iaa.Fog(): blend toward white with a smooth density field."""
    k1, k2 = key.split()
    b, h, w, _ = x.shape
    field = _smooth_field(k1, b, h, w, x.device, octaves=((2, 4), (4, 8)), method="cubic")
    density = torch.clamp(field * 0.5 + _u(k2, b, 0.3, 0.7), 0, 1)
    return x * (1 - density) + 1.0 * density


def op_clouds(key, x):
    """iaa.Clouds(): additive bright low-frequency layer."""
    k1, k2 = key.split()
    b, h, w, _ = x.shape
    field = torch.clamp_min(_smooth_field(k1, b, h, w, x.device, octaves=((2, 6), (4, 12)),
                                          method="cubic"), 0)
    amp = _u(k2, b, 0.2, 0.5)
    return torch.clamp(x + field * amp, 0, 1)


def op_snowflakes(key, x):
    """iaa.Snowflakes(flake_size=(0.1,0.4), speed=(0.01,0.05)): sparse white
    flakes with short fall streaks."""
    k1, k2, k3 = key.split(3)
    b, h, w, _ = x.shape
    density = _u(k1, b, 0.005, 0.03)
    flakes = (k2.uniform((b, h, w, 1)) < density).to(x.dtype)
    fp = F.pad(flakes, (0, 0, 0, 0, 2, 0))          # 2 zero rows on top
    streak = torch.clamp(fp[:, 2:] + 0.7 * fp[:, 1:h + 1] + 0.4 * fp[:, :h], 0, 1)
    strength = _u(k3, b, 0.5, 0.9)
    return torch.clamp(x + streak * strength, 0, 1)


def op_rain(key, x):
    """iaa.Rain(speed=(0.1,0.3)): sparse diagonal bright streaks."""
    k1, k2, k3 = key.split(3)
    b, h, w, _ = x.shape
    density = _u(k1, b, 0.002, 0.01)
    drops = (k2.uniform((b, h, w, 1)) < density).to(x.dtype)
    dp = F.pad(drops, (0, 0, 0, 4, 4, 0))           # 4 zero rows on top, 4 columns right
    streak = sum(dp[:, 4 - t:4 - t + h, 4 - t:4 - t + w] * (1 - 0.18 * t) for t in range(5))
    streak = torch.clamp(streak, 0, 1)
    alpha = _u(k3, b, 0.3, 0.6)
    return torch.clamp(x + streak * alpha * 0.7, 0, 1)


WEATHER_OPS: List[Op] = [op_fog, op_clouds, op_snowflakes, op_rain]

# ------------------------------------------------------------------ misc

def op_channel_shuffle(key, x, p=0.35):
    """iaa.ChannelShuffle(0.35): with prob p permute the RGB channels, the
    permutation an argsort of uniforms. Applied as a gather, which moves the
    pixel values exactly (the JAX op multiplies by a one-hot matrix at
    HIGHEST precision for the same reason)."""
    k1, k2 = key.split(2)
    b = x.shape[0]
    perm = torch.argsort(k1.uniform((b, 3)), dim=-1, stable=True)      # (B, 3)
    shuffled = torch.gather(x, -1, perm[:, None, None, :].expand(x.shape))
    gate = k2.bernoulli(p, (b, 1, 1, 1))
    return torch.where(gate, shuffled, x)


_TABLES = {"lab_white": _LAB_WHITE, "dct8": _DCT8, "q_luma": _Q_LUMA, "q_chroma": _Q_CHROMA,
           "edge": _EDGE_KERNEL, "ded_cells": _DED_CELLS_N,
           "edge_enhance_more": _EDGE_ENHANCE_MORE, "contour": _CONTOUR,
           "sharpen": np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float32),
           "centre": np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32)}
