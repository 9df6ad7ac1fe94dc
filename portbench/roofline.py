"""Published peaks of one NVIDIA H100 SXM (dense) and the least time a
kernel could take: its operations over the peak rate of its type against
its bytes over the memory rate, each input byte read once and each output
byte written once."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # tensor cores; fp32 outside them
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def roofline(nbytes: float, flops: float, dtype: str):
    """(least time in ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b: int, s: int, c: int, h: int, dtype: str, with_bias: bool):
    """K1's forward on the packed (B, S, 3C) projection: qkv (and its bias)
    read once, the (B, S, C) output written once; 4 S^2 D operations per
    head and batch row."""
    e = ELEMENT_BYTES[dtype]
    nbytes = (b * s * 3 * c + (3 * c if with_bias else 0) + b * s * c) * e
    return roofline(nbytes, 4 * s * s * (c // h) * h * b, dtype)


def attention_bwd_bound(b: int, s: int, c: int, h: int, dtype: str, with_bias: bool):
    """K1's backward: qkv and dO read once, dqkv written once; five products
    of 2 S^2 D operations per head and batch row."""
    e = ELEMENT_BYTES[dtype]
    nbytes = (2 * b * s * 3 * c + b * s * c + (3 * c if with_bias else 0)) * e
    return roofline(nbytes, 10 * s * s * (c // h) * h * b, dtype)
