"""The port's packed attention (plain version, the CPU path of the wrapper)
against the JAX package's Pallas kernel run in interpret mode.

Tolerance 2e-5 absolute on O(1) outputs in fp32: the two sides sum the same
products in a different order.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import ccd_tpu.ops.flash_attention as fa
from ccd_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
SHAPES = [(2, 32, 3, 8), (2, 256, 2, 32)]  # (b, s, h, d)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU in the test env)."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
    bias = (0.5 * rng.normal(size=(3 * h * d,))).astype(np.float32)
    return qkv, bias, d ** -0.5


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_with_bias(interpret_mode, shape):
    b, s, h, d = shape
    qkv, bias, scale = _inputs(b, s, h, d, 0)
    ref = np.asarray(fa.mha_packed_bias(jnp.asarray(qkv), jnp.asarray(bias), scale, h))
    out = tfa.mha_packed_bias_plain(torch.from_numpy(qkv), torch.from_numpy(bias), scale, h)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # the wrapper on a CPU tensor is the plain version
    out_w = tfa.mha_packed_bias(torch.from_numpy(qkv), torch.from_numpy(bias), scale, h)
    np.testing.assert_array_equal(out_w.numpy(), out.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_mha_packed_matches_pallas_zero_bias(interpret_mode, shape):
    b, s, h, d = shape
    qkv, _, scale = _inputs(b, s, h, d, 1)
    ref = np.asarray(fa.mha_packed(jnp.asarray(qkv), scale, h))
    out = tfa.mha_packed(torch.from_numpy(qkv), scale, h)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    zero = torch.zeros(3 * h * d)
    out_b = tfa.mha_packed_bias(torch.from_numpy(qkv), zero, scale, h)
    np.testing.assert_allclose(out_b.numpy(), out.numpy(), atol=1e-7)


def test_bf16_plain_casts_probabilities_like_the_kernel():
    """bf16 inputs: fp32 logits/softmax, p rounded to bf16 before p @ v, fp32
    accumulation, one rounding of the output — spelled out here in numpy-like
    torch so the plain version cannot drift from the kernel's arithmetic."""
    qkv, bias, scale = _inputs(2, 64, 2, 32, 2)
    tq = torch.from_numpy(qkv).bfloat16()
    tb = torch.from_numpy(bias).bfloat16()
    out = tfa.mha_packed_bias_plain(tq, tb, scale, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 64)
    x = (tq + tb).float().view(2, 64, 3, 2, 32)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1).bfloat16().float()
    want = (p @ v).bfloat16().permute(0, 2, 1, 3).reshape(2, 64, 64)
    # 1 bf16 ulp at O(1): the same fp32 sums may round across a tie differently
    np.testing.assert_allclose(out.float().numpy(), want.float().numpy(), atol=8e-3)


@pytest.mark.parametrize("bad", ["ndim", "not_3c", "heads", "dtype", "int", "bias_shape"])
def test_wrapper_raises_on_wrong_input(bad):
    qkv = torch.zeros(2, 64, 3 * 64)
    bias = torch.zeros(3 * 64)
    heads = 2
    if bad == "ndim":
        qkv = qkv[0]
    elif bad == "not_3c":
        qkv = torch.zeros(2, 64, 64 * 3 + 1)
    elif bad == "heads":
        heads = 5
    elif bad == "dtype":
        qkv = qkv.double()
    elif bad == "int":
        qkv = qkv.to(torch.int32)
    elif bad == "bias_shape":
        bias = torch.zeros(64)
    with pytest.raises((ValueError, TypeError)):
        tfa.mha_packed_bias(qkv, bias, 0.125, heads)


def test_cpu_path_does_not_touch_the_build_machinery():
    """A CPU tensor goes to the plain version: no library is built or loaded,
    and the launch counter stays where it was."""
    sys.modules.pop("ccd_tpu_torch.ops._build", None)
    before = tfa.mha_packed_bias.launches
    qkv, bias, scale = _inputs(1, 64, 2, 32, 3)
    tfa.mha_packed_bias(torch.from_numpy(qkv), torch.from_numpy(bias), scale, 2)
    tfa.mha_packed(torch.from_numpy(qkv), scale, 2)
    assert "ccd_tpu_torch.ops._build" not in sys.modules
    assert tfa.mha_packed_bias.launches == before
