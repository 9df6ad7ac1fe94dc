"""The port's attention (plain versions, the CPU path of the wrappers)
against the JAX package's Pallas kernels run in interpret mode, forward and
backward: the packed layout (K1, ``mha_packed_bias``) and the folded and
(B, S, H, D) layouts (K1b, ``flash_attention`` and ``mha``).

Tolerance 2e-5 absolute on O(1) outputs in fp32: the two sides sum the same
products in a different order. Gradients: 1e-4 (they sum over 256 rows).
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import ccd_tpu.ops.flash_attention as fa
from ccd_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
GRAD_ATOL = 1e-4
SHAPES = [(2, 32, 3, 8), (2, 256, 2, 32)]  # (b, s, h, d)
FOLDED = [(4, 64, 32), (2, 32, 16)]       # (bh, s, d)


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


def _jax_grads(qkv, bias, w, scale, h):
    """jax.grad of sum(out * w) through the interpreted Pallas kernels."""
    loss = lambda a, b: jnp.sum(fa.mha_packed_bias(a, b, scale, h) * w)
    dq, db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    return np.asarray(dq), np.asarray(db)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_flows_through_the_wrapper_and_matches_pallas(interpret_mode, shape):
    """The wrapper on CPU tensors that require grad is differentiable (it was
    forward-only once): dqkv and dbias of its autograd.Function equal
    jax.grad of the Pallas kernel."""
    b, s, h, d = shape
    qkv, bias, scale = _inputs(b, s, h, d, 4)
    w = np.random.default_rng(5).normal(size=(b, s, h * d)).astype(np.float32)
    ref_dqkv, ref_dbias = _jax_grads(qkv, bias, w, scale, h)
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = tfa.mha_packed_bias(tq, tb, scale, h)
    assert out.requires_grad
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), ref_dqkv, atol=GRAD_ATOL)
    np.testing.assert_allclose(tb.grad.numpy(), ref_dbias, atol=GRAD_ATOL * 10)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_and_autograd(interpret_mode, shape):
    """The written-out backward equals jax.grad of the Pallas kernel and
    autograd through the plain forward; dbias is its sum over B and S."""
    b, s, h, d = shape
    qkv, bias, scale = _inputs(b, s, h, d, 6)
    w = np.random.default_rng(7).normal(size=(b, s, h * d)).astype(np.float32)
    ref_dqkv, ref_dbias = _jax_grads(qkv, bias, w, scale, h)
    dqkv = tfa.mha_packed_bias_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(bias),
                                         torch.from_numpy(w), scale, h)
    np.testing.assert_allclose(dqkv.numpy(), ref_dqkv, atol=GRAD_ATOL)
    np.testing.assert_allclose(dqkv.sum((0, 1)).numpy(), ref_dbias, atol=GRAD_ATOL * 10)
    tq = torch.from_numpy(qkv).requires_grad_()
    (tfa.mha_packed_bias_plain(tq, torch.from_numpy(bias), scale, h)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(dqkv.numpy(), tq.grad.numpy(), atol=GRAD_ATOL)
    # the wrapper on a CPU tensor is the plain version
    dq_w = tfa.mha_packed_bias_bwd(torch.from_numpy(qkv), torch.from_numpy(bias),
                                   torch.from_numpy(w), scale, h)
    np.testing.assert_array_equal(dq_w.numpy(), dqkv.numpy())


def test_mha_packed_gradient_without_bias(interpret_mode):
    """mha_packed (no bias) is differentiable too and matches the Pallas
    kernel fed a zero bias."""
    qkv, _, scale = _inputs(2, 64, 2, 32, 8)
    w = np.random.default_rng(9).normal(size=(2, 64, 64)).astype(np.float32)
    ref_dqkv, _ = _jax_grads(qkv, np.zeros(192, np.float32), w, scale, 2)
    tq = torch.from_numpy(qkv).requires_grad_()
    (tfa.mha_packed(tq, scale, 2) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), ref_dqkv, atol=GRAD_ATOL)


def test_bf16_plain_backward_rounds_like_the_kernel():
    """bf16 inputs: fp32 softmax and dP, dS rounded to bf16 before the dq and
    dk products, P rounded before dv, fp32 accumulation, one rounding of the
    result — spelled out here so the plain version cannot drift."""
    qkv, bias, scale = _inputs(2, 64, 2, 32, 10)
    do = np.random.default_rng(11).normal(size=(2, 64, 64)).astype(np.float32)
    tq, tb, tdo = (torch.from_numpy(a).bfloat16() for a in (qkv, bias, do))
    out = tfa.mha_packed_bias_bwd_plain(tq, tb, tdo, scale, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 192)
    x = (tq + tb).float().view(2, 64, 3, 2, 32)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    g = tdo.float().view(2, 64, 2, 32).permute(0, 2, 1, 3)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    dp = g @ v.transpose(-1, -2)
    ds = ((p * (dp - (dp * p).sum(-1, keepdim=True))) * scale).bfloat16().float()
    want = torch.stack([ds @ k, ds.transpose(-1, -2) @ q,
                        p.bfloat16().float().transpose(-1, -2) @ g]).bfloat16()
    want = want.permute(1, 3, 0, 2, 4).reshape(2, 64, 192)
    # 1 bf16 ulp at O(4): the same fp32 sums may round across a tie differently
    np.testing.assert_allclose(out.float().numpy(), want.float().numpy(), atol=2 ** -6)


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
    tfa.mha_packed(torch.from_numpy(qkv).requires_grad_(), scale, 2).sum().backward()
    q = torch.randn(2, 64, 32, requires_grad=True)
    tfa.flash_attention(q, q, q, 0.2).sum().backward()
    q4 = torch.randn(1, 64, 2, 32, requires_grad=True)
    tfa.mha(q4, q4, q4, 0.2).sum().backward()
    assert "ccd_tpu_torch.ops._build" not in sys.modules
    assert tfa.mha_packed_bias.launches == before
    assert tfa.mha_packed_bias_bwd.launches == 0
    assert tfa.flash_attention.launches == tfa.flash_attention_bwd.launches == 0
    assert tfa.mha.launches == 0



# ------------------------------------------------- K1b: folded and (B, S, H, D)

def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]  # q, k, v, w


def _jax_flash_grads(jfn, q, k, v, w, scale):
    loss = lambda a, b, c: jnp.sum(jfn(a, b, c, scale) * w)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("layout,shape", [("folded", s) for s in FOLDED] +
                         [("bshd", (2, 16, 3, 8))], ids=lambda x: str(x))
def test_k1b_matches_pallas_forward_and_backward(interpret_mode, layout, shape):
    """flash_attention on (BH, S, D) and mha on (B, S, H, D): the forward, the
    written-out backward and autograd through the wrapper, against the Pallas
    kernels (mha through its transposes in JAX, none here)."""
    jfn, tfn = (fa.flash_attention, tfa.flash_attention) if layout == "folded" else \
        (fa.mha, tfa.mha)
    q, k, v, w = _qkv(shape, 12)
    scale = shape[-1] ** -0.5
    ref = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    plain = tfa.flash_attention_plain(tq, tk, tv, scale)
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL)
    ref_grads = _jax_flash_grads(jfn, q, k, v, w, scale)
    written = tfa.flash_attention_bwd_plain(tq, tk, tv, tw, scale)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfn(*leaves, scale)
    # the wrapper on a CPU tensor is the plain version, forward and backward
    np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())
    (out * tw).sum().backward()
    wrapper_bwd = tfa.flash_attention_bwd(tq, tk, tv, tw, scale)
    for name, want, got, leaf, wb in zip("qkv", ref_grads, written, leaves, wrapper_bwd):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL, err_msg=f"d{name}")
        np.testing.assert_array_equal(leaf.grad.numpy(), got.numpy())
        np.testing.assert_array_equal(wb.numpy(), got.numpy())


def test_k1b_bf16_plain_rounds_like_the_kernel():
    """bf16 q, k, v: fp32 logits and softmax, p rounded before p @ v, one
    rounding of the output; in the backward dS rounded before dq and dk, p
    before dv. Spelled out here so the plain versions cannot drift."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv((3, 64, 32), 13))
    scale = 32 ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, do))
    p = torch.softmax(qf @ kf.transpose(-1, -2) * scale, -1)
    out = tfa.flash_attention_plain(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 64, 32)
    want = (p.bfloat16().float() @ vf).bfloat16()
    np.testing.assert_allclose(out.float().numpy(), want.float().numpy(), atol=8e-3)
    dp = gf @ vf.transpose(-1, -2)
    ds = ((p * (dp - (dp * p).sum(-1, keepdim=True))) * scale).bfloat16().float()
    wants = (ds @ kf, ds.transpose(-1, -2) @ qf, p.bfloat16().float().transpose(-1, -2) @ gf)
    for got, want in zip(tfa.flash_attention_bwd_plain(q, k, v, do, scale), wants):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.bfloat16().float().numpy(),
                                   atol=2 ** -6)
    # (B, S, H, D) is the folded computation on the heads, read where they lie
    q4, k4, v4 = (x.reshape(1, 3, 64, 32).permute(0, 2, 1, 3) for x in (q, k, v))
    np.testing.assert_array_equal(
        tfa.flash_attention_plain(q4, k4, v4, scale).permute(0, 2, 1, 3).reshape(3, 64, 32)
        .float().numpy(), out.float().numpy())


@pytest.mark.parametrize("bad", ["ndim", "shapes", "dtype", "mixed", "mha_3d"])
def test_k1b_wrappers_raise_on_wrong_input(bad):
    q = k = v = torch.zeros(2, 64, 32)
    fn = tfa.flash_attention
    if bad == "ndim":
        q = k = v = torch.zeros(64, 32)
    elif bad == "shapes":
        k = torch.zeros(2, 64, 16)
    elif bad == "dtype":
        q = k = v = q.double()
    elif bad == "mixed":
        v = v.bfloat16()
    elif bad == "mha_3d":
        fn = tfa.mha
    with pytest.raises((ValueError, TypeError)):
        fn(q, k, v, 0.125)
