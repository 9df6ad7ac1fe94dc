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
# (b, s, h, d); the last is vit_tiny's head layout (3 heads of 64) at S = 192,
# where the card's fp32 kernels run 64-row tiles with S % 128 != 0
SHAPES = [(2, 32, 3, 8), (2, 256, 2, 32), (1, 192, 3, 64)]
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
    """bf16 inputs: P from the saved log-sum-exp, delta from the saved bf16
    output less bv, dP without bv, dS rounded to bf16 before the dq and dk
    products, P rounded before dv, q + bq rounded once and k without bk,
    fp32 accumulation, one rounding of the result — spelled out here so the
    plain version cannot drift."""
    qkv, bias, scale = _inputs(2, 64, 2, 32, 10)
    do = np.random.default_rng(11).normal(size=(2, 64, 64)).astype(np.float32)
    tq, tb, tdo = (torch.from_numpy(a).bfloat16() for a in (qkv, bias, do))
    fwd, lse = tfa.mha_packed_bias_plain(tq, tb, scale, 2, return_lse=True)
    out = tfa.mha_packed_bias_bwd_plain(tq, tb, tdo, scale, 2, out=fwd, lse=lse)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 192)
    x = tq.view(2, 64, 3, 2, 32)
    bq, _, bv = tb.view(3, 2, 32)
    q = (x[:, :, 0] + bq).float().permute(0, 2, 1, 3)
    k, v = (x[:, :, i].float().permute(0, 2, 1, 3) for i in (1, 2))
    g = tdo.float().view(2, 64, 2, 32).permute(0, 2, 1, 3)
    o = (fwd.float().view(2, 64, 2, 32) - bv.float()).permute(0, 2, 1, 3)
    logits = q @ k.transpose(-1, -2) * scale
    np.testing.assert_allclose(lse.numpy(), (torch.logsumexp(logits, -1) / np.log(2)).numpy(),
                               rtol=1e-6, atol=1e-6)
    p = torch.exp2(logits / np.log(2) - lse[..., None])
    dp = g @ v.transpose(-1, -2)
    ds = (p * (dp - (g * o).sum(-1, keepdim=True)) * scale).bfloat16().float()
    want = torch.stack([ds @ k, ds.transpose(-1, -2) @ q,
                        p.bfloat16().float().transpose(-1, -2) @ g]).bfloat16()
    want = want.permute(1, 3, 0, 2, 4).reshape(2, 64, 192)
    # 1 bf16 ulp at O(4): the same fp32 sums may round across a tie differently
    np.testing.assert_allclose(out.float().numpy(), want.float().numpy(), atol=2 ** -6)
    # without the saved values the plain forward makes them: the same result
    assert torch.equal(tfa.mha_packed_bias_bwd_plain(tq, tb, tdo, scale, 2), out)


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
    # the backward: p from the base-2 log-sum-exp, delta from the bf16 output
    lse = torch.logsumexp(qf @ kf.transpose(-1, -2) * scale, -1) / np.log(2)
    p = torch.exp2(qf @ kf.transpose(-1, -2) * (scale / np.log(2)) - lse[..., None])
    dp = gf @ vf.transpose(-1, -2)
    ds = ((p * (dp - (gf * out.float()).sum(-1, keepdim=True))) * scale).bfloat16().float()
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


# ------------------------------------- the bf16 forward kernel's arithmetic, its limits, its build

MICRO = (2, 256, 2, 32)        # vit_micro's attention: embed 64, 2 heads, 8 x 32 patches
BF16_TOL = 2e-2                # chip_smoke.py's TOL for bf16: O(1) outputs, roundings at other points


def _folded_bias_forward(qkv, bias, scale, heads):
    """What the bf16 forward kernel computes, written out: q + bq rounded once
    to the input type; bk dropped (it adds (q + bq) . bk to every logit of a
    row, which the softmax cancels); unnormalised p = exp(logit - max) rounded
    to the input type before p @ v with fp32 accumulation; divided by the fp32
    row sum of p after the product; + bv (each row of p sums to 1); one
    rounding of the output."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)      # (B, H, S, D)
    bq, _, bv = bias.view(3, 1, heads, 1, d)
    logits = (q + bq).float() @ k.float().transpose(-1, -2) * scale
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = (p.to(qkv.dtype).float() @ v.float()) / p.sum(-1, keepdim=True) + bv.float()
    return out.to(qkv.dtype).permute(0, 2, 1, 3).reshape(b, s, c3 // 3)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), ("bfloat16", BF16_TOL)])
def test_folded_bias_algebra_matches_pallas(interpret_mode, dtype, atol):
    """Folding bk away and bv in after the normalisation is exact in real
    arithmetic: in fp32 it agrees with the Pallas kernel (which adds all three
    biases first) to float rounding; in bf16 within the kernel's tolerance,
    against the Pallas kernel and the port's plain version alike."""
    b, s, h, d = MICRO
    qkv, bias, scale = _inputs(b, s, h, d, 14)
    if dtype == "bfloat16":
        jq, jb = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
        tq, tb = (torch.from_numpy(a).bfloat16() for a in (qkv, bias))
    else:
        jq, jb = jnp.asarray(qkv), jnp.asarray(bias)
        tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    ref = np.asarray(fa.mha_packed_bias(jq, jb, scale, h).astype(jnp.float32))
    folded = _folded_bias_forward(tq, tb, scale, h)
    assert folded.dtype == tq.dtype
    np.testing.assert_allclose(folded.float().numpy(), ref, atol=atol)
    plain = tfa.mha_packed_bias_plain(tq, tb, scale, h)
    np.testing.assert_allclose(folded.float().numpy(), plain.float().numpy(), atol=atol)


def test_bk_drops_out_of_the_softmax():
    """The folded algebra's premise: a key bias shifts each row's logits by a
    constant, so the output does not depend on it (fp32: up to the rounding
    of the shifted logits)."""
    b, s, h, d = MICRO
    qkv, bias, scale = _inputs(b, s, h, d, 15)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    other = tb.clone()
    other[h * d:2 * h * d] = torch.from_numpy(np.random.default_rng(16).normal(
        size=h * d).astype(np.float32))
    np.testing.assert_allclose(tfa.mha_packed_bias_plain(tq, tb, scale, h).numpy(),
                               tfa.mha_packed_bias_plain(tq, other, scale, h).numpy(),
                               atol=1e-5)


def _packed(b, s, c3, dtype=torch.bfloat16):
    return torch.zeros(b, s, c3, dtype=dtype)


@pytest.mark.parametrize("case,ok", [
    ("d64", True), ("d32", True), ("long_s", True), ("d48", False), ("d128", False),
    ("s_not_64", False), ("not_contiguous", False), ("batch_65536", False), ("batch_65535", True)])
def test_packed_kernel_argument_limits(case, ok):
    """What the packed entry takes, checked before anything is built: D 32 or
    64, S a multiple of 64 and of any length (K and V stream through shared
    memory), a contiguous qkv, and at most 65535 batch rows (the grid's z)."""
    heads = 2
    qkv = {"d64": _packed(2, 64, 3 * 128), "d32": _packed(2, 64, 3 * 64),
           "long_s": _packed(1, 4096, 3 * 128), "d48": _packed(2, 64, 3 * 96),
           "d128": _packed(2, 64, 3 * 256), "s_not_64": _packed(2, 100, 3 * 128),
           "not_contiguous": _packed(2, 64, 3 * 256)[..., :3 * 128],
           "batch_65536": _packed(1, 64, 3 * 128).expand(65536, 64, 3 * 128),
           "batch_65535": None}[case]
    if case == "batch_65535":  # the largest batch the grid takes
        tfa._check_batch(65535)
        return
    bias = torch.zeros(qkv.shape[-1], dtype=torch.float32)
    if ok:
        out = tfa._kernel_args(qkv, bias, heads)
        assert out.dtype == qkv.dtype and out.is_contiguous()
    else:
        with pytest.raises(ValueError):
            tfa._kernel_args(qkv, bias, heads)


@pytest.mark.parametrize("case,ok", [
    ("folded_d64", True), ("folded_d32", True), ("bshd", True), ("long_s", True),
    ("d48", False), ("s_not_64", False), ("rows_not_16_bytes", False),
    ("d_not_contiguous", False), ("batch_65536", False)])
def test_strided_kernel_argument_limits(case, ok):
    """What the strided entry takes: D 32 or 64 and contiguous, S a multiple
    of 64, every batch, row and head stride a multiple of 16 bytes, at most
    65535 batch rows. (B, S, H, D) is read with its row stride and head
    offset as it lies."""
    z = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    q = {"folded_d64": z(4, 64, 64), "folded_d32": z(4, 128, 32), "bshd": z(2, 64, 3, 64),
         "long_s": z(1, 4096, 64), "d48": z(4, 64, 48), "s_not_64": z(4, 96, 64),
         "rows_not_16_bytes": z(4, 64, 36)[..., :32],
         "d_not_contiguous": z(4, 64, 64).transpose(1, 2),
         "batch_65536": z(1, 64, 64).expand(65536, 64, 64)}[case]
    named = (("q", q), ("k", q), ("v", q), ("out", q))
    if ok:
        (b, s, h, d), strides = tfa._strided_args(named)
        assert (b, s, d) == (q.shape[0], q.shape[1], q.shape[-1])
        assert h == (q.shape[2] if q.ndim == 4 else 1)
        want = (q.stride(0), q.stride(1), q.stride(2) if q.ndim == 4 else 0)
        assert strides == list(want) * 4
    else:
        with pytest.raises(ValueError):
            tfa._strided_args(named)


def test_misaligned_base_is_refused_before_anything_is_built():
    """A base pointer off the 16-byte grid is refused by the launch helper
    itself, before it looks for the library."""
    qkv = torch.zeros(2 * 64 * 3 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 3 * 64)
    out = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    assert qkv.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._c_call("packed_attention_forward", "no_such_library",
                    (("qkv", qkv), ("bias", None), ("out", out)), (2, 64, 1, 64), 0.125,
                    torch.device("cuda", 0))
    with pytest.raises(ValueError):
        tfa.forward_kernel_attributes(48, 128)


def test_forward_refusal_texts():
    """Neither direction refuses a long S any more (K and V, or Q and dO,
    stream through shared memory): no entry returns -2, and the other
    refusals keep their texts."""
    assert -2 not in tfa._REFUSALS
    assert tfa._REFUSALS[-1] == "unsupported head dim"
    assert "65535" in tfa._REFUSALS[-3]


def test_no_graph_without_a_gradient():
    """Without a gradient to take (inputs that do not require one, or under
    no_grad) the wrappers skip their autograd.Function and return the same
    values; with one they record it."""
    qkv, bias, scale = _inputs(1, 64, 2, 32, 17)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    out = tfa.mha_packed_bias(tq, tb, scale, 2)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(),
                                  tfa.mha_packed_bias_plain(tq, tb, scale, 2).numpy())
    leaf = tq.clone().requires_grad_()
    assert tfa.mha_packed_bias(leaf, tb, scale, 2).grad_fn is not None
    with torch.no_grad():
        assert tfa.mha_packed_bias(leaf, tb, scale, 2).grad_fn is None
    q = torch.randn(2, 64, 32)
    assert tfa.flash_attention(q, q, q, 0.2).grad_fn is None
    assert tfa.flash_attention(q.requires_grad_(), q, q, 0.2).grad_fn is not None


def test_build_hashes_every_header_and_needs_no_include_flags(tmp_path, monkeypatch):
    """A library's name carries the hash of its source and of every shared
    header in csrc/, the new forward's attention_sm90.cuh included, so a change
    to a header rebuilds; every quoted include of a source is such a header,
    and no source includes a header outside the CUDA toolkit (the flags name
    no include directory)."""
    import os
    import re
    import shutil

    from ccd_tpu_torch.ops import _build

    sources = sorted(os.listdir(_build.CSRC_DIR))
    assert "attention_sm90.cuh" in sources
    for name in sources:
        text = open(os.path.join(_build.CSRC_DIR, name)).read()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc.endswith(".cuh") and inc in sources, (name, inc)
        for inc in re.findall(r"#include <([^>]+)>", text):
            assert not inc.startswith(("cute/", "cutlass/")), (name, inc)
    assert not any(f.startswith("-I") for f in _build.NVCC_FLAGS)
    assert '#include "attention_sm90.cuh"' in open(
        os.path.join(_build.CSRC_DIR, "packed_attention.cu")).read()

    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    src, before = _build._paths("packed_attention")
    assert src == str(copy / "packed_attention.cu")
    with open(copy / "attention_sm90.cuh", "a") as f:
        f.write("\n// changed\n")
    _, after = _build._paths("packed_attention")
    assert after != before and os.path.dirname(after) == _build.BUILD_DIR


# ------------------------- the backward from the forward's saved output and log-sum-exp

LOG2E = 1 / np.log(2)


def _micro_dout(b, s, c, seed):
    return np.random.default_rng(seed).normal(size=(b, s, c)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_lse_is_the_base_2_log_sum_exp(dtype):
    """The saved statistic, in the kernels' units: log2 sum_j 2^x_ij with
    x_ij = (q_i + bq) . k_j * scale * log2(e), bk left out; so 2^(x - lse)
    is the softmax and its rows sum to 1, and a new bk leaves lse as it is."""
    b, s, h, d = MICRO
    qkv, bias, scale = _inputs(b, s, h, d, 20)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    if dtype == "bfloat16":
        tq, tb = tq.bfloat16(), tb.bfloat16()
    out, lse = tfa.mha_packed_bias_plain(tq, tb, scale, h, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.equal(out, tfa.mha_packed_bias_plain(tq, tb, scale, h))
    x = tq.view(b, s, 3, h, d)
    bq = tb.view(3, h, d)[0]
    q = (x[:, :, 0] + bq).float().permute(0, 2, 1, 3)
    k = x[:, :, 1].float().permute(0, 2, 1, 3)
    logits = q @ k.transpose(-1, -2) * scale
    want = torch.log2(torch.exp(logits.double()).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6, atol=1e-5)
    rows = torch.exp2(logits * LOG2E - lse[..., None]).sum(-1)
    np.testing.assert_allclose(rows.numpy(), 1.0, atol=1e-5)
    other = tb.clone()
    other[h * d:2 * h * d] = 3.0
    assert torch.equal(tfa.mha_packed_bias_plain(tq, other, scale, h, return_lse=True)[1], lse)
    # K1b: the same statistic of q . k * scale, (BH, S) folded, (B, H, S) head-split
    q3 = torch.from_numpy(_qkv((4, 64, 32), 21)[0])
    _, lse3 = tfa.flash_attention_plain(q3, q3, q3, 0.2, return_lse=True)
    np.testing.assert_allclose(lse3.numpy(), (torch.logsumexp(q3 @ q3.transpose(1, 2) * 0.2, -1)
                                              * LOG2E).numpy(), rtol=1e-6, atol=1e-6)
    q4 = q3.view(2, 2, 64, 32).permute(0, 2, 1, 3)
    _, lse4 = tfa.flash_attention_plain(q4, q4, q4, 0.2, return_lse=True)
    assert lse3.shape == tfa._lse_shape(q3) == (4, 64)
    assert lse4.shape == tfa._lse_shape(q4) == (2, 2, 64)
    np.testing.assert_allclose(lse4.reshape(4, 64).numpy(), lse3.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), ("bfloat16", BF16_TOL)])
def test_backward_from_saved_out_and_lse_matches_pallas(interpret_mode, dtype, atol):
    """The plain backward handed the forward's output and lse, with nonzero
    bq, bk and bv (the kernel's algebra: bk and bv left out, delta from
    out - bv), equals jax.grad of the interpreted Pallas kernel, which adds
    all three biases first."""
    b, s, h, d = MICRO
    qkv, bias, scale = _inputs(b, s, h, d, 22)
    w = _micro_dout(b, s, h * d, 23)
    if dtype == "bfloat16":
        jq, jb, jw = (jnp.asarray(a, jnp.bfloat16) for a in (qkv, bias, w))
        tq, tb, tw = (torch.from_numpy(a).bfloat16() for a in (qkv, bias, w))
    else:
        jq, jb, jw = jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(w)
        tq, tb, tw = (torch.from_numpy(a) for a in (qkv, bias, w))
    loss = lambda a: jnp.sum((fa.mha_packed_bias(a, jb, scale, h) * jw).astype(jnp.float32))
    ref = np.asarray(jax.grad(loss)(jq).astype(jnp.float32))
    out, lse = tfa.mha_packed_bias_plain(tq, tb, scale, h, return_lse=True)
    got = tfa.mha_packed_bias_bwd_plain(tq, tb, tw, scale, h, out=out, lse=lse)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol)
    # the wrapper on CPU tensors is the plain version, given the same saved values
    assert torch.equal(tfa.mha_packed_bias_bwd(tq, tb, tw, scale, h, out=out, lse=lse), got)


@pytest.mark.parametrize("layout", ["folded", "bshd"])
def test_k1b_backward_from_saved_out_and_lse_matches_pallas(interpret_mode, layout):
    """K1b, folded through flash_attention and (B, S, H, D) through mha: the
    plain backward from the saved output and lse against jax.grad of the
    interpreted Pallas kernel, fp32."""
    shape = (4, 256, 32) if layout == "folded" else (2, 256, 2, 32)
    jfn = fa.flash_attention if layout == "folded" else fa.mha
    q, k, v, w = _qkv(shape, 24)
    scale = shape[-1] ** -0.5
    ref = _jax_flash_grads(jfn, q, k, v, w, scale)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, scale, return_lse=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, tw, scale, out=out, lse=lse)
    wrapper = tfa.flash_attention_bwd(tq, tk, tv, tw, scale, out=out, lse=lse)
    for name, want, g, gw in zip("qkv", ref, got, wrapper):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, err_msg=f"d{name}")
        assert torch.equal(gw, g)


def _folded_bias_backward(qkv, bias, dout, scale, heads):
    """The bias algebra of the backward kernels, written out apart from the
    module: P = exp(logits without bk - their logsumexp), delta from the
    output less bv, dP without bv, dq = dS k without bk, dk = dS^T (q + bq);
    everything fp32 and unrounded."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = qkv.double().view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    bq, bk, bv = bias.double().view(3, 1, heads, 1, d)
    qb = q + bq
    logits = qb @ k.transpose(-1, -2) * scale
    p = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True))
    out = p @ (v + bv)                                     # the forward, all biases in
    g = dout.double().view(b, s, heads, d).permute(0, 2, 1, 3)
    delta = (g * (out - bv)).sum(-1, keepdim=True)
    ds = p * (g @ v.transpose(-1, -2) - delta) * scale
    grads = torch.stack([ds @ k, ds.transpose(-1, -2) @ qb, p.transpose(-1, -2) @ g])
    return grads.permute(1, 3, 0, 2, 4).reshape(b, s, c3)


def test_backward_bias_algebra_matches_pallas_and_bk_drops_out_of_dq(interpret_mode):
    """The algebra written out (float64) equals jax.grad of the Pallas kernel
    and the port's plain backward; a different bk alone moves no gradient
    of qkv beyond fp32 rounding, in JAX's gradient or the port's."""
    b, s, h, d = MICRO
    qkv, bias, scale = _inputs(b, s, h, d, 25)
    w = _micro_dout(b, s, h * d, 26)
    other = bias.copy()
    other[h * d:2 * h * d] = np.random.default_rng(27).normal(size=h * d)
    tq, tw = torch.from_numpy(qkv), torch.from_numpy(w)
    results = []
    for bb in (bias, other):
        ref, _ = _jax_grads(qkv, bb, w, scale, h)
        written = _folded_bias_backward(tq, torch.from_numpy(bb), tw, scale, h)
        plain = tfa.mha_packed_bias_bwd_plain(tq, torch.from_numpy(bb), tw, scale, h)
        np.testing.assert_allclose(written.numpy(), ref, atol=1e-5)
        np.testing.assert_allclose(plain.numpy(), written.numpy(), atol=1e-5)
        results.append((ref, plain.numpy()))
    (ref_a, plain_a), (ref_b, plain_b) = results
    np.testing.assert_allclose(ref_b, ref_a, atol=1e-5)
    np.testing.assert_allclose(plain_b, plain_a, atol=1e-5)


def test_autograd_functions_save_out_and_lse_and_skip_without_a_gradient():
    """_PackedAttention saves (qkv, bias, out, lse) and _FlashAttention
    (q, k, v, out, lse), the lse the plain forward returns; with no gradient
    wanted neither is recorded."""
    qkv, bias, scale = _inputs(1, 64, 2, 32, 28)
    leaf, tb = torch.from_numpy(qkv).requires_grad_(), torch.from_numpy(bias)
    out = tfa.mha_packed_bias(leaf, tb, scale, 2)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4 and saved[0] is leaf and torch.equal(saved[1], tb)
    assert torch.equal(saved[2], out)
    want_out, want_lse = tfa.mha_packed_bias_plain(leaf.detach(), tb, scale, 2, return_lse=True)
    assert torch.equal(saved[3], want_lse) and saved[3].shape == (1, 2, 64)
    with torch.no_grad():
        assert tfa.mha_packed_bias(leaf, tb, scale, 2).grad_fn is None
    assert tfa.mha_packed_bias(leaf.detach(), tb, scale, 2).grad_fn is None
    for shape in ((2, 64, 32), (1, 64, 2, 32)):
        q = torch.randn(shape, requires_grad=True)
        fn = tfa.flash_attention if len(shape) == 3 else tfa.mha
        o = fn(q, q, q, 0.2)
        saved = o.grad_fn.saved_tensors
        want_out, want_lse = tfa.flash_attention_plain(q.detach(), q.detach(), q.detach(), 0.2,
                                                       return_lse=True)
        assert len(saved) == 5 and torch.equal(saved[3], o) and torch.equal(saved[4], want_lse)
        assert fn(q.detach(), q.detach(), q.detach(), 0.2).grad_fn is None


@pytest.mark.parametrize("case,ok", [
    ("packed_long_s", True), ("folded_long_s", True), ("bshd_long_s", True),
    ("out_shape", False), ("out_dtype", False), ("lse_shape", False), ("lse_dtype", False),
    ("lse_not_contiguous", False)])
def test_backward_argument_limits(case, ok):
    """What the backward entries take, checked before anything is built: any
    S % 64 == 0, S = 4096 included (nothing of a head's rows has to fit in
    shared memory any more), and the saved output and lse of the forward's
    shapes and types."""
    z = lambda *shape, dtype=torch.bfloat16: torch.zeros(*shape, dtype=dtype)
    if case == "packed_long_s":
        qkv = z(1, 4096, 3 * 128)
        assert tfa._kernel_args(qkv, None, 2) is None
        tfa._check_saved(z(1, 4096, 128), z(1, 2, 4096, dtype=torch.float32), (1, 4096, 128),
                         (1, 2, 4096), qkv)
        return
    if case in ("folded_long_s", "bshd_long_s"):
        q = z(1, 4096, 64) if case == "folded_long_s" else z(1, 4096, 2, 64)
        (b, s, h, d), strides = tfa._strided_args([(n, q) for n in
                                                   ("q", "k", "v", "out", "dout", "dq", "dk",
                                                    "dv")])
        assert (b, s, d) == (1, 4096, 64) and len(strides) == 24
        tfa._check_saved(z(*q.shape), z(*tfa._lse_shape(q), dtype=torch.float32), q.shape,
                         tfa._lse_shape(q), q)
        return
    qkv = z(2, 64, 3 * 64)
    out, lse = z(2, 64, 64), z(2, 2, 64, dtype=torch.float32)
    if case == "out_shape":
        out = z(2, 64, 32)
    elif case == "out_dtype":
        out = out.float()
    elif case == "lse_shape":
        lse = z(2, 64, 2, dtype=torch.float32)
    elif case == "lse_dtype":
        lse = lse.bfloat16()
    elif case == "lse_not_contiguous":
        lse = z(2, 64, 2, dtype=torch.float32).transpose(1, 2)
    with pytest.raises(ValueError):
        tfa._check_saved(out, lse, (2, 64, 64), (2, 2, 64), qkv)


def test_backward_attributes_refuse_what_is_not_built():
    """The resources entry is asked only for kernels that exist: D 32 or 64,
    the dq or the dk/dv kernel, bf16 or fp32 (checked before any build)."""
    for args in ((48, torch.bfloat16, "dq"), (64, torch.bfloat16, "dv"),
                 (64, torch.float16, "dkdv")):
        with pytest.raises(ValueError):
            tfa.backward_kernel_attributes(*args)


def test_forward_attributes_refuse_what_is_not_built(monkeypatch):
    """The forward's resources entry is asked only for kernels that exist: D
    32 or 64; bf16 with 64- or 128-row tiles, fp32 with 64-row tiles (checked
    before any build). The bf16 call keeps its form; fp32 has its own entry."""
    from ccd_tpu_torch.ops import _build

    def no_build(*args, **kwargs):
        raise AssertionError("a refused request reached the build")

    monkeypatch.setattr(_build, "build_libraries", no_build)
    for args in ((48, 64), (64, 96), (64, 128, torch.float32), (64, 64, torch.float16),
                 (32, 128, torch.float32), (64, 64, torch.float64)):
        with pytest.raises(ValueError):
            tfa.forward_kernel_attributes(*args)
    asked = []
    monkeypatch.setattr(tfa, "kernel_attributes", lambda *args: asked.append(args) or {})
    tfa.forward_kernel_attributes(64, 128)
    tfa.forward_kernel_attributes(32, 64, torch.bfloat16)
    tfa.forward_kernel_attributes(64, 64, torch.float32)
    tfa.forward_kernel_attributes(32, 64, torch.float32)
    assert asked == [("packed_attention", "attention_forward_attributes", 64, 1),
                     ("packed_attention", "attention_forward_attributes", 32, 0),
                     ("packed_attention", "attention_forward_f32_attributes", 64),
                     ("packed_attention", "attention_forward_f32_attributes", 32)]


# the fp32 bounds chip_smoke.py reckons (operations at 67 TFLOP/s): forward at
# the evaluation shape, backward at ViT-Small's training shape, both at
# ViT-Tiny's and at vit_micro's (the probe's batch), in ms to three figures
@pytest.mark.parametrize("direction,shape,ms", [
    ("forward", (288, 256, 384, 6), 0.433), ("backward", (128, 256, 384, 6), 0.481),
    ("forward", (128, 256, 192, 3), 0.0962), ("backward", (128, 256, 192, 3), 0.240),
    ("forward", (32, 256, 64, 2), 0.00801), ("backward", (32, 256, 64, 2), 0.0200)],
    ids=lambda x: str(x))
def test_chip_smoke_fp32_attention_bounds(direction, shape, ms):
    import chip_smoke
    bound = chip_smoke.attention_bound if direction == "forward" else \
        chip_smoke.attention_bwd_bound
    got, by = bound(*shape, torch.float32, True)
    assert by == "operations"
    assert float(f"{got:.3g}") == ms, got
