"""The port's losses and schedules against the JAX package's, same numpy
inputs, fp32, CPU.

Tolerances: 1e-5 relative for the scalar losses (fp32 means of O(1) terms),
1e-6 for the centre, 2e-6 absolute / 1e-4 relative for gradients (as
tests/test_fused_ce.py), 1e-6 relative for the float32 schedules.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu import schedules as jsched
from ccd_tpu.losses import losses as jl
from ccd_tpu_torch import schedules as tsched
from ccd_tpu_torch.losses import losses as tl


def _seg_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(4, 32, 128, 2))).astype(np.float32)
    gt = (rng.random((4, 32, 128)) < 0.3).astype(np.float32)
    return logits, gt


def _dino_inputs(b=3, t=26, k=96, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(2 * b, t, k)).astype(np.float32)
    te = rng.normal(size=(2 * b, t, k)).astype(np.float32)
    c = (0.1 * rng.normal(size=(1, k))).astype(np.float32)
    valid = np.arange(t)[None, :] <= rng.integers(3, t, size=(b, 1))
    return s, te, valid, c


def test_seg_loss_matches_jax_value_and_grad():
    logits, gt = _seg_inputs()
    ref = float(jl.seg_loss(jnp.asarray(logits), jnp.asarray(gt)))
    g_ref = np.asarray(jax.grad(lambda x: jl.seg_loss(x, jnp.asarray(gt)))(jnp.asarray(logits)))
    tx = torch.from_numpy(logits).requires_grad_()
    out = tl.seg_loss(tx, torch.from_numpy(gt))
    out.backward()
    out = out.detach()
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), g_ref, atol=1e-9, rtol=1e-4)
    # the double softmax keeps it between log(1 + 1/e) and log(1 + e)
    assert np.log1p(np.exp(-1.0)) <= float(out) <= np.log1p(np.exp(1.0))


def test_seg_loss_takes_bf16_logits_in_fp32():
    logits, gt = _seg_inputs(2)
    ref = jl.seg_loss(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(gt))
    out = tl.seg_loss(torch.from_numpy(logits).bfloat16(), torch.from_numpy(gt))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


@pytest.mark.parametrize("args", [(0.04, 0.04, 0, 100), (0.04, 0.07, 30, 100), (0.04, 0.07, 5, 3)])
def test_teacher_temp_schedule_matches_jax(args):
    np.testing.assert_array_equal(tl.teacher_temp_schedule(*args), jl.teacher_temp_schedule(*args))


@pytest.mark.parametrize("temp", [0.04, 0.07])
def test_dino_char_loss_matches_jax_value_and_grad(temp):
    s, te, valid, c = _dino_inputs()
    js, jt, jv, jc = map(jnp.asarray, (s, te, valid, c))
    ref = float(jl.dino_char_loss(js, jt, jv, jc, temp))
    g_ref = np.asarray(jax.grad(lambda x: jl.dino_char_loss(x, jt, jv, jc, temp))(js))
    ts = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(te).requires_grad_()
    out = tl.dino_char_loss(ts, tt, torch.from_numpy(valid), torch.from_numpy(c), temp)
    out.backward()
    out = out.detach()
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), g_ref, atol=2e-6, rtol=1e-4)
    assert tt.grad is None  # the teacher is detached


@pytest.mark.parametrize("flat", [True, False])
def test_fused_loss_equals_plain_and_jax(flat):
    """(2B*T, K) rows as pool_project(flat=True) emits them, or (2B, T, K)."""
    s, te, valid, c = _dino_inputs(seed=3)
    k = s.shape[-1]
    ref = float(jl.dino_char_loss(*map(jnp.asarray, (s, te, valid, c)), 0.04))
    shape = (-1, k) if flat else s.shape
    ts = torch.from_numpy(s).reshape(shape).requires_grad_()
    out = tl.dino_char_loss_fused(ts, torch.from_numpy(te).reshape(shape),
                                  torch.from_numpy(valid), torch.from_numpy(c), 0.04)
    out.backward()
    tp = torch.from_numpy(s).requires_grad_()
    plain = tl.dino_char_loss(tp, *map(torch.from_numpy, (te, valid, c)), 0.04)
    plain.backward()
    out, plain = out.detach(), plain.detach()
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    np.testing.assert_allclose(float(out), float(plain), rtol=1e-5)
    np.testing.assert_allclose(ts.grad.reshape(s.shape).numpy(), tp.grad.numpy(),
                               atol=2e-6, rtol=1e-4)


def test_dino_loss_with_no_valid_slot_is_zero_not_nan():
    s, te, _, c = _dino_inputs(seed=4)
    valid = np.zeros((3, 26), bool)
    for fn in (tl.dino_char_loss, tl.dino_char_loss_fused):
        out = fn(*map(torch.from_numpy, (s, te, valid, c)), 0.04)
        assert float(out) == 0.0


@pytest.mark.parametrize("flat", [True, False])
def test_center_update_matches_jax(flat):
    _, te, valid, c = _dino_inputs(seed=5)
    k = te.shape[-1]
    shape = (-1, k) if flat else te.shape
    ref = np.asarray(jl.dino_center_update(jnp.asarray(c), jnp.asarray(te).reshape(shape),
                                           jnp.asarray(valid), 0.9))
    out = tl.dino_center_update(torch.from_numpy(c), torch.from_numpy(te).reshape(shape),
                                torch.from_numpy(valid), 0.9)
    assert out.shape == (1, k) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_center_update_sums_bf16_logits_in_fp32():
    _, te, valid, c = _dino_inputs(b=16, seed=6)
    tb = torch.from_numpy(te).bfloat16()
    ref = np.asarray(jl.dino_center_update(
        jnp.asarray(c), jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(valid), 0.9))
    out = tl.dino_center_update(torch.from_numpy(c), tb, torch.from_numpy(valid), 0.9)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


SCHEDULES = [(5e-4, 1e-6, 5000, 10), (0.04, 0.4, 5000, 0), (0.9995, 1.0, 5000, 0),
             (1e-3, 1e-6, 50, 1)]


@pytest.mark.parametrize("args", SCHEDULES)
def test_cosine_iter_schedule_matches_jax(args):
    for it in (0, 1, 2, 9, 10, 11, 49, 50, 777, 4999, 5000, 6000):
        ref = float(jsched.cosine_iter_schedule(it, *args))
        out = tsched.cosine_iter_schedule(it, *args)
        assert isinstance(out, float)
        assert abs(out - ref) <= 1e-6 * max(abs(ref), 1e-12), (it, out, ref)


@pytest.mark.parametrize("args", SCHEDULES)
def test_schedule_arrays_match_jax(args):
    np.testing.assert_array_equal(tsched.cosine_iter_schedule_array(*args),
                                  jsched.cosine_iter_schedule_array(*args))
    np.testing.assert_array_equal(
        tsched.cosine_epoch_schedule_array(args[0], args[1], 4, 25, warmup_epochs=1),
        jsched.cosine_epoch_schedule_array(args[0], args[1], 4, 25, warmup_epochs=1))
