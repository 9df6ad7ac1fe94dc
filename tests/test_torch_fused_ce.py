"""The port's fused DINO cross-entropy (plain version, the CPU path of the
wrapper) against the JAX package's Pallas kernel, which interprets itself
off-TPU (``fused_dino_ce._interpret``). Mirrors tests/test_fused_ce.py.

fp32 throughout. Tolerances are that file's: values 1e-4 absolute / 1e-5
relative, gradients 2e-6 absolute / 1e-4 relative (the online softmax and the
one-shot softmax sum the same terms in another order). The saved statistics
(5, R) of ``fused_dino_ce_stats_plain`` are held to ``_run_fwd(...)[1]`` to
1e-5 relative, each of the five with 1e-5 of its largest entry as the
absolute limit (the last, sum(p * s'), has terms of either sign); the plain
backward from saved statistics, in base 2, to ``_bwd_rule`` fed the same
statistics, at the gradients' limits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.losses import dino_char_loss as jax_dino_char_loss
from ccd_tpu.losses.losses import dino_char_loss_fused as jax_dino_char_loss_fused
from ccd_tpu.ops import fused_dino_ce as jax_fce
from ccd_tpu.ops.fused_dino_ce import fused_dino_row_ce as jax_row_ce
from ccd_tpu_torch.losses import dino_char_loss, dino_char_loss_fused
from ccd_tpu_torch.ops import fused_dino_ce as tce


def _loss_inputs(b=2, t=4, k=512, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(2 * b, t, k)).astype(np.float32)
    te = rng.normal(size=(2 * b, t, k)).astype(np.float32)
    c = rng.normal(size=(1, k)).astype(np.float32)
    valid = np.zeros((b, t), bool)
    valid[:, :3] = True
    return s, te, valid, c


def _row_inputs(r, k, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(r, k)) * scale).astype(np.float32),
            (rng.normal(size=(r, k)) * scale).astype(np.float32),
            rng.normal(size=(1, k)).astype(np.float32))


@pytest.mark.parametrize("fused", [True, False])
def test_fused_matches_pallas_value(fused):
    s, te, valid, c = _loss_inputs()
    ref = float(jax_dino_char_loss_fused(*map(jnp.asarray, (s, te, valid, c)), 0.04))
    fn = dino_char_loss_fused if fused else dino_char_loss
    out = float(fn(*map(torch.from_numpy, (s, te, valid, c)), 0.04))
    assert abs(ref - out) < 1e-4, (ref, out)
    # and the JAX plain chain says the same
    assert abs(float(jax_dino_char_loss(*map(jnp.asarray, (s, te, valid, c)), 0.04)) - out) < 1e-4


@pytest.mark.parametrize("fused", [True, False])
def test_fused_matches_pallas_grad(fused):
    s, te, valid, c = _loss_inputs(seed=1)
    js, jt, jv, jc = map(jnp.asarray, (s, te, valid, c))
    g_ref = np.asarray(jax.grad(lambda x: jax_dino_char_loss_fused(x, jt, jv, jc, 0.04))(js))
    ts = torch.from_numpy(s).requires_grad_()
    fn = dino_char_loss_fused if fused else dino_char_loss
    fn(ts, *map(torch.from_numpy, (te, valid, c)), 0.04).backward()
    np.testing.assert_allclose(ts.grad.numpy(), g_ref, atol=2e-6, rtol=1e-4)


def test_swap_halves_matches_pallas_multi_block():
    """Teacher rows rotated by half against the student's, value and grad,
    with the Pallas side tiled into > 2 row blocks per half."""
    r, k = 512, 256
    s, t, c = _row_inputs(r, k, 3)
    js, jt, jc = map(jnp.asarray, (s, t, c))
    ref = np.asarray(jax_row_ce(js, jt, jc, 0.04, 0.1, row_block=128, k_block=128,
                                swap_halves=True))
    ts = torch.from_numpy(s).requires_grad_()
    out = tce.fused_dino_row_ce(ts, torch.from_numpy(t), torch.from_numpy(c), 0.04, 0.1,
                                swap_halves=True)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4, rtol=1e-5)
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_row_ce(x, jt, jc, 0.04, 0.1, 128, 128, True)))(js))
    out.sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), g_ref, atol=2e-6, rtol=1e-4)
    # and the pairing really is row i with teacher row i + R/2
    t_sw = np.concatenate([t[r // 2:], t[:r // 2]])
    unswapped = tce.fused_dino_row_ce_plain(torch.from_numpy(s), torch.from_numpy(t_sw),
                                            torch.from_numpy(c), 0.04, 0.1)
    np.testing.assert_allclose(out.detach().numpy(), unswapped.numpy(), atol=1e-6)


def test_multi_chunk_grid_matches_pallas():
    """Large logits over several Pallas K chunks exercise the online rescaling."""
    s, t, c = _row_inputs(8, 1024, 2, scale=5.0)
    ref = np.asarray(jax_row_ce(*map(jnp.asarray, (s, t, c)), 0.04, 0.1, row_block=8,
                                k_block=256))
    out = tce.fused_dino_row_ce(*map(torch.from_numpy, (s, t, c)), 0.04, 0.1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("r,k,swap", [(7, 100, False), (2 * 7 * 26, 1000, True), (6, 37, True)])
def test_odd_sizes_value_and_grad(r, k, swap):
    """Rows and K need no particular size in the port (the Pallas blocks take
    the whole array when nothing divides it)."""
    s, t, c = _row_inputs(r, k, 4)
    js, jt, jc = map(jnp.asarray, (s, t, c))
    ref = np.asarray(jax_row_ce(js, jt, jc, 0.05, 0.1, swap_halves=swap))
    g = np.random.default_rng(5).normal(size=(r,)).astype(np.float32)
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_row_ce(x, jt, jc, 0.05, 0.1, swap_halves=swap) * g))(js))
    ts = torch.from_numpy(s).requires_grad_()
    out = tce.fused_dino_row_ce(ts, torch.from_numpy(t), torch.from_numpy(c), 0.05, 0.1, swap)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4, rtol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), g_ref, atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("swap", [False, True], ids=["paired", "swap_halves"])
@pytest.mark.parametrize("k", [300, 1001])
@pytest.mark.parametrize("r", [8, 14])
def test_plain_stats_and_backward_from_saved_stats_match_pallas(r, k, swap):
    """The kernels' own signatures: the forward's saved statistics, and the
    backward from given statistics (the Pallas backward fed the Pallas
    forward's statistics, both sides the same numbers)."""
    s, t, c = _row_inputs(r, k, 8, scale=2.0)
    js, jt, jc = map(jnp.asarray, (s, t, c))
    _, jstats = jax_fce._run_fwd(js, jt, jc, 0.04, 0.1, 256, 2048, swap)
    want = np.array(jstats)
    stats = tce.fused_dino_ce_stats_plain(*map(torch.from_numpy, (s, t, c)), 0.04, 0.1,
                                          swap).numpy()
    assert stats.shape == (5, r) and stats.dtype == np.float32
    for got_row, want_row in zip(stats, want):
        np.testing.assert_allclose(got_row, want_row, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_row).max())
    g = np.random.default_rng(9).normal(size=(r,)).astype(np.float32)
    ds_ref = np.asarray(jax_fce._bwd_rule(0.1, 256, 2048, swap, (js, jt, jc, 0.04, jstats),
                                          jnp.asarray(g))[0])
    ds = tce.fused_dino_ce_backward_plain(*map(torch.from_numpy, (s, t, c, g, want)), 0.04, 0.1,
                                          swap)
    assert ds.dtype == torch.float32
    np.testing.assert_allclose(ds.numpy(), ds_ref, atol=2e-6, rtol=1e-4)


def test_no_gradient_reaches_teacher_or_centre():
    s, t, c = (torch.from_numpy(a).requires_grad_() for a in _row_inputs(4, 64, 6))
    tce.fused_dino_row_ce(s, t, c, 0.04, 0.1, True).sum().backward()
    assert s.grad is not None and t.grad is None and c.grad is None


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "centre", "odd_swap"])
def test_wrapper_raises_on_wrong_input(bad):
    s, t, c = torch.zeros(4, 16), torch.zeros(4, 16), torch.zeros(1, 16)
    swap = False
    if bad == "shape":
        t = torch.zeros(4, 8)
    elif bad == "dtype":
        s, t = s.double(), t.double()
    elif bad == "mixed":
        t = t.bfloat16()
    elif bad == "centre":
        c = torch.zeros(1, 8)
    elif bad == "odd_swap":
        s, t, swap = torch.zeros(3, 16), torch.zeros(3, 16), True
    with pytest.raises((ValueError, TypeError)):
        tce.fused_dino_row_ce(s, t, c, 0.04, 0.1, swap)


def test_kernel_alone_wrappers_refuse_cpu_tensors():
    """The kernel-alone entry points have no plain fallback."""
    s, t, c = (torch.from_numpy(a) for a in _row_inputs(4, 64, 10))
    stats = tce.fused_dino_ce_stats_plain(s, t, c)
    with pytest.raises(ValueError):
        tce.fused_dino_ce_forward(s, t, c)
    with pytest.raises(ValueError):
        tce.fused_dino_ce_backward(s, t, c, torch.ones(4), stats)


def test_cpu_path_leaves_the_launch_counters_alone():
    before = (tce.fused_dino_row_ce.launches, tce.fused_dino_row_ce.bwd_launches)
    s, t, c = (torch.from_numpy(a) for a in _row_inputs(4, 64, 7))
    tce.fused_dino_row_ce(s.requires_grad_(), t, c).sum().backward()
    assert (tce.fused_dino_row_ce.launches, tce.fused_dino_row_ce.bwd_launches) == before
