"""The augmentation chains beside severity 5, and their pieces, held to the
JAX package's on the same JAX key (through ``_torch_port.JaxKey``, so both
sides get the same draws) and the same seeded images (4, 32, 128, 3) fp32,
CPU. A wrong split count or draw order shows as a different output.

Tolerances, each with the largest difference measured (CPU, JAX 0.9, torch 2.13):

* ``TorchKey.permutations``: the JAX twin's draw exactly, and every row of
  the port's own draw is a permutation;
* ``homography_grid`` on the same matrices: 1e-6 (measured 3.6e-7: the same
  three products and sums per point, the divide by max(|z|, 1e-6));
* ``_solve_homography``: 1e-5 (measured 1.2e-7: Gauss-Jordan with partial
  pivoting here, LAPACK's LU with partial pivoting in JAX);
* ``_random_perspective``: 1e-5 (measured 2.4e-7), as the solve;
* ``_op_crop``, ``_op_elastic``, ``_op_perspective``: 1e-4 on the [0, 1]
  output (measured 6e-8, 6e-8 and 1.9e-5: a sampling position that moves by
  the homography's difference times the image width, on edges where the
  image jumps by up to 1), the limit of the affine view in
  tests/test_torch_aug_ops.py;
* ``some_of_random_order`` over three cheap ops: 1e-5 (measured 2.4e-7);
* ``photometric_augment``: severities 1, 3, 4 and 6 to 1e-5 on at least 99 %
  of the values (measured at most 6.6e-7, so 100 %), the severity-5 chain's
  limit for a rounding op that may put a pixel within fp32 noise of an edge
  on the other side; severity 2 to 1e-4 on at least 99 % (measured 1.9e-5,
  so 100 %), the supervised chain's limit for a chain with a warp;
* ``abinet_augment``: 1e-4 on at least 99 % (measured 2.8e-5, so 100 %), as
  severity 2;
* severities 0 and 7 raise ``NotImplementedError``, as in JAX
  (tests/test_torch_aug_ops.py::test_other_severities_are_refused).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.data import aug_ops as JA
from ccd_tpu.data import augment as JG
from ccd_tpu.ops import warp as JW
from ccd_tpu_torch.data import aug_ops as TA
from ccd_tpu_torch.data import augment as TG
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.ops import warp as TW

from _torch_port import JaxKey, one_torch_thread, seeded_images  # noqa: F401 (fixture)

SQUARE = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def images():
    return seeded_images(1)


def _chain_diff(got: np.ndarray, want: np.ndarray, images: np.ndarray, tol: float) -> float:
    """Share of values beyond ``tol``; also checks shape, finiteness and that
    the chain changed something."""
    assert got.shape == images.shape and got.dtype == np.float32 and np.isfinite(got).all()
    assert not np.allclose(got, images, atol=1e-3)
    return float((np.abs(got - want) > tol).mean())


def test_permutations_match_jax_and_are_permutations():
    key = jax.random.PRNGKey(3)
    got = JaxKey(key).permutations(4, 7)
    want = jax.vmap(lambda k: jax.random.permutation(k, 7))(jax.random.split(key, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = TorchKey(torch.Generator().manual_seed(0)).permutations(64, 7)
    assert own.shape == (64, 7) and own.dtype == torch.int64
    assert (own.sort(dim=-1).values == torch.arange(7)).all()
    assert len({tuple(row) for row in own.tolist()}) > 32  # not one order for every row


def test_homography_grid_matches_jax():
    hmat = np.asarray(JG._random_perspective(jax.random.PRNGKey(5), 4, 32, 128, 0.5))
    want = np.asarray(JW.homography_grid(jnp.asarray(hmat), (32, 128)))
    got = TW.homography_grid(torch.from_numpy(hmat.copy()), (32, 128)).numpy()
    assert got.shape == (4, 32, 128, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spread", [0.05, 0.3])
def test_solve_homography_matches_jax(spread):
    src = np.tile(SQUARE, (4, 1, 1))
    dst = src + np.random.default_rng(0).uniform(-spread, spread, src.shape).astype(np.float32)
    want = np.asarray(jax.vmap(JG._solve_homography)(jnp.asarray(src), jnp.asarray(dst)))
    got = TG._solve_homography(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # H maps each dst corner onto its src corner
    mapped = np.einsum("bij,bkj->bki", got, np.concatenate([dst, np.ones((4, 4, 1))], -1))
    np.testing.assert_allclose(mapped[..., :2] / mapped[..., 2:], src, atol=1e-5)


def test_random_perspective_matches_jax():
    key = jax.random.PRNGKey(6)
    want = np.asarray(JG._random_perspective(key, 4, 32, 128, distortion=0.5))
    got = TG._random_perspective(JaxKey(key), 4, 32, 128, distortion=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("op,kwargs", [
    ("_op_crop", dict(tb=(0.0, 0.4), lr=(0.0, 0.0))),
    ("_op_crop", dict(tb=(0.0, 0.0), lr=(0.0, 0.02))),
    ("_op_elastic", {}),
    ("_op_perspective", {}),
], ids=["crop_top_bottom", "crop_left_right", "elastic", "perspective"])
def test_geometric_op_matches_jax(images, op, kwargs):
    key = jax.random.PRNGKey(3)
    want = np.asarray(getattr(JG, op)(key, jnp.asarray(images), **kwargs))
    got = getattr(TG, op)(JaxKey(key), torch.from_numpy(images), **kwargs).numpy()
    assert got.shape == images.shape and np.isfinite(got).all()
    assert not np.allclose(got, images, atol=1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_some_of_random_order_matches_jax(images):
    key = jax.random.PRNGKey(3)
    names = ("op_linear_contrast", "op_sharpen", "op_gaussian_blur")
    want = np.asarray(JA.some_of_random_order(key, jnp.asarray(images),
                                              [getattr(JA, n) for n in names]))
    got = TA.some_of_random_order(JaxKey(key), torch.from_numpy(images),
                                  [getattr(TA, n) for n in names]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# severity -> absolute tolerance; at least 99 % of the values within it
SEVERITY_TOL = {1: 1e-5, 2: 1e-4, 3: 1e-5, 4: 1e-5, 6: 1e-5}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("severity", sorted(SEVERITY_TOL))
def test_photometric_augment_matches_jax(images, severity, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JG.photometric_augment(key, jnp.asarray(images), severity))
    got = TG.photometric_augment(JaxKey(key), torch.from_numpy(images), severity).numpy()
    share = _chain_diff(got, want, images, SEVERITY_TOL[severity])
    assert share <= 0.01, share


@pytest.mark.parametrize("seed", [0, 1])
def test_abinet_augment_matches_jax(images, seed):
    key = jax.random.PRNGKey(seed)
    # the JAX chain op by op: its jitted form would compile the whole chain for one call
    jax_chain = getattr(JG.abinet_augment, "__wrapped__", JG.abinet_augment)
    want = np.asarray(jax_chain(key, jnp.asarray(images)))
    got = TG.abinet_augment(JaxKey(key), torch.from_numpy(images)).numpy()
    share = _chain_diff(got, want, images, 1e-4)
    assert share <= 0.01, share
