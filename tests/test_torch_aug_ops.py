"""The severity-5 augmentation ops of the port against the JAX package's, on
the same JAX key (through ``_torch_port.JaxKey``, so both sides get the same
draws), on the same seeded images (4, 32, 128, 3) fp32, CPU: JPEG needs
multiples of 16, CLAHE an 8x8 grid of whole tiles.

Tolerances. Every op: 1e-5 absolute on its [0,1] output (measured at most
1e-6: the same fp32 arithmetic, summed in another order in a few places).
Ops that round or threshold a computed value may put a pixel that lies
within fp32 noise of a rounding edge on the other side; for them a share of
pixels may differ by one quantum of the op's output:

* ``op_additive_poisson``: a uniform draw within ~1e-7 of a CDF entry (the
  CDF is a cumsum, summed in another order) counts one more or one less:
  <= 0.1 % of pixels, by 1/255 (measured 0.006 %);
* JPEG, the uniform quantisation, both histogram equalisations and both
  CLAHEs: <= 0.1 % of pixels (measured none), by at most 0.1;
* ``op_kmeans_color_quantization``: one and two Lloyd steps are held to
  1e-5; at the op's four steps a pixel whose distances to two centres tie
  within fp32 noise can join the other cluster, and the next Lloyd step then
  moves both centres: <= 10 % of the pixels (measured 6.3 %, all in one of the
  four samples, the other three identical).

The bilateral filter's plain version (what the wrapper computes on a CPU
tensor; the CUDA kernel is held to it on the card by ``chip_smoke.py``) is
held to JAX's XLA path and to the Pallas kernel in interpret mode to 2e-6,
the Pallas test's own limit. ``jax_image_resize`` is held to
``jax.image.resize`` to 1e-6 at the shapes the ops use.

The chain, the affine view with its theta and the three pretraining views
are held on one key each, at B = 4 (in this file so that the JAX side reuses
the per-primitive compilations of the op tests; a wrong split count or draw
order shows as a different output). ``photometric_augment``: 1e-5 absolute on its [0,1] output, as
each op (measured at most 1.3e-6 on three keys), except that a rounding op
inside the chain may put pixels within fp32 noise of an edge on the other
side (as above): at most 1 % of the values may differ
by more. ``random_affine_with_theta``: theta to 1e-6 (the 3x3 inverse is
taken by cofactors here, by LU in JAX: measured 2.4e-7); the warped image to
1e-4 (a sampling position moves by theta's difference times the image width,
~1e-5 pixel, on edges where the image jumps by up to 1: measured 1.5e-5).
``pretrain_views``: theta as above; the ImageNet-normalised views (values up
to ~2.6) to 1e-4 on at least 99 % of the entries (measured 100 % on keys 0
and 2; on key 1 a k-means tie in one view moves 0.24 % of the entries).

The finetune chain's pieces: ``op_channel_shuffle`` exactly (a gather here,
a one-hot product at HIGHEST precision in JAX: both move the values
unchanged); ``_random_affine_matrix`` to 1e-6, as theta above;
``_elastic_grid`` to 1e-6 (the cubic upsampling, as ``jax_image_resize``).
``supervised_augment`` on two keys, against the JAX chain run op by op (its
jitted form would compile the whole chain for one call): 1e-4 on at least
99 % of the values, the limit of the pretraining views, for the same reasons
(a rounding op of the big OneOf, and the final warp's sampling positions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.data import aug_ops as JA
from ccd_tpu.data import augment as JG
from ccd_tpu_torch.data import aug_ops as TA
from ccd_tpu_torch.data import augment as TG
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.ops.bilateral import bilateral_filter_fused, bilateral_filter_plain
from ccd_tpu_torch.ops.image import jax_image_resize

from _torch_port import JaxKey, one_torch_thread, seeded_images  # noqa: F401 (fixture)

TOL = 1e-5
BLUR_OPS = ["op_sharpen", "op_gaussian_blur", "op_average_blur", "op_median_blur",
            "op_motion_blur", "op_bilateral_blur"]
SEVERITY_5_OPS = ([op.__name__ for op in JA.ARITHMETIC_OPS] + [op.__name__ for op in JA.COLOR_OPS]
                  + BLUR_OPS + [op.__name__ for op in JA.CONTRAST_OPS]
                  + [op.__name__ for op in JA.WEATHER_OPS])
# op -> (share of pixels allowed beyond TOL, largest difference allowed there)
ROUNDING = {"op_additive_poisson": (1e-3, 1 / 255 + TOL),
            "op_jpeg_compression": (1e-3, 0.1),
            "op_uniform_color_quantization": (1e-3, 0.1),
            "op_histogram_equalization": (1e-3, 0.1),
            "op_allchannels_histogram_equalization": (1e-3, 0.1),
            "op_clahe": (1e-3, 0.1), "op_allchannels_clahe": (1e-3, 0.1),
            "op_kmeans_color_quantization": (0.1, 1.0)}


@pytest.fixture(scope="module")
def images():
    return seeded_images(0)


def test_the_op_lists_are_the_jax_lists():
    assert len(SEVERITY_5_OPS) == 48
    for name in ("ARITHMETIC_OPS", "COLOR_OPS", "CONTRAST_OPS", "WEATHER_OPS"):
        assert [op.__name__ for op in getattr(TA, name)] == \
            [op.__name__ for op in getattr(JA, name)], name
    assert [op.__name__ for op in TA.BLUR_KINDS] == [op.__name__ for op in JA.BLUR_KINDS]


@pytest.mark.parametrize("name", SEVERITY_5_OPS)
def test_op_matches_jax(images, name):
    key = jax.random.PRNGKey(7)
    want = np.asarray(getattr(JA, name)(key, jnp.asarray(images)))
    got = getattr(TA, name)(JaxKey(key), torch.from_numpy(images)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    share, largest = ROUNDING.get(name, (0.0, TOL))
    assert (diff > TOL).mean() <= share, (name, (diff > TOL).mean())
    assert diff.max() <= largest, (name, diff.max())


@pytest.mark.parametrize("n_iters", [1, 2])
def test_kmeans_lloyd_steps_match_jax(images, n_iters):
    key = jax.random.PRNGKey(7)
    want = np.asarray(JA.op_kmeans_color_quantization(key, jnp.asarray(images), n_iters))
    got = TA.op_kmeans_color_quantization(JaxKey(key), torch.from_numpy(images), n_iters)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("per_sample", [True, False], ids=["per_sample_radius", "radius_2"])
def test_bilateral_plain_matches_jax_xla(images, per_sample):
    b = images.shape[0]
    sc = np.array([10.0, 75.0, 250.0, 40.0], np.float32).reshape(b, 1, 1, 1)
    ss = np.array([30.0, 10.0, 250.0, 100.0], np.float32).reshape(b, 1, 1, 1)
    if per_sample:
        rad = np.array([1, 3, 5, 2]).reshape(b, 1, 1, 1)
        want = JA.bilateral_filter(jnp.asarray(images), jnp.asarray(sc), jnp.asarray(ss),
                                   radius=jnp.asarray(rad), max_radius=5)
        got = TA.bilateral_filter(torch.from_numpy(images), torch.from_numpy(sc),
                                  torch.from_numpy(ss), radius=torch.from_numpy(rad),
                                  max_radius=5)
    else:
        want = JA.bilateral_filter(jnp.asarray(images), jnp.asarray(sc), jnp.asarray(ss),
                                   radius=2)
        got = TA.bilateral_filter(torch.from_numpy(images), torch.from_numpy(sc),
                                  torch.from_numpy(ss), radius=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("rad2,r", [((4.0, 25.0), 5), ((4.0, 4.0), 2), ((2.0, 8.0), 5),
                                    ((12.5, 8.0), 4), ((4.0, 25.0), 0)],
                         ids=["per_sample_radius", "radius_2", "rad2_2_8", "rad2_12.5_8",
                              "max_radius_0"])
def test_bilateral_plain_matches_pallas_interpreted(rad2, r):
    """As tests/test_aug_ops.py calls the Pallas kernel (interpret mode off
    the TPU), at a small size. A rad2 that is no perfect square (2, 8, 12.5)
    admits taps that no integer radius names; max radius 0 is the centre tap
    alone."""
    x = seeded_images(1, (2, 16, 32, 3))
    sc = np.array([60.0, 120.0], np.float32).reshape(2, 1, 1, 1)
    ss = np.array([20.0, 200.0], np.float32).reshape(2, 1, 1, 1)
    rad2 = np.array(rad2, np.float32)
    want = JA._bilateral_pallas(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(ss),
                                jnp.asarray(rad2.reshape(2, 1, 1, 1)), r)
    got = bilateral_filter_plain(torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(ss),
                                 torch.from_numpy(rad2), r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_bilateral_wrapper_takes_the_plain_version_on_the_cpu_and_checks_its_inputs(images):
    x = torch.from_numpy(images)
    sc = torch.full((4,), 50.0)
    rad2 = torch.tensor([1.0, 4.0, 9.0, 25.0])
    before = bilateral_filter_fused.launches
    out = bilateral_filter_fused(x, sc, sc, rad2, 5)
    assert bilateral_filter_fused.launches == before  # no kernel on a CPU tensor
    torch.testing.assert_close(out, bilateral_filter_plain(x, sc, sc, rad2, 5), rtol=0, atol=0)
    for bad in (lambda: bilateral_filter_fused(x, sc, sc, rad2, 6),          # radius > 5
                lambda: bilateral_filter_fused(x, sc[:3], sc, rad2, 5),      # one sigma short
                lambda: bilateral_filter_fused(x[0], sc, sc, rad2, 5)):      # not (B, H, W, C)
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("shape,out,method", [
    ((4, 32, 128, 1), (4, 16, 64, 1), "linear"),   # JPEG chroma down: antialiased
    ((4, 16, 64, 1), (4, 32, 128, 1), "linear"),   # JPEG chroma up
    ((4, 2, 4, 1), (4, 32, 128, 1), "cubic"),      # fog octaves
    ((4, 4, 12, 1), (4, 32, 128, 1), "cubic"),     # clouds octaves
    ((4, 4, 19, 3), (4, 32, 128, 3), "nearest"),   # coarse dropout
    ((3, 32, 128, 2), (3, 8, 32, 2), "linear"),    # a 4x downsample
    ((4, 4, 8, 2), (4, 32, 128, 2), "cubic"),      # the elastic grid's upsampling
])
def test_jax_image_resize_matches_jax(shape, out, method):
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = jax_image_resize(torch.from_numpy(x), out, method).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_torch_key_draws_in_call_order_on_one_generator():
    def draws(seed):
        key = TorchKey(torch.Generator().manual_seed(seed))
        k1, k2 = key.split()
        return [k1.uniform((2, 3), -1.0, 2.0), k2.bernoulli(0.3, (5,)), key.randint((4,), 2, 9),
                key.fold_in(999).normal((3,)), k1.laplace((1000,))]

    a, b, c = draws(0), draws(0), draws(1)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    uni, bern, ints, _normal, lap = a
    assert uni.dtype == torch.float32 and ((uni >= -1.0) & (uni < 2.0)).all()
    assert bern.dtype == torch.bool and ints.dtype == torch.int64
    assert ((ints >= 2) & (ints < 9)).all()
    assert torch.isfinite(lap).all() and abs(float(lap.abs().mean()) - 1.0) < 0.15


# ------------------------------------------------------------------ the chain

@pytest.fixture(scope="module")
def chain_images():
    return seeded_images(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_photometric_augment_matches_jax(chain_images, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JG.photometric_augment(key, jnp.asarray(chain_images), 5))
    got = TG.photometric_augment(JaxKey(key), torch.from_numpy(chain_images), 5).numpy()
    assert got.shape == chain_images.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert (diff > 1e-5).mean() <= 0.01, (diff > 1e-5).mean()
    assert not np.allclose(got, chain_images, atol=1e-3)  # the chain changed something


@pytest.mark.parametrize("severity", [0, 7])
def test_other_severities_are_refused(chain_images, severity):
    """Severities 1-6 are ported (tests/test_torch_augment_chains.py); any
    other raises, as in JAX."""
    key = jax.random.PRNGKey(0)
    with pytest.raises(NotImplementedError):
        JG.photometric_augment(key, jnp.asarray(chain_images), severity)
    with pytest.raises(NotImplementedError):
        TG.photometric_augment(JaxKey(key), torch.from_numpy(chain_images), severity)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_affine_with_theta_matches_jax(chain_images, seed):
    key = jax.random.PRNGKey(seed)
    want_img, want_theta = JG.random_affine_with_theta(key, jnp.asarray(chain_images))
    got_img, got_theta = TG.random_affine_with_theta(JaxKey(key), torch.from_numpy(chain_images))
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(want_theta), atol=1e-6)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-4)
    eye = np.eye(3, dtype=np.float32)
    applied = [not np.allclose(t, eye) for t in got_theta.numpy()]
    assert any(applied)  # p = 0.7 per sample


@pytest.mark.parametrize("seed", [0, 1])
def test_pretrain_views_match_jax(chain_images, seed):
    key = jax.random.PRNGKey(seed)
    want_views, want_theta = JG.pretrain_views(key, jnp.asarray(chain_images))
    got_views, got_theta = TG.pretrain_views(JaxKey(key), torch.from_numpy(chain_images))
    assert got_views.shape == (4, 3, 32, 128, 3) and got_theta.shape == (4, 3, 3)
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(want_theta), atol=1e-6)
    diff = np.abs(got_views.numpy() - np.asarray(want_views))
    assert (diff > 1e-4).mean() <= 0.01, (diff > 1e-4).mean()
    # view 0 is the raw image, normalised
    np.testing.assert_allclose(got_views[:, 0].numpy(),
                               ((chain_images - TG.IMAGENET_MEAN) / TG.IMAGENET_STD), atol=1e-6)
    torch.testing.assert_close(TG.denormalize(got_views[:, 0]), torch.from_numpy(chain_images),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------- the finetune chain

def test_channel_shuffle_matches_jax_exactly(chain_images):
    key = jax.random.PRNGKey(5)
    want = np.asarray(JA.op_channel_shuffle(key, jnp.asarray(chain_images), p=0.5))
    got = TA.op_channel_shuffle(JaxKey(key), torch.from_numpy(chain_images), p=0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, chain_images)  # some sample was shuffled


@pytest.mark.parametrize("params", [{}, dict(scale=(1.0, 1.0), translate=0.0, rotate=45.0,
                                             shear_x=0.0, shear_y=0.0)],
                         ids=["affine", "rotation"])
def test_random_affine_matrix_matches_jax(params):
    key = jax.random.PRNGKey(11)
    want = np.asarray(JG._random_affine_matrix(key, 4, 32, 128, **params))
    got = TG._random_affine_matrix(JaxKey(key), 4, 32, 128, **params).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_elastic_grid_matches_jax():
    key = jax.random.PRNGKey(12)
    scale = np.linspace(0.02, 0.2, 4, dtype=np.float32).reshape(4, 1, 1, 1)
    want = np.asarray(JG._elastic_grid(key, 4, 32, 128, jnp.asarray(scale)))
    got = TG._elastic_grid(JaxKey(key), 4, 32, 128, torch.from_numpy(scale)).numpy()
    assert got.shape == (4, 32, 128, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 2])
def test_supervised_augment_matches_jax(chain_images, seed):
    key = jax.random.PRNGKey(seed)
    jax_chain = getattr(JG.supervised_augment, "__wrapped__", JG.supervised_augment)
    want = np.asarray(jax_chain(key, jnp.asarray(chain_images)))
    got = TG.supervised_augment(JaxKey(key), torch.from_numpy(chain_images)).numpy()
    assert got.shape == chain_images.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() <= 0.01, (diff > 1e-4).mean()
    assert not np.allclose(got, chain_images, atol=1e-3)  # the chain changed something
