"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

# small decoder that goes with vit_micro in these tests
MICRO_DECODER = dict(decoder_n_layers=2, decoder_d_embedding=64, decoder_n_head=2,
                     decoder_d_k=32, decoder_d_v=32, decoder_d_model=64,
                     decoder_d_inner=64, max_seq_len=6)


def perturbed_numpy_tree(params, seed: int, amount: float = 0.05):
    """A Flax parameter tree as nested dicts of numpy arrays, every leaf moved
    by seeded numpy noise so that no bias stays zero and no scale stays one."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return jax.tree_util.tree_map(
        lambda a: (a + amount * rng.standard_normal(a.shape)).astype(np.float32), tree)


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class JaxKey:
    """The test-side twin of ``ccd_tpu_torch.data.random.TorchKey``: the same
    methods, answered by ``jax.random`` on a real JAX key, the draws returned
    as CPU torch tensors. The port's ops make the same calls in the same
    order and shapes as the JAX ops, so one JAX key gives both packages
    bitwise-identical draws."""

    def __init__(self, key):
        self.key = key

    def split(self, n: int = 2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data: int):
        return JaxKey(jax.random.fold_in(self.key, data))

    @staticmethod
    def _torch(a):
        import torch
        return torch.from_numpy(np.array(a))

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._torch(jax.random.uniform(self.key, tuple(shape), minval=lo, maxval=hi))

    def bernoulli(self, p, shape):
        return self._torch(jax.random.bernoulli(self.key, p, tuple(shape)))

    def randint(self, shape, lo, hi):
        return self._torch(jax.random.randint(self.key, tuple(shape), lo, hi)).long()

    def normal(self, shape):
        return self._torch(jax.random.normal(self.key, tuple(shape)))

    def laplace(self, shape):
        return self._torch(jax.random.laplace(self.key, tuple(shape)))

    def permutations(self, b, n):
        # the call of ccd_tpu/data/aug_ops.py::some_of_random_order
        return self._torch(jax.vmap(lambda k: jax.random.permutation(k, n))(
            jax.random.split(self.key, b))).long()


def seeded_images(seed: int, shape=(4, 32, 128, 3)) -> np.ndarray:
    """Text-like test images in [0, 1]: flat backgrounds with a few darker
    strokes and some noise, so that histograms, quantisation, clustering and
    edges all have something to work on."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    img = np.ones(shape, np.float32) * rng.uniform(0.55, 0.95, (b, 1, 1, c)).astype(np.float32)
    for i in range(b):
        for _ in range(4):
            y0, x0 = rng.integers(2, h - 12), rng.integers(2, w - 16)
            img[i, y0:y0 + rng.integers(6, 10), x0:x0 + rng.integers(3, 12)] = \
                rng.uniform(0.05, 0.4, c)
    img += rng.normal(scale=0.03, size=shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests with one intra-op torch thread. The suite runs
    six workers on the machine's cores; the augmentation's thousands of small
    ops, each a parallel region over all cores in every worker, then spend
    most of their time waiting for descheduled threads (the fused-step tests
    took 60x longer under the suite's load than alone)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RecordingWriter:
    """Stands in for TensorBoard's ``SummaryWriter``: keeps what it is given
    (scalars as (tag, value, step), images as (tag, shape, step))."""

    def __init__(self, name):
        self.name, self.scalars, self.images, self.closed = name, [], [], False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image).shape, int(step)))

    def close(self):
        self.closed = True


@pytest.fixture(autouse=True)
def recorded_writers(monkeypatch):
    """The trainers' TensorBoard factory replaced by one that hands out
    :class:`RecordingWriter`s (the list of those made): a CLI test pays no
    TensorBoard import (it pulls in TensorFlow where that is installed: seconds)."""
    from ccd_tpu_torch.utils import logging as log_utils
    made = []

    def factory(name):
        made.append(RecordingWriter(name))
        return made[-1]

    monkeypatch.setattr(log_utils, "summary_writer", factory)
    return made
