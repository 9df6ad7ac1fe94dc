"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""

import numpy as np

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
