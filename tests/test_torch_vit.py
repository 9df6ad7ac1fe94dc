"""The port's image/activation ops and ViT against the JAX package, fp32, CPU.

On the CPU the JAX ViT runs its einsum attention chain and the port runs the
plain version of its kernel. Tolerances: 1e-6 for the resize (two small
matmuls), 1e-4 for the three-block ViT (fp32 sums taken in another order,
through LayerNorms that divide by small variances).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.models.vit import VIT_ARCHS as JAX_VIT_ARCHS
from ccd_tpu.ops.activations import gelu as jax_gelu
from ccd_tpu.ops.image import resize_bicubic as jax_resize_bicubic
from ccd_tpu_torch.checkpoints.from_jax import vit_state_dict_from_jax
from ccd_tpu_torch.models.vit import VIT_ARCHS
from ccd_tpu_torch.ops.activations import gelu
from ccd_tpu_torch.ops.image import resize_bicubic

from _torch_port import perturbed_numpy_tree, to_jnp


@pytest.mark.parametrize("scale", [None, ((8 + 0.1) / 16, (32 + 0.1) / 16)])
def test_resize_bicubic_matches_jax(scale):
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 5)).astype(np.float32)
    ref = np.asarray(jax_resize_bicubic(jnp.asarray(x), (8, 32), scale=scale))
    out = resize_bicubic(torch.from_numpy(x), (8, 32), scale=scale).numpy()
    assert out.shape == (1, 8, 32, 5)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_gelu_fp32_is_erf():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(jax_gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), ref, atol=1e-6)


def test_gelu_bf16_is_tanh():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(jax_gelu(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    out = gelu(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    # one bf16 ulp at |y| <= 6 is 2^-6; the two tanh forms round independently
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2 ** -5)
    # and it IS the tanh form, not erf, where the two differ most (|x| ~ 2)
    x2 = torch.tensor([2.0]).bfloat16()
    tanh_val = torch.nn.functional.gelu(x2.float(), approximate="tanh")
    assert abs(float(gelu(x2)) - float(tanh_val)) <= 2 ** -7


@pytest.fixture(scope="module")
def vit_pair():
    jmodel = JAX_VIT_ARCHS["vit_micro"](dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 32, 128, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tree = perturbed_numpy_tree(params, seed=2)
    ref_tokens, ref_taps = jax.jit(
        lambda p, a: jmodel.apply({"params": p}, a))(to_jnp(tree), jnp.asarray(x))
    tmodel = VIT_ARCHS["vit_micro"]().eval()
    tmodel.load_state_dict(vit_state_dict_from_jax(tree), strict=True)
    with torch.no_grad():
        tokens, taps = tmodel(torch.from_numpy(x))
    return (np.asarray(ref_tokens), [np.asarray(t) for t in ref_taps],
            tokens.numpy(), [t.numpy() for t in taps], tmodel, x)


def test_vit_tokens_match_jax(vit_pair):
    ref_tokens, _, tokens, _, _, _ = vit_pair
    assert tokens.shape == (2, 256, 64)
    np.testing.assert_allclose(tokens, ref_tokens, atol=1e-4)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_vit_taps_match_jax(vit_pair, i):
    _, ref_taps, _, taps, _, _ = vit_pair
    assert len(taps) == 3 and taps[i].shape == (2, 8, 32, 64)
    np.testing.assert_allclose(taps[i], ref_taps[i], atol=1e-4)


def test_vit_pos_embed_is_resampled_once_per_table(vit_pair):
    *_, tmodel, x = vit_pair
    with torch.no_grad():
        a = tmodel._interpolate_pos_encoding(256, 32, 128)
        b = tmodel._interpolate_pos_encoding(256, 32, 128)
        assert a is b  # kept between batches
        tmodel.pos_embed.add_(1.0)  # a changed table is resampled
        c = tmodel._interpolate_pos_encoding(256, 32, 128)
        tmodel.pos_embed.sub_(1.0)
    assert c is not a
    np.testing.assert_allclose(c.numpy(), a.numpy() + 1.0, atol=1e-5)
