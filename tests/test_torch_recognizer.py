"""The evaluation slice as a whole, port against JAX package, fp32, CPU:
JAX init -> numpy tree -> the port's converter -> strict load -> the same
uint8 images through ``make_predict_fn`` of both packages.

Tolerance 1e-4 absolute on per-step probabilities (fp32 sums in another order
through 3 ViT blocks and 2 decoder layers); decoded strings must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.checkpoints.torch_export import save_recognizer_torch
from ccd_tpu.convertor import AttnConvertor as JaxAttnConvertor
from ccd_tpu.data.synthetic import make_synthetic_batch
from ccd_tpu.evaluation import runner as jax_runner
from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu_torch.builders import load_recognizer_params
from ccd_tpu_torch.checkpoints.from_jax import recognizer_state_dict_from_jax
from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.evaluation import runner
from ccd_tpu_torch.models import CCDRecognizer

from _torch_port import MICRO_DECODER, perturbed_numpy_tree, to_jnp


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxCCDRecognizer(arch="vit_micro", **MICRO_DECODER)
    rng = jax.random.PRNGKey(0)
    img = jnp.zeros((1, 32, 128, 3))
    tgt = jnp.full((1, 6), jmodel.padding_idx, jnp.int32)
    params = jmodel.init({"params": rng, "dropout": rng}, img, tgt, train_mode=True)["params"]
    tree = perturbed_numpy_tree(params, seed=3)
    # sharpen the classifier so that greedy argmaxes are well separated
    tree["decoder"]["classifier"]["kernel"] = tree["decoder"]["classifier"]["kernel"] * 20.0
    tmodel = CCDRecognizer(arch="vit_micro", **MICRO_DECODER).eval()
    tmodel.load_state_dict(recognizer_state_dict_from_jax(tree), strict=True)
    images, _, _ = make_synthetic_batch(4, seed=7)
    return jmodel, to_jnp(tree), tree, tmodel, images


def test_probabilities_match_jax(pair):
    jmodel, jparams, _, tmodel, images = pair
    ref = np.asarray(jax_runner._decode(jmodel, jparams, jnp.asarray(images), False))
    out = runner.decode(tmodel, torch.from_numpy(images)).numpy()
    assert out.shape == (4, 6, 92) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_predicted_strings_identical(pair):
    jmodel, jparams, _, tmodel, images = pair
    jpredict = jax_runner.make_predict_fn(
        jmodel, jparams, JaxAttnConvertor("DICT90", max_seq_len=6, with_unknown=True),
        batch_size=4)
    tpredict = runner.make_predict_fn(
        tmodel, AttnConvertor("DICT90", max_seq_len=6, with_unknown=True))
    ref, out = jpredict(images), tpredict(images)
    assert out == ref
    assert any(len(s) > 0 for s in out)  # the comparison is not of empty strings


def test_train_mode_forward_matches_jax(pair):
    jmodel, jparams, _, tmodel, images = pair
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.25
    targets = np.random.default_rng(0).integers(0, 91, size=(4, 6)).astype(np.int32)
    ref, _ = jax.jit(lambda p, a, t: jmodel.apply({"params": p}, a, t, train_mode=True))(
        jparams, jnp.asarray(x), jnp.asarray(targets))
    with torch.no_grad():
        out, attn = tmodel(torch.from_numpy(x), torch.from_numpy(targets).long(),
                           train_mode=True)
    assert attn.shape == (4, 2, 6, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_test_speed_path_matches_jax(pair):
    jmodel, jparams, _, tmodel, images = pair
    ref = np.asarray(jax_runner._decode(jmodel, jparams, jnp.asarray(images), True))
    out = runner.decode(tmodel, torch.from_numpy(images), test_speed=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("module_prefix", [False, True])
def test_reference_pth_round_trip(pair, tmp_path, module_prefix):
    """A ``{'net': sd}`` pickle written by the JAX package's exporter (with the
    reference's extra cls_token / position_table keys, with or without the
    DataParallel prefix) loads strictly through the port's loader."""
    _, _, tree, tmodel, images = pair
    path = str(tmp_path / "best_accuracy.pth")
    save_recognizer_torch(tree, path, iteration=5, module_prefix=module_prefix)
    fresh = CCDRecognizer(arch="vit_micro", **MICRO_DECODER).eval()
    load_recognizer_params(path, fresh)
    for (k, a), (_, b) in zip(sorted(fresh.state_dict().items()),
                              sorted(tmodel.state_dict().items())):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


def test_own_state_dict_round_trip_and_strictness(pair, tmp_path):
    *_, tmodel, _ = pair
    path = str(tmp_path / "port.pth")
    torch.save(tmodel.state_dict(), path)
    fresh = CCDRecognizer(arch="vit_micro", **MICRO_DECODER).eval()
    load_recognizer_params(path, fresh)
    np.testing.assert_array_equal(fresh.backbone.pos_embed.detach().numpy(),
                                  tmodel.backbone.pos_embed.detach().numpy())
    sd = dict(tmodel.state_dict())
    sd["backbone.surprise"] = torch.zeros(1)
    torch.save({"net": sd}, path)
    with pytest.raises(RuntimeError):
        load_recognizer_params(path, fresh)
