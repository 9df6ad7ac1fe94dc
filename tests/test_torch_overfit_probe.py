"""The port's learnability probe (``ccd_tpu_torch/cli/overfit_probe.py``)
against the JAX tool (``tools/overfit_probe.py``), CPU, ``vit_micro`` with
the small decoder, dropout and drop path off (randomness does not cross
frameworks).

Held: the probe's words, images (both render paths) and targets byte for
byte against the JAX tool's procedure on the JAX package's renderer and
convertor; three probe steps' losses within 2e-4 relative of the JAX
``make_fused_finetune_step`` from the same converted weights, and the
learning rates to 1e-9; the probe's greedy-decoded strings equal to the JAX
recognizer's greedy decode of the probe's trained weights, carried back by
the port's reference-layout export and the JAX importer.
"""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.checkpoints.torch_import import convert_recognizer_checkpoint
from ccd_tpu.convertor import AttnConvertor as JaxAttnConvertor
from ccd_tpu.data.augment import normalize as jax_normalize
from ccd_tpu.data.synthetic import random_words as jax_random_words
from ccd_tpu.data.synthetic import render_word as jax_render_word
from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu.training.finetune_step import FinetuneState as JaxFinetuneState
from ccd_tpu.training.finetune_step import make_fused_finetune_step as jax_make_fused_step
from ccd_tpu.training.optim import make_adamw
from ccd_tpu_torch.checkpoints.from_jax import recognizer_state_dict_from_jax
from ccd_tpu_torch.checkpoints.torch_export import recognizer_reference_state_dict
from ccd_tpu_torch.cli.overfit_probe import main, probe_data, run_overfit_probe
from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.dataset import SupervisedDataset
from ccd_tpu_torch.models import CCDRecognizer

from _torch_port import MICRO_DECODER, one_torch_thread, perturbed_numpy_tree, to_jnp  # noqa: F401

N, STEPS, LR = 8, 3, 1e-3
NO_DROPOUT = dict(drop_path_rate=0.0, decoder_dropout=0.0, encoder_drop=0.0)
T = MICRO_DECODER["max_seq_len"]


def _jax_tool_data(n, hard, max_seq_len=25):
    """tools/overfit_probe.py's data lines, on the JAX package's functions."""
    rng = np.random.default_rng(0)
    words = jax_random_words(n, rng, min_len=2, max_len=6)
    images = np.zeros((n, 32, 128, 3), np.uint8)
    if hard:
        for i, wd in enumerate(words):
            big, _ = jax_render_word(wd, 48, 160, rng, hard=True)
            images[i] = cv2.resize(big, (128, 32))
    else:
        for i, wd in enumerate(words):
            images[i], _ = jax_render_word(wd, 32, 128, rng)
    targets = JaxAttnConvertor("DICT90", max_seq_len=max_seq_len, with_unknown=True) \
        .str2tensor(words)
    return words, images, targets


@pytest.mark.parametrize("hard", [False, True], ids=["plain", "hard"])
def test_probe_data_is_the_jax_tools(hard):
    words, images = probe_data(32, hard)
    targets = AttnConvertor("DICT90", max_seq_len=25, with_unknown=True).str2tensor(words)
    jwords, jimages, jtargets = _jax_tool_data(32, hard)
    assert words == jwords
    assert images.dtype == jimages.dtype == np.uint8
    assert images.tobytes() == jimages.tobytes()
    assert targets.dtype == np.asarray(jtargets).dtype and \
        targets.tobytes() == np.asarray(jtargets).tobytes()


def test_chip_smoke_probe_lmdb_holds_the_probe_data(tmp_path):
    """chip_smoke.py's IIIT5k_probe benchmark, read as the evaluation reads
    it: the probe's words and images."""
    import chip_smoke
    root = str(tmp_path / "IIIT5k_probe")
    words, images = probe_data(32)
    assert chip_smoke.write_probe_lmdb(root, 32) == words
    ds = SupervisedDataset(path=root, is_training=False, max_seq_len=25)
    assert len(ds) == 32
    for i, (word, image) in enumerate(zip(words, images)):
        got, target, text = ds[i]
        assert text == word
        np.testing.assert_array_equal(got, image)
        np.testing.assert_array_equal(
            target, AttnConvertor("DICT90", max_seq_len=25, with_unknown=True)
            .str2tensor([word])[0])


@pytest.fixture(scope="module")
def runs():
    """Three JAX fused finetune steps and three probe steps of the port from
    the same (perturbed) weights on the probe's data."""
    jmodel = JaxCCDRecognizer(arch="vit_micro", **NO_DROPOUT, **MICRO_DECODER)
    tgt = jnp.full((2, T), jmodel.padding_idx, jnp.int32).at[:, 0].set(jmodel.start_idx)
    # the state of ccd_tpu/training/finetune_step.py::init_finetune_state, its init jitted
    params = jax.jit(lambda rng: jmodel.init({"params": rng, "dropout": rng},
                                             jnp.zeros((2, 32, 128, 3)), tgt,
                                             train_mode=True))(jax.random.PRNGKey(0))["params"]
    params = perturbed_numpy_tree(params, seed=31)
    tx = make_adamw(to_jnp(params))
    state = JaxFinetuneState(params=to_jnp(params), opt_state=tx.init(to_jnp(params)),
                             iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(1))
    step = jax.jit(jax_make_fused_step(jmodel, tx, base_lr=LR, min_lr=1e-6, total_iters=STEPS,
                                       warmup_iters=20, weight_decay=0.05, clip_grad=5.0))
    words, images, targets = _jax_tool_data(N, False, T)
    jax_losses, jax_lrs = [], []
    for _ in range(STEPS):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(targets))
        jax_losses.append(float(metrics["loss"]))
        jax_lrs.append(float(metrics["lr"]))

    model = CCDRecognizer(arch="vit_micro", **NO_DROPOUT, **MICRO_DECODER)
    model.load_state_dict(recognizer_state_dict_from_jax(params), strict=True)
    result = run_overfit_probe(model, n=N, steps=STEPS, lr=LR, log_every=1)
    return jmodel, words, images, jax_losses, jax_lrs, result


def test_probe_losses_track_the_jax_step(runs):
    _, words, _, jax_losses, jax_lrs, result = runs
    assert result["words"] == words and len(result["losses"]) == STEPS
    np.testing.assert_array_equal(result["targets"], _jax_tool_data(N, False, T)[2])
    np.testing.assert_allclose(result["losses"], jax_losses, rtol=2e-4)
    np.testing.assert_allclose(result["lrs"], jax_lrs, rtol=1e-6, atol=1e-9)
    assert np.all(np.isfinite(result["losses"])) and result["seconds"] > 0
    assert result["correct"] == sum(p.lower() == w.lower()
                                    for p, w in zip(result["predictions"], words))
    assert not result["model"].training


def test_probe_decode_matches_jax_greedy_decode_of_its_weights(runs):
    jmodel, words, images, _, _, result = runs
    params = convert_recognizer_checkpoint(recognizer_reference_state_dict(result["model"]),
                                           n_layers=MICRO_DECODER["decoder_n_layers"], depth=3)
    x = jax_normalize(jnp.asarray(images).astype(jnp.float32) / 255.0)
    scores = jax.jit(lambda p, images: jmodel.apply({"params": p}, images, train_mode=False,
                                                    deterministic=True))(to_jnp(params), x)
    convertor = JaxAttnConvertor("DICT90", max_seq_len=T, with_unknown=True)
    indexes, _ = convertor.tensor2idx(np.asarray(scores))
    assert result["predictions"] == convertor.idx2str(indexes)


def test_probe_cli_builds_the_jax_tools_model(monkeypatch):
    seen = {}

    def probe(model, **kwargs):
        seen.update(model=model, **kwargs)
        return kwargs
    monkeypatch.setattr("ccd_tpu_torch.cli.overfit_probe.run_overfit_probe", probe)
    main(["--steps", "7", "--n", "4", "--hard", "--device", "cpu"])
    model = seen.pop("model")
    assert seen == dict(n=4, steps=7, lr=1e-3, hard=True)
    assert (model.backbone.embed_dim, len(model.backbone.blocks), model.max_seq_len) == (64, 3, 25)
    assert len(model.decoder.layer_stack) == 6 and model.dtype == torch.float32
