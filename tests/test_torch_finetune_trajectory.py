"""A finetune trajectory of the port against the JAX package's: 30 steps.

The 4-step parity test (tests/test_torch_finetune_step.py) is too short to
see a slow drift, and the convergence demo's two packages learned apart on
the CPU (PERF.md, PR 10). Here both packages start from JAX's own ``init``
of a ``vit_micro`` recognizer (the port's weights through
``checkpoints/from_jax.py``), take the same 30 batches of the demo's easy
rendered words (``data/synthetic.py``, as ``--easy --no_aug`` feeds them:
ImageNet-normalised, no augmentation), fp32, dropout and drop path off, with
the demo's optimizer settings (lr 1e-3 after a 10-step warm-up, weight decay
0.05, global-norm clip 5) and hold every step's loss within 1e-3 relative.

The same comparison at ``vit_tiny`` with the demo's decoder (3 layers,
width 256, 25 steps of text) takes minutes on the CPU; it is not a test,
and runs as ``python tests/test_torch_finetune_trajectory.py``, which
prints each step's two losses and their largest relative difference.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu.training.finetune_step import FinetuneState as JaxFinetuneState
from ccd_tpu.training.finetune_step import make_finetune_step as jax_make_finetune_step
from ccd_tpu.training.optim import make_adamw
from ccd_tpu_torch.checkpoints.from_jax import recognizer_state_dict_from_jax
from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.augment import normalize
from ccd_tpu_torch.data.synthetic import make_synthetic_batch
from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.training.finetune_step import init_finetune_state, make_finetune_step

from _torch_port import MICRO_DECODER, one_torch_thread  # noqa: F401 (fixture)

N_STEPS, BATCH, MAX_SEQ_LEN = 30, 4, 10   # words of 2-8 characters, BOS and EOS
SCHEDULE = dict(base_lr=1e-3, min_lr=1e-6, total_iters=4000, warmup_iters=10,
                weight_decay=0.05, clip_grad=5.0)
NO_DROPOUT = dict(drop_path_rate=0.0, decoder_dropout=0.0, encoder_drop=0.0)
DECODER = dict(MICRO_DECODER, max_seq_len=MAX_SEQ_LEN)
LOSS_RTOL = 1e-3


def trajectory(arch: str = "vit_micro", decoder: dict = DECODER, n_steps: int = N_STEPS,
               batch: int = BATCH):
    """Both packages' losses over ``n_steps`` finetune steps from one JAX init."""
    convertor = AttnConvertor("DICT90", max_seq_len=decoder["max_seq_len"], with_unknown=True)
    batches = []
    for i in range(n_steps):
        images, _masks, words = make_synthetic_batch(batch, seed=100 + i)
        x = normalize(torch.from_numpy(images).float() / 255.0).numpy()
        batches.append((x, convertor.str2tensor(words)))
    jmodel = JaxCCDRecognizer(arch=arch, **NO_DROPOUT, **decoder)
    # ccd_tpu/training/finetune_step.py::init_finetune_state, its init jitted
    # (a third of the time of Flax's eager init here)
    key = jax.random.PRNGKey(0)
    x0, t0 = batches[0]
    params = jax.jit(functools.partial(jmodel.init, train_mode=True))(
        {"params": key, "dropout": key}, jnp.asarray(x0[:2]), jnp.asarray(t0[:2]))["params"]
    tx = make_adamw(params)
    jstate = JaxFinetuneState(params=params, opt_state=tx.init(params),
                              iteration=jnp.zeros((), jnp.int32), rng=key)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    jstep = jax.jit(jax_make_finetune_step(jmodel, tx, **SCHEDULE))
    want = []
    for x, t in batches:
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(t))
        want.append(float(m["loss"]))

    model = CCDRecognizer(arch=arch, **NO_DROPOUT, **decoder)
    model.load_state_dict(recognizer_state_dict_from_jax(params), strict=True)
    state = init_finetune_state(model)
    step = make_finetune_step(**SCHEDULE)
    got = []
    for x, t in batches:
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(t))
        got.append(float(m["loss"]))
    return np.asarray(got), np.asarray(want)


@pytest.fixture(scope="module")
def losses(one_torch_thread):
    return trajectory()


def test_every_step_loss_tracks_jax(losses):
    got, want = losses
    assert got.shape == (N_STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_the_trajectory_learns(losses):
    """The 30 steps are not flat: the loss falls from ~ln(92) as the
    decoder learns the words' lengths and frequent characters."""
    got, _ = losses
    assert got[-4:].mean() < got[:4].mean() - 0.5


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    demo_decoder = dict(decoder_n_layers=3, decoder_d_embedding=256, decoder_n_head=8,
                        decoder_d_model=256, decoder_d_inner=1024, decoder_d_k=32,
                        decoder_d_v=32, max_seq_len=25)
    got, want = trajectory("vit_tiny", demo_decoder, n_steps=40, batch=16)
    print(json.dumps({"arch": "vit_tiny", "steps": len(got), "batch": 16, "port": got.tolist(),
                      "jax": want.tolist(),
                      "max_rel_diff": float(np.max(np.abs(got / want - 1)))}))
