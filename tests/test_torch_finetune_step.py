"""The finetune path of the port against the JAX package's, fp32, CPU,
``vit_micro`` with a 2-layer decoder, and the pieces around its step.

Held to JAX: ``tf_loss`` (1e-6, rows with PAD), global-norm clipping (1e-6
relative), the weight-decay mask leaf for leaf after the name mapping, and
four steps from the same converted weights on the same normalised images and
targets, dropout and drop path off (randomness does not cross frameworks),
clipping on, two warm-up steps: losses within 2e-4 relative, learning rates
to 1e-6, and each tensor's movement over the four steps within a tenth of
the JAX movement in L2. Parameters are not compared entry by entry: in its
first steps AdamW moves every entry by about lr * sign(gradient), so an entry
whose gradient is within fp32 noise of zero moves one way on one side and
the other way on the other (see tests/test_torch_pretrain_step.py); the key
third of each ViT qkv bias, whose true gradient is zero (softmax ignores a
per-query shift), is left out by name.

Held within the port, same process, same arithmetic (0 tolerance): the fused
step against the step on the augmented views its generator gives, K
multi-step iterations against K fused steps, a restored payload against the
run it was saved from, and the backbone hand-off from a pretraining
checkpoint. Dropout draws from the state's generator only.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.losses import tf_loss as jax_tf_loss
from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu.training.finetune_step import init_finetune_state as jax_init_finetune_state
from ccd_tpu.training.finetune_step import make_finetune_step as jax_make_finetune_step
from ccd_tpu.training.optim import clip_gradients_global_norm as jax_clip_global_norm
from ccd_tpu.training.optim import weight_decay_mask as jax_weight_decay_mask
from ccd_tpu_torch.builders import load_finetune_payload, load_pretrained_backbone
from ccd_tpu_torch.checkpoints.from_jax import recognizer_state_dict_from_jax
from ccd_tpu_torch.checkpoints.torch_io import CheckpointManager, save_payload
from ccd_tpu_torch.data.augment import normalize, supervised_augment
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.data.synthetic import make_synthetic_batch
from ccd_tpu_torch.losses import tf_loss
from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.training.finetune_step import (finetune_state_payload, init_finetune_state,
                                                  make_finetune_step, make_fused_finetune_step,
                                                  make_multi_finetune_step,
                                                  restore_finetune_state)
from ccd_tpu_torch.training.optim import clip_gradients_global_norm, weight_decay_mask
from ccd_tpu_torch.training.pretrain_step import init_pretrain_state, pretrain_state_payload

from _torch_port import MICRO_DECODER, one_torch_thread, perturbed_numpy_tree, to_jnp  # noqa: F401

N_STEPS, BATCH, T = 4, 4, MICRO_DECODER["max_seq_len"]
PAD, BOS = 92, 91
SCHEDULE = dict(base_lr=1e-3, min_lr=1e-5, total_iters=20, warmup_iters=2, weight_decay=0.05,
                clip_grad=0.5)
NO_DROPOUT = dict(drop_path_rate=0.0, decoder_dropout=0.0, encoder_drop=0.0)
LOSS_RTOL, MOVE_RTOL = 2e-4, 0.1


def _targets(seed: int) -> np.ndarray:
    """BOS, a word of 1..T-2 characters, EOS, then PAD."""
    rng = np.random.default_rng(seed)
    tgt = np.full((BATCH, T), PAD, np.int32)
    tgt[:, 0] = BOS
    for i in range(BATCH):
        n = 1 + i % (T - 2)
        tgt[i, 1:1 + n] = rng.integers(0, 90, n)
        tgt[i, 1 + n] = BOS  # the end token shares BOS's id
    return tgt


def _images(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(BATCH, 32, 128, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """JAX init, perturbed, and four jitted steps; the port's starting weights."""
    jmodel = JaxCCDRecognizer(arch="vit_micro", **NO_DROPOUT, **MICRO_DECODER)
    state, tx = jax_init_finetune_state(jax.random.PRNGKey(0), jmodel)
    params = perturbed_numpy_tree(state.params, seed=21)
    state = state.replace(params=to_jnp(params), opt_state=tx.init(to_jnp(params)))
    step = jax.jit(jax_make_finetune_step(jmodel, tx, **SCHEDULE))
    metrics = []
    for i in range(N_STEPS):
        state, m = step(state, jnp.asarray(_images(i)), jnp.asarray(_targets(i)))
        metrics.append({k: float(v) for k, v in m.items()})
    as_np = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    final = {k: v.numpy() for k, v in recognizer_state_dict_from_jax(as_np).items()}
    return params, metrics, final


def _port_model(params=None, **rates) -> CCDRecognizer:
    model = CCDRecognizer(arch="vit_micro", **(rates or NO_DROPOUT), **MICRO_DECODER)
    if params is not None:
        model.load_state_dict(recognizer_state_dict_from_jax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def port_run(jax_run):
    params, _, _ = jax_run
    state = init_finetune_state(_port_model(params))
    step = make_finetune_step(**SCHEDULE)
    metrics = []
    for i in range(N_STEPS):
        state, m = step(state, torch.from_numpy(_images(i)), torch.from_numpy(_targets(i)))
        metrics.append({"loss": float(m["loss"]), "lr": m["lr"]})
    start = {k: v.numpy() for k, v in recognizer_state_dict_from_jax(params).items()}
    final = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    return metrics, start, final, state


def test_tf_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=3.0, size=(3, 7, 92)).astype(np.float32)
    targets = np.array([[BOS, 3, 4, 5, BOS, PAD, PAD], [BOS, 80, BOS, PAD, PAD, PAD, PAD],
                        [BOS, 1, 2, 3, 4, 5, BOS]], np.int32)
    want = float(jax_tf_loss(jnp.asarray(logits), jnp.asarray(targets), PAD))
    got = float(tf_loss(torch.from_numpy(logits), torch.from_numpy(targets), PAD))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # only PAD after BOS: the mean over no targets is 0, not NaN
    empty = np.full((1, 7), PAD, np.int32)
    assert float(tf_loss(torch.from_numpy(logits[:1]), torch.from_numpy(empty), PAD)) == 0.0


@pytest.mark.parametrize("clip", [None, 0.5, 1e3], ids=["off", "clipping", "below_threshold"])
def test_global_norm_clip_matches_jax(clip):
    rng = np.random.default_rng(1)
    grads = {f"g{i}": rng.normal(size=shape).astype(np.float32)
             for i, shape in enumerate([(3, 4), (5,), (2, 2, 2)])}
    want = jax_clip_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, clip)
    got = clip_gradients_global_norm([torch.from_numpy(v.copy()) for v in grads.values()], clip)
    for g, k in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    if clip == 0.5:
        norm = np.sqrt(sum(float((g.numpy() ** 2).sum()) for g in got))
        np.testing.assert_allclose(norm, 0.5, rtol=1e-5)


def test_weight_decay_mask_matches_jax(jax_run):
    """JAX's mask over its recognizer tree, carried through the name mapping
    as arrays of 0/1, equals the port's mask by name; the word embedding
    (ndim 2) is decayed on both sides."""
    params, _, _ = jax_run
    mask = jax_weight_decay_mask(params)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                       mask, params)
    want = {k: bool(v.numpy().reshape(-1)[0]) for k, v in
            recognizer_state_dict_from_jax(as_arrays).items()}
    got = weight_decay_mask(dict(_port_model().named_parameters()))
    assert got == want
    assert got["decoder.trg_word_emb.weight"] and not got["backbone.blocks.0.attn.qkv.bias"]


def test_losses_and_lr_track_jax(jax_run, port_run):
    _, jmetrics, _ = jax_run
    metrics = port_run[0]
    np.testing.assert_allclose([m["loss"] for m in metrics], [m["loss"] for m in jmetrics],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([m["lr"] for m in metrics], [m["lr"] for m in jmetrics],
                               rtol=1e-6, atol=1e-12)
    assert metrics[0]["lr"] == 0.0 and metrics[2]["lr"] > 0  # warm-up from zero
    assert metrics[-1]["loss"] < metrics[1]["loss"]


def test_parameters_move_as_in_jax(jax_run, port_run):
    _, _, jfinal = jax_run
    _, start, final, _ = port_run
    moved_tensors = 0
    for name, want in jfinal.items():
        keep = np.ones(want.shape, bool)
        if name.endswith("attn.qkv.bias"):
            c = want.shape[0] // 3
            keep[c:2 * c] = False  # the key bias: zero true gradient
        moved_want = (want - start[name])[keep]
        moved_got = (final[name] - start[name])[keep]
        if np.linalg.norm(moved_want) == 0:  # unreached on both sides (the seg taps' norms)
            assert np.linalg.norm(moved_got) == 0, name
            continue
        moved_tensors += 1
        assert np.linalg.norm(moved_got - moved_want) <= MOVE_RTOL * np.linalg.norm(moved_want), \
            name
    assert moved_tensors > 50


def _twin(state):
    twin = copy.copy(state)
    twin.model = copy.deepcopy(state.model)
    twin.opt_state = copy.deepcopy(state.opt_state)
    twin.generator, twin.aug_generator = torch.Generator(), torch.Generator()
    twin.generator.set_state(state.generator.get_state())
    twin.aug_generator.set_state(state.aug_generator.get_state())
    return twin


def _assert_same(a, b):
    for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    for p, q in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert a.iteration == b.iteration


@pytest.fixture(scope="module")
def raw_batches():
    images, _, _ = make_synthetic_batch(2 * BATCH, seed=5)
    targets = np.stack([_targets(0), _targets(1)])
    return (torch.from_numpy(images).reshape(2, BATCH, 32, 128, 3),
            torch.from_numpy(targets))


def test_fused_step_is_the_step_on_its_augmented_views(jax_run, raw_batches):
    raws, targets = raw_batches
    state = init_finetune_state(_port_model(jax_run[0]), seed=3)
    twin = _twin(state)
    state, m = make_fused_finetune_step(aug_fn=supervised_augment, **SCHEDULE)(
        state, raws[0], targets[0])
    views = supervised_augment(TorchKey(twin.aug_generator), raws[0].float() / 255.0)
    twin, m_ref = make_finetune_step(**SCHEDULE)(twin, normalize(views), targets[0])
    assert float(m["loss"]) == float(m_ref["loss"])
    _assert_same(state, twin)


def test_multi_step_is_k_fused_steps(jax_run, raw_batches):
    raws, targets = raw_batches
    state = init_finetune_state(_port_model(jax_run[0]), seed=4)
    twin = _twin(state)
    state, stacked = make_multi_finetune_step(aug_fn=supervised_augment, **SCHEDULE)(
        state, raws, targets)
    fused = make_fused_finetune_step(aug_fn=supervised_augment, **SCHEDULE)
    losses = []
    for raw, tgt in zip(raws, targets):
        twin, m = fused(twin, raw, tgt)
        losses.append(float(m["loss"]))
    assert stacked["loss"].shape == (2,) and stacked["loss"].tolist() == losses
    assert state.iteration == 2
    _assert_same(state, twin)


def test_dropout_draws_from_the_state_generator_only(jax_run):
    """Dropout 0.1 in the encoder and decoder and drop path 0.1: one seed
    gives one loss, another seed another, and torch's global generator is
    neither read nor advanced; without a generator, training mode raises."""
    rates = dict(drop_path_rate=0.1, decoder_dropout=0.1, encoder_drop=0.1)
    x, tgt = torch.from_numpy(_images(0)), torch.from_numpy(_targets(0))
    step = make_finetune_step(**SCHEDULE)
    states = [init_finetune_state(_port_model(jax_run[0], **rates), seed=seed)
              for seed in (7, 7, 8)]
    torch.manual_seed(123)
    rng_before = torch.get_rng_state()
    losses = [float(step(state, x, tgt)[1]["loss"]) for state in states]
    assert torch.equal(torch.get_rng_state(), rng_before)
    assert losses[0] == losses[1] and losses[0] != losses[2]
    model = _port_model(jax_run[0], **rates).train()
    with pytest.raises(ValueError, match="generator"):
        model(x, tgt.long(), train_mode=True)
    with torch.no_grad():  # evaluation mode draws nothing and needs no generator
        model.eval()(x, tgt.long(), train_mode=True)


def test_payload_restore_continues_bit_identically(jax_run, tmp_path):
    step = make_finetune_step(**SCHEDULE)
    state = init_finetune_state(_port_model(jax_run[0]))
    for i in range(2):
        state, _ = step(state, torch.from_numpy(_images(i)), torch.from_numpy(_targets(i)))
    path = str(tmp_path / "best_accuracy.pt")
    save_payload(path, finetune_state_payload(state, best_accuracy=0.25))
    payload = load_finetune_payload(path)
    assert payload["iteration"] == 2 and payload["best_accuracy"] == 0.25
    restored = restore_finetune_state(init_finetune_state(_port_model()), payload)
    _assert_same(state, restored)
    x, tgt = torch.from_numpy(_images(2)), torch.from_numpy(_targets(2))
    state, m1 = step(state, x, tgt)
    restored, m2 = step(restored, x, tgt)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(state, restored)
    # a CheckpointManager directory holds a payload; a weights-only file does not
    manager = CheckpointManager(str(tmp_path / "run"))
    manager.save(3, finetune_state_payload(state))
    assert load_finetune_payload(str(tmp_path / "run"))["iteration"] == 3
    torch.save({"net": state.model.state_dict()}, str(tmp_path / "weights.pth"))
    assert load_finetune_payload(str(tmp_path / "weights.pth")) is None


@pytest.fixture(scope="module")
def pretrain_state():
    student = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=True,
                               norm_last_layer=False)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=False)
    g = torch.Generator().manual_seed(0)
    student.reset_parameters(g)
    teacher.reset_parameters(g)
    state = init_pretrain_state(student, teacher)
    with torch.no_grad():  # the teacher drifts from the student, as the EMA makes it
        for p in teacher.backbone.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    return state


def _assert_backbone_is_the_teacher(model, teacher):
    got, want = model.backbone.state_dict(), teacher.backbone.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


def test_backbone_hand_off_from_a_port_pretrain_checkpoint(pretrain_state, tmp_path):
    manager = CheckpointManager(str(tmp_path / "pre"))
    manager.save(10, pretrain_state_payload(pretrain_state))
    model = load_pretrained_backbone(str(tmp_path / "pre"), _port_model())
    _assert_backbone_is_the_teacher(model, pretrain_state.teacher)
    model = load_pretrained_backbone(manager.path(10), _port_model())
    _assert_backbone_is_the_teacher(model, pretrain_state.teacher)


def test_backbone_hand_off_from_a_reference_layout_pth(pretrain_state, tmp_path):
    """{'student', 'teacher', ...} with DDP ``module.`` prefixes and the
    reference's unused ``backbone.cls_token``."""
    prefixed = lambda sd: {f"module.{k}": v for k, v in sd.items()}
    teacher_sd = prefixed(pretrain_state.teacher.state_dict())
    teacher_sd["module.backbone.cls_token"] = torch.zeros(1, 1, 64)
    path = str(tmp_path / "checkpoint.pth")
    torch.save({"student": prefixed(pretrain_state.student.state_dict()),
                "teacher": teacher_sd, "epoch": 3, "iteration": 1000}, path)
    model = load_pretrained_backbone(path, _port_model())
    _assert_backbone_is_the_teacher(model, pretrain_state.teacher)
    assert os.path.isfile(path)
