"""Data parallelism of the port's steps: two gloo processes on the CPU
against the JAX step and the port's own one-process step on the whole batch.

The test process makes a JAX state (``vit_micro``, fp32, perturbed so that
no bias is zero), converts it (``checkpoints/from_jax.py``) and hands it to
two worker processes (tests/_torch_mp_worker.py) with three global batches
of four samples. Each rank runs the port's step on its two samples under a
``torch.distributed`` group; meanwhile the test process runs the JAX step
and the port's step without a group on the whole batches. The ranks' valid
DINO slots (4 + 4 against 6 + 7) and non-PAD targets (2 + 3 against 4 + 5)
differ, so a mean of per-rank means would show.

Held: each rank's reported (global) losses to JAX's within 2e-4 relative,
as the pretrain and finetune parity tests hold them; the two ranks'
parameters, centre and running statistics bit for bit equal; and the ranks'
losses, centre, running statistics and parameters to the one-process
step's within 1e-5 relative (each tensor in L2). The last leaves out, as
tests/test_torch_pretrain_step.py does, the entries whose true gradient is
zero (each attention's key bias, the two biases in front of a BatchNorm):
AdamW moves them by +-lr on the sign of round-off, which the two reduction
orders draw differently (measured: 3e-4 and 1.2e-3 relative for the two
biases). It leaves out for the same reason the running means of the two
BatchNorms behind those biases, which are the biases plus the batch mean of
the product before them (measured: 1.1e-5 and 4.1e-5; every other tensor
within 8.1e-6).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.losses import teacher_temp_schedule as jax_teacher_temp_schedule
from ccd_tpu.models import CCDPretrainModel as JaxPretrainModel
from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu.training import make_pretrain_step as jax_make_pretrain_step
from ccd_tpu.training.finetune_step import FinetuneState as JaxFinetuneState
from ccd_tpu.training.finetune_step import make_finetune_step as jax_make_finetune_step
from ccd_tpu.training.optim import make_adamw, make_optimizer
from ccd_tpu.training.pretrain_step import PretrainState as JaxPretrainState
from ccd_tpu_torch.checkpoints.from_jax import (pretrain_state_dicts_from_jax,
                                                recognizer_state_dict_from_jax)
from ccd_tpu_torch.ops.cc_label import label_clusters

import _torch_mp_worker as W
from _torch_port import perturbed_numpy_tree, to_jnp

LOSS_RTOL_JAX, RTOL_ONE_RANK = 2e-4, 1e-5
BLOBS = (1, 2, 5, 6)          # glyph blobs per sample: 4 + 4 valid slots on rank 0, 6 + 7 on 1
WORD_LENGTHS = (1, 2, 3, 4)   # non-PAD targets after BOS: 2 + 3 on rank 0, 4 + 5 on rank 1
PAD, BOS = 92, 91


def _pretrain_batch(seed: int):
    rng = np.random.default_rng(seed)
    b = W.GLOBAL_BATCH
    images = rng.normal(size=(b, 3, 32, 128, 3)).astype(np.float32)
    masks = np.zeros((b, 32, 128), np.float32)
    for i, n in enumerate(BLOBS):
        for j in range(n):
            masks[i, 8:24, 4 + 20 * j:16 + 20 * j] = 1.0
    theta = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    theta[:, :2] += rng.normal(scale=0.03, size=(b, 2, 3)).astype(np.float32)
    return images, masks, theta


def _finetune_batch(seed: int):
    rng = np.random.default_rng(seed)
    t = W.MICRO_DECODER["max_seq_len"]
    targets = np.full((W.GLOBAL_BATCH, t), PAD, np.int32)
    targets[:, 0] = BOS
    for i, n in enumerate(WORD_LENGTHS):
        targets[i, 1:1 + n] = rng.integers(0, 90, n)
        targets[i, 1 + n] = BOS  # the end token shares BOS's id
    images = rng.normal(size=(W.GLOBAL_BATCH, 32, 128, 3)).astype(np.float32)
    return images, targets


def _noise_driven(name, value):
    skip = np.zeros(value.shape, bool)
    if name.endswith("attn.qkv.bias"):
        c = value.shape[0] // 3
        skip[c:2 * c] = True
    elif name in ("segmentation.unpool1.0.bias", "segmentation.unpool2.0.bias",
                  "segmentation.unpool1.1.running_mean", "segmentation.unpool2.1.running_mean"):
        skip[:] = True
    return skip


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("parallel_steps"))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    # ---- the JAX states, handed over
    jstudent = JaxPretrainModel(arch="vit_micro", out_dim=W.OUT_DIM, with_seg_head=True,
                                norm_last_layer=False, drop_path_rate=0.0)
    jteacher = JaxPretrainModel(arch="vit_micro", out_dim=W.OUT_DIM, with_seg_head=False)
    # Flax's init jitted: a fraction of the time of its eager init here
    variables = jax.jit(jstudent.init)(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                                       jnp.zeros((2, 26, 32, 128)))
    params = perturbed_numpy_tree(variables["params"], 1)
    stats = perturbed_numpy_tree(variables["batch_stats"], 2)
    t_params = perturbed_numpy_tree({"backbone": params["backbone"], "head": params["head"]},
                                    3, amount=0.01)
    center0 = (0.01 * np.random.default_rng(4).normal(size=(1, W.OUT_DIM))).astype(np.float32)
    jmodel = JaxCCDRecognizer(arch="vit_micro", drop_path_rate=0.0, decoder_dropout=0.0,
                              encoder_drop=0.0, **W.MICRO_DECODER)
    init_key = jax.random.PRNGKey(0)
    targets0 = jnp.full((2, W.MICRO_DECODER["max_seq_len"]), PAD, jnp.int32).at[:, 0].set(BOS)
    ft_params = perturbed_numpy_tree(jax.jit(functools.partial(jmodel.init, train_mode=True))(
        {"params": init_key, "dropout": init_key}, jnp.zeros((2, 32, 128, 3)),
        targets0)["params"], seed=21)
    ft_tx = make_adamw(ft_params)

    s_sd, t_sd = pretrain_state_dicts_from_jax(params, stats, t_params)
    arrays = {"center": center0,
              **{f"student.{k}": v.numpy() for k, v in s_sd.items()},
              **{f"teacher.{k}": v.numpy() for k, v in t_sd.items()},
              **{f"net.{k}": v.numpy()
                 for k, v in recognizer_state_dict_from_jax(ft_params).items()}}
    for i in range(W.N_STEPS):
        for key, a in zip(("images", "masks", "theta"), _pretrain_batch(10 + i)):
            arrays[f"pretrain_{key}_{i}"] = a
        for key, a in zip(("images", "targets"), _finetune_batch(20 + i)):
            arrays[f"finetune_{key}_{i}"] = a
    np.savez(os.path.join(out_dir, "steps_inputs.npz"), **arrays)
    procs = W.launch_workers("steps", out_dir)
    try:
        # ---- meanwhile: JAX on the whole batches
        tx = make_optimizer("adamw", to_jnp(params), norm_last_layer=False)
        jstate = JaxPretrainState(
            student_params=to_jnp(params), student_stats=to_jnp(stats),
            teacher_params=to_jnp(t_params), opt_state=tx.init(to_jnp(params)),
            center=jnp.asarray(center0), iteration=jnp.zeros((), jnp.int32),
            rng=jax.random.PRNGKey(5))
        jstep = jax.jit(jax_make_pretrain_step(
            jstudent, jteacher, tx, teacher_temps=jax_teacher_temp_schedule(*W.TEACHER_TEMPS),
            use_fused_ce=False, **W.PRETRAIN_SCHEDULE))
        jax_pretrain = []
        for i in range(W.N_STEPS):
            jstate, m = jstep(jstate, *(jnp.asarray(arrays[f"pretrain_{k}_{i}"])
                                        for k in ("images", "masks", "theta")))
            jax_pretrain.append([float(m[k]) for k in ("loss", "mask_loss", "dino_loss")])
        ft_state = JaxFinetuneState(params=to_jnp(ft_params),
                                    opt_state=ft_tx.init(to_jnp(ft_params)),
                                    iteration=jnp.zeros((), jnp.int32), rng=init_key)
        ft_step = jax.jit(jax_make_finetune_step(jmodel, ft_tx, **W.FINETUNE_SCHEDULE))
        jax_finetune = []
        for i in range(W.N_STEPS):
            ft_state, m = ft_step(ft_state, jnp.asarray(arrays[f"finetune_images_{i}"]),
                                  jnp.asarray(arrays[f"finetune_targets_{i}"]))
            jax_finetune.append(float(m["loss"]))
        # ---- and the port's step without a group on the whole batches, on
        # one thread as the workers run (the cores are shared with them)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one_rank = {"pretrain": W.pretrain_run(arrays), "finetune": W.finetune_run(arrays)}
        finally:
            torch.set_num_threads(threads)
    finally:
        W.wait_for(procs)

    ranks = [dict(np.load(os.path.join(out_dir, f"steps_rank{r}.npz"))) for r in range(W.WORLD)]
    return {"arrays": arrays, "jax_pretrain": np.asarray(jax_pretrain),
            "jax_finetune": np.asarray(jax_finetune), "one_rank": one_rank, "ranks": ranks}


def test_ranks_hold_unequal_valid_counts(runs):
    arrays, half = runs["arrays"], W.GLOBAL_BATCH // W.WORLD
    clusters, _ = label_clusters(torch.from_numpy(arrays["pretrain_masks_0"]), num_slots=26)
    slots = (clusters.flatten(2).amax(-1) > 0).sum(1).clamp(3, 26) + 1  # char_validity_mask
    assert slots.tolist() == [4, 4, 6, 7]
    tgt = arrays["finetune_targets_0"][:, 1:]
    counts = (tgt != PAD).sum(1)
    assert counts[:half].sum() != counts[half:].sum()


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_pretrain_ranks_track_jax_on_the_whole_batch(runs, rank):
    got = runs["ranks"][rank]["pretrain_losses"]
    assert got.shape == (W.N_STEPS, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, runs["jax_pretrain"], rtol=LOSS_RTOL_JAX)


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_finetune_ranks_track_jax_on_the_whole_batch(runs, rank):
    np.testing.assert_allclose(runs["ranks"][rank]["finetune_losses"], runs["jax_finetune"],
                               rtol=LOSS_RTOL_JAX)


def test_ranks_hold_bit_equal_states(runs):
    a, b = runs["ranks"]
    assert set(a) == set(b)
    for name in a:
        assert np.array_equal(a[name], b[name]), name


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_pretrain_ranks_equal_the_one_rank_step(runs, rank):
    losses, student, teacher, center = runs["one_rank"]["pretrain"]
    got = runs["ranks"][rank]
    np.testing.assert_allclose(got["pretrain_losses"], losses, rtol=RTOL_ONE_RANK)
    assert _rel(got["center"], center) <= RTOL_ONE_RANK
    stats = [n for n in student if "running_" in n]
    assert len(stats) == 16
    for who, ref in (("student", student), ("teacher", teacher)):
        for name, want in ref.items():
            keep = ~_noise_driven(name, want)
            if keep.any():
                assert _rel(got[f"{who}.{name}"][keep], want[keep]) <= RTOL_ONE_RANK, \
                    f"{who}.{name}"


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_finetune_ranks_equal_the_one_rank_step(runs, rank):
    losses, net = runs["one_rank"]["finetune"]
    got = runs["ranks"][rank]
    np.testing.assert_allclose(got["finetune_losses"], losses, rtol=RTOL_ONE_RANK)
    for name, want in net.items():
        keep = ~_noise_driven(name, want)
        if keep.any():
            assert _rel(got[f"net.{name}"][keep], want[keep]) <= RTOL_ONE_RANK, name
