"""Tensor parallelism of the port's DINO head (``mesh.model_parallel`` 2):
gloo processes on the CPU (tests/_torch_mp_worker.py, suite ``tp``) as
(data, model) = (2, 2) over four processes and (1, 2) over two, against the
JAX step on one device and the port's one-process step, both on the
concatenated global batch.

The test process makes a JAX state (``vit_micro``, fp32, ``out_dim`` 256,
perturbed so that no bias is zero), converts it and hands it over with four
global batches of four samples; the two data ranks of (2, 2) hold 4 + 4
and 6 + 7 valid DINO slots, so a mean of per-rank means would show. While
the workers run, it runs the JAX step and the port's one-process step
(which writes the checkpoint the (1, 2) ranks resume from).

Held, as ``tests/test_train_steps.py::test_pretrain_step_tensor_parallel_
matches_data_parallel`` holds the JAX package's own (data, model) mesh to
its data mesh: every rank's losses within 1e-4 of JAX's and of the
one-process step's over three steps; the gathered ``last_layer.weight_v``
and centre within 1e-5 of the one-process step's and of JAX's; the
replicated parameters bit for bit equal on every rank, the shards on the
ranks of one model index; a checkpoint of the (1, 2) run resumed in one
process and the one-process checkpoint resumed at (1, 2), the next loss
within 1e-5 of the run that went on; a lars step and a BatchNorm DINO
head's forward and backward against one process; the layout's refusals in
the JAX package's words; and ``cli.collective_audit`` at (2, 2) beside the
same audit at ``model_parallel`` 1.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.losses import teacher_temp_schedule as jax_teacher_temp_schedule
from ccd_tpu.models import CCDPretrainModel as JaxPretrainModel
from ccd_tpu.training import make_pretrain_step as jax_make_pretrain_step
from ccd_tpu.training.optim import make_optimizer
from ccd_tpu.training.pretrain_step import PretrainState as JaxPretrainState
from ccd_tpu_torch.checkpoints.from_jax import pretrain_state_dicts_from_jax
from ccd_tpu_torch.training.pretrain_step import (SHARDED_PARAMETERS, pretrain_state_payload,
                                                  restore_pretrain_state)

import _torch_mp_worker as W
from _torch_port import perturbed_numpy_tree, to_jnp

LOSS_ATOL, TENSOR_ATOL, RESUME_RTOL = 1e-4, 1e-5, 1e-5
BLOBS = (1, 2, 5, 6)          # glyph blobs per sample: 4 + 4 valid slots, then 6 + 7
WORLDS = {4: "data2_model2", 2: "data1_model2"}
BOTTLENECK = 256              # the DINO head's last-layer input width
BIASES_BEFORE_BATCHNORM = ("mlp.0.bias", "mlp.3.bias")  # the BatchNorm head's


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


def _load(path):
    return torch.load(path, weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tensor_parallel"))
    jstudent = JaxPretrainModel(arch="vit_micro", out_dim=W.OUT_DIM, with_seg_head=True,
                                norm_last_layer=False, drop_path_rate=0.0)
    jteacher = JaxPretrainModel(arch="vit_micro", out_dim=W.OUT_DIM, with_seg_head=False)
    variables = jax.jit(jstudent.init)(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                                       jnp.zeros((2, 26, 32, 128)))
    params = perturbed_numpy_tree(variables["params"], 1)
    stats = perturbed_numpy_tree(variables["batch_stats"], 2)
    t_params = perturbed_numpy_tree({"backbone": params["backbone"], "head": params["head"]},
                                    3, amount=0.01)
    center0 = (0.01 * np.random.default_rng(4).normal(size=(1, W.OUT_DIM))).astype(np.float32)
    s_sd, t_sd = pretrain_state_dicts_from_jax(params, stats, t_params)
    arrays = {"center": center0, **{f"student.{k}": v.numpy() for k, v in s_sd.items()},
              **{f"teacher.{k}": v.numpy() for k, v in t_sd.items()}}
    for i in range(W.N_STEPS + 1):
        for key, a in zip(("images", "masks", "theta"), _pretrain_batch(30 + i)):
            arrays[f"pretrain_{key}_{i}"] = a
    np.savez(os.path.join(out_dir, "tp_inputs.npz"), **arrays)
    dirs = {world: os.path.join(out_dir, name) for world, name in WORLDS.items()}
    procs = []
    for world, d in dirs.items():
        os.makedirs(d)
        procs += W.launch_workers("tp", d, world=world)
    one = {}

    def one_process():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            state = W.tp_state(arrays)
            one["losses"] = W.tp_steps(state, arrays)
            payload = pretrain_state_payload(state)
            tmp = os.path.join(out_dir, W.MP1_CHECKPOINT + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(out_dir, W.MP1_CHECKPOINT))
            one["weight_v"] = state.student.head.last_layer.weight_v.detach().numpy().copy()
            one["center"] = state.center.numpy().copy()
            one["next_loss"] = W.tp_steps(state, arrays, steps=[W.N_STEPS])
            lars = W.tp_state(arrays, optimizer="lars")
            one["lars_loss"] = W.tp_steps(lars, arrays, steps=[0], warmup_iters=0)
            one["lars"] = pretrain_state_payload(lars)
            one["bn_head"] = W.bn_head_run()
        finally:
            torch.set_num_threads(threads)

    # ---- meanwhile: the port in one process, on one torch thread (its
    # checkpoint first: the (1, 2) ranks wait for it), beside JAX on the
    # whole batches (whose step compiles for most of this time)
    port = threading.Thread(target=one_process)
    port.start()
    try:
        tx = make_optimizer("adamw", to_jnp(params), norm_last_layer=False)
        jstate = JaxPretrainState(
            student_params=to_jnp(params), student_stats=to_jnp(stats),
            teacher_params=to_jnp(t_params), opt_state=tx.init(to_jnp(params)),
            center=jnp.asarray(center0), iteration=jnp.zeros((), jnp.int32),
            rng=jax.random.PRNGKey(5))
        jstep = jax.jit(jax_make_pretrain_step(
            jstudent, jteacher, tx, teacher_temps=jax_teacher_temp_schedule(*W.TEACHER_TEMPS),
            use_fused_ce=False, **W.PRETRAIN_SCHEDULE))
        jax_losses = []
        for i in range(W.N_STEPS):
            jstate, m = jstep(jstate, *(jnp.asarray(arrays[f"pretrain_{k}_{i}"])
                                        for k in ("images", "masks", "theta")))
            jax_losses.append([float(m[k]) for k in ("loss", "mask_loss", "dino_loss")])
        jax_run = {"losses": np.asarray(jax_losses),
                   # JAX's (bottleneck, out_dim) kernel is the port's weight_v transposed
                   "weight_v": np.asarray(jstate.student_params["head"]["last_layer_v"]).T,
                   "center": np.asarray(jstate.center)}
    finally:
        port.join()
        W.wait_for(procs)
    assert set(one) == {"losses", "weight_v", "center", "next_loss", "lars_loss", "lars",
                        "bn_head"}, "the one-process run failed"

    results = {}
    for world, d in dirs.items():
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"tp_rank{r}.json")) as f:
                ranks.append(dict(json.load(f),
                                  **np.load(os.path.join(d, f"tp_rank{r}.npz"))))
        results[world] = {"ranks": ranks, "checkpoint": _load(os.path.join(d, "tp_ckpt.pt")),
                          "lars": _load(os.path.join(d, "tp_lars.pt")),
                          "bn_head": _load(os.path.join(d, "tp_bn_head.pt"))}
    # ---- the (1, 2) checkpoint resumed in one process, for the next step
    resumed = W.tp_state(arrays)
    restore_pretrain_state(resumed, results[2]["checkpoint"])
    one["resumed_next_loss"] = W.tp_steps(resumed, arrays, steps=[W.N_STEPS])
    return {"one": one, "jax": jax_run, "tp": results}


@pytest.mark.parametrize("world", WORLDS)
def test_layout_is_jax_reshape_of_the_ranks(runs, world):
    """rank = data_index * mp + model_index (JAX's ``reshape(n // mp, mp)``);
    each data group has n / mp ranks, each model group mp."""
    for r, got in enumerate(runs["tp"][world]["ranks"]):
        assert got["layout"] == [r // W.TP_MP, r % W.TP_MP, world // W.TP_MP, W.TP_MP,
                                 world // W.TP_MP, W.TP_MP]


@pytest.mark.parametrize("case", ["divisor", "span_hosts", "out_dim", "fused_ce",
                                  "other_data_ranks"])
def test_layout_refusals_in_the_jax_packages_words(runs, case):
    assert all(r["refusals"][case] for world in WORLDS for r in runs["tp"][world]["ranks"])


@pytest.mark.parametrize("world", WORLDS)
def test_steps_equal_jax_and_the_one_process_step(runs, world):
    tp, one, jax_run = runs["tp"][world], runs["one"], runs["jax"]
    for got in tp["ranks"]:
        assert got["losses"].shape == (W.N_STEPS, 3) and np.isfinite(got["losses"]).all()
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=0, atol=LOSS_ATOL)
    ckpt = tp["checkpoint"]
    weight_v = ckpt["student"]["head.last_layer.weight_v"].numpy()
    center = ckpt["center"].numpy()
    assert weight_v.shape == (W.OUT_DIM, BOTTLENECK) and center.shape == (1, W.OUT_DIM)
    for want in (one, jax_run):
        np.testing.assert_allclose(weight_v, want["weight_v"], rtol=0, atol=TENSOR_ATOL)
        np.testing.assert_allclose(center, want["center"], rtol=0, atol=TENSOR_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_tensors_bit_equal_and_shards_per_model_index(runs, world):
    ranks = runs["tp"][world]["ranks"]
    sharded = {f"{who}.{n}" for who in ("student", "teacher") for n in SHARDED_PARAMETERS}
    sharded.add("center")
    names = [k for k in ranks[0] if k.startswith(("student.", "teacher.")) or k == "center"]
    assert sharded <= set(names)
    for name in names:
        for r, got in enumerate(ranks):
            same_as = r % W.TP_MP if name in sharded else 0
            assert np.array_equal(got[name], ranks[same_as][name]), (name, r)
    half = W.OUT_DIM // W.TP_MP
    for name in sharded:
        assert ranks[0][name].shape[0 if name != "center" else 1] == half
        assert not np.array_equal(ranks[0][name], ranks[1][name]), name


def test_checkpoint_crosses_between_model_parallel_2_and_1(runs):
    """The (1, 2) run's checkpoint (full tensors) resumed in one process, and
    the one-process checkpoint resumed at (1, 2): the next step's losses
    equal those of the run that went on."""
    one = runs["one"]
    for got in runs["tp"][2]["ranks"]:
        np.testing.assert_allclose(one["resumed_next_loss"], got["next_loss"], rtol=RESUME_RTOL)
        np.testing.assert_allclose(got["resumed_next_loss"], one["next_loss"], rtol=RESUME_RTOL)
    ckpt = runs["tp"][2]["checkpoint"]  # one data rank's generators, the full tensors
    assert ckpt["world_size"] == 1 and len(ckpt["generators"]) == 1
    assert [t.shape for t in ckpt["opt_state"]["nu"]] == \
        [t.shape for t in one["lars"]["opt_state"]["trace"]]
    for who in ("student", "teacher"):  # the one-process layout: the export reads it as is
        assert {n: t.shape for n, t in ckpt[who].items()} == \
            {n: t.shape for n, t in one["lars"][who].items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what", ["lars", "bn_head"])
def test_lars_step_and_batchnorm_head_equal_one_process(runs, what, world):
    one, tp = runs["one"], runs["tp"][world]
    if what == "lars":
        for got in tp["ranks"]:
            np.testing.assert_allclose(got["lars_loss"], one["lars_loss"], rtol=1e-5)
        want = one["lars"]
        trace, ref = tp["lars"]["trace"], want["opt_state"]["trace"]
        assert [t.shape for t in trace] == [t.shape for t in ref]
        # the whole momentum (entries whose true gradient is 0, such as the
        # attention key biases', hold round-off on both sides) and the head's
        names = [n for n in want["student"] if "running" not in n]
        assert _rel(torch.cat([t.flatten() for t in trace]),
                    torch.cat([t.flatten() for t in ref])) <= 1e-5
        for n in SHARDED_PARAMETERS:
            i = names.index(n)
            assert _rel(trace[i], ref[i]) <= 1e-5, n
        for n in SHARDED_PARAMETERS:
            assert _rel(tp["lars"]["student"][n], want["student"][n]) <= 1e-6, n
        assert _rel(tp["lars"]["center"], want["center"]) <= 1e-6
        return
    loss, grads, stats = one["bn_head"]
    got = tp["bn_head"]
    assert got["loss"] == pytest.approx(loss, rel=1e-6)
    assert set(got["grads"]) == set(grads) and len(stats) == 4
    for n, g in grads.items():
        if n in BIASES_BEFORE_BATCHNORM:  # true gradient 0: round-off on both sides
            assert max(float(got["grads"][n].abs().max()), float(g.abs().max())) <= 1e-6, n
        else:
            assert _rel(got["grads"][n], g) <= 1e-5, n
    for n, v in stats.items():
        assert _rel(got["stats"][n], v) <= 1e-6, n


def test_collective_audit_at_data2_model2_and_model_parallel_1(runs):
    """``cli.collective_audit`` at world 4, rank 0's JSON line. With
    ``--model_parallel 2``: the replicated gradients cross the world (4 bytes
    a replicated parameter), the sharded ones the data group (4 bytes a
    parameter of the rank's half), the CE's row statistics, the head input's
    gradient and the sharded norms the model group, the centre's sums the
    rank's columns. With 1: the data-parallel schedule (one all-reduce of 4
    bytes a parameter), no model group."""
    ranks = runs["tp"][4]["ranks"]
    audits = {}
    for mp in (W.TP_MP, 1):
        lines = ranks[0][f"audit_mp{mp}_printed"].strip().splitlines()
        assert len(lines) == 1 and all(r[f"audit_mp{mp}_printed"] == "" for r in ranks[1:])
        audits[mp] = json.loads(lines[0])
        assert audits[mp] == ranks[0][f"audit_mp{mp}"]
    tp, dp = audits[W.TP_MP], audits[1]
    assert (tp["world"], tp["model_parallel"], tp["data_ranks"]) == (4, 2, 2)
    assert (dp["world"], dp["model_parallel"], dp["data_ranks"]) == (4, 1, 4)
    out_dim, params = tp["out_dim"], tp["student_parameters"]
    sharded = out_dim * (BOTTLENECK + 1)
    assert params == dp["student_parameters"] == dp["student_parameters_on_rank"]
    assert params - tp["student_parameters_on_rank"] == sharded // 2
    c = tp["collectives"]
    assert c["all_reduce:gradients"] == {"calls_per_step": 1.0,
                                         "bytes_per_step": 4.0 * (params - sharded)}
    assert c["all_reduce:sharded_gradients"] == {"calls_per_step": 1.0,
                                                 "bytes_per_step": 4.0 * sharded / 2}
    rows = 2 * 2 * 26  # two views of a data rank's 2 samples, 26 char slots each
    assert c["all_reduce_max:dino_ce_max"]["bytes_per_step"] == 4.0 * rows * 2
    assert c["all_reduce:dino_ce_sums"]["bytes_per_step"] == 4.0 * rows * 3
    assert c["all_reduce:head_input_backward"]["bytes_per_step"] == 4.0 * rows * BOTTLENECK
    assert c["all_reduce:sharded_norms"]["calls_per_step"] == 1.0
    assert c["all_reduce:center"]["bytes_per_step"] == 4.0 * (out_dim // 2 + 1)
    assert set(tp["groups"]) == {"world", "data", "model"}
    assert dp["collectives"]["all_reduce:gradients"] == {"calls_per_step": 1.0,
                                                         "bytes_per_step": 4.0 * params}
    assert dp["collectives"]["all_reduce:center"]["bytes_per_step"] == 4.0 * (out_dim + 1)
    assert set(dp["groups"]) == {"world"} and not any(
        k.split(":")[1].startswith(("dino_ce", "head_input", "sharded")) for k in dp["collectives"])


def test_sharded_ce_without_a_group_is_the_plain_chain():
    """``_ShardedCrossViewCE`` over all the columns (no model group): the
    loss and the logits' gradient of ``dino_char_loss``'s plain chain."""
    from ccd_tpu_torch.losses.losses import _ShardedCrossViewCE, dino_char_loss
    gen = torch.Generator().manual_seed(0)
    b, t, k = 3, 5, 64
    s = torch.randn(2 * b, t, k, generator=gen, requires_grad=True)
    teacher = torch.randn(2 * b, t, k, generator=gen)
    center = 0.1 * torch.randn(1, k, generator=gen)
    valid = torch.rand(b, t, generator=gen) < 0.6
    plain = dino_char_loss(s, teacher, valid, center, 0.04, 0.1)
    w = valid.float().reshape(-1)
    sharded = _ShardedCrossViewCE.apply(s, teacher, torch.cat([w, w]), center, 0.04, 0.1,
                                        w.sum(), None)
    assert float(sharded.detach()) == pytest.approx(float(plain.detach()), rel=1e-6)
    (g_plain,), (g_sharded,) = (torch.autograd.grad(x, s) for x in (plain, sharded))
    assert _rel(g_sharded, g_plain) <= 1e-6


def test_shards_of_rows_and_columns_round_trip():
    """``shard_rows`` keeps part i of n along a dim (a model rank's rows of
    ``weight_v``, columns of the centre), refuses what does not split, and
    ``gather_rows`` without a group is the identity; a DINO head's last
    layer keeps its rank's outputs."""
    from ccd_tpu_torch.models.heads import DINOHead
    from ccd_tpu_torch.parallel.mesh import gather_rows, shard_rows
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(shard_rows(x, 1, 2), x[2:])
    assert torch.equal(shard_rows(x, 2, 3, 1), x[:, 4:])
    assert torch.equal(torch.cat([shard_rows(x, i, 3, dim=1) for i in range(3)], 1), x)
    with pytest.raises(ValueError, match="does not split into 4"):
        shard_rows(x, 0, 4, dim=1)
    assert gather_rows(x, None, "test") is x
    head = DINOHead(8, 12, hidden_dim=16, bottleneck_dim=4)
    full = head.last_layer.weight_v.detach().clone()
    head.shard_last_layer(2, 3, None)
    assert torch.equal(head.last_layer.weight_v, full[8:])
    assert head.last_layer.weight_g.shape == (4, 1)
    assert head(torch.randn(5, 8)).shape == (5, 4)
