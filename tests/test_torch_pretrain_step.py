"""The pretraining path as a whole: the port's step against the JAX
package's, from the same converted state, on the same views, theta and masks,
fp32, CPU, vit_micro, six steps, drop path off (randomness does not cross
frameworks).

Two regimes: ground-truth masks with the last layer frozen for the first two
steps and the teacher temperature warming up (JAX with the fused CE kernel,
interpreted), and self-predicted masks from step 0 (JAX with the plain
chain). The port runs each with ``use_fused_ce`` True and False.

Tolerances. Losses: 2e-4 relative over six steps of fp32 AdamW. Parameters:
in its first steps AdamW moves every entry by about lr * sign(gradient), so
an entry whose gradient is within fp32 noise of zero moves one way on one
side and the other way on the other, by up to 2 * lr a step, and no per-entry
tolerance holds; entries whose TRUE gradient is zero (the key bias of every
attention: softmax ignores a per-query shift; the two biases in front of a
BatchNorm) are pure noise and are left out by name. What is held is each
tensor's movement over the six steps: the two sides' movements differ by at
most a tenth of the movement in L2 (measured: under 6 %; a wrong sign, mask
or schedule gives O(1)), and a checksum over all parameters to 1e-4. The
exact optimizer arithmetic is held in tests/test_torch_optim.py. Running
statistics and centre: 1e-5 after the first step, where both sides still have
the same parameters (a running variance fed the unbiased batch variance
would be off by 5e-5 there), and 5e-4 after six, where the activations
they average come from parameters that differ as said. With self-predicted
masks one more thing can differ: the mask is a threshold on the segmentation
logits, and a pixel within fp32 noise of it may fall on the other side in
one framework, which changes that image's clusters a little from then on; the
movement and last-step limits are doubled and quadrupled there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.losses import teacher_temp_schedule as jax_teacher_temp_schedule
from ccd_tpu.models import CCDPretrainModel as JaxPretrainModel
from ccd_tpu.training import make_pretrain_step as jax_make_pretrain_step
from ccd_tpu.training.optim import make_optimizer
from ccd_tpu.training.optim import weight_decay_mask as jax_weight_decay_mask
from ccd_tpu.training.pretrain_step import PretrainState as JaxPretrainState
from ccd_tpu_torch.checkpoints.from_jax import pretrain_state_dicts_from_jax
from ccd_tpu_torch.losses import teacher_temp_schedule
from ccd_tpu_torch.training.optim import weight_decay_mask
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state, make_pretrain_step,
                                                  pretrain_state_payload)

from _torch_port import perturbed_numpy_tree, to_jnp

N_STEPS, BATCH, OUT_DIM = 6, 4, 256
SCHEDULE = dict(base_lr=5e-4, min_lr=1e-6, total_iters=100, warmup_iters=3,
                weight_decay=0.04, weight_decay_end=0.4, momentum_teacher=0.99,
                clip_grad=3.0, freeze_last_layer=1, global_batch=BATCH,
                imgnet_based=3 * BATCH)  # epoch 0 for two steps, then 1, 1, 1, 2
REGIMES = {"gt_masks": dict(gt_mask_epochs=30, jax_fused=True),
           "predicted_masks": dict(gt_mask_epochs=0, jax_fused=False)}
LOSS_RTOL, CHECKSUM_RTOL = 2e-4, 1e-4
MOVE_RTOL = {"gt_masks": 0.1, "predicted_masks": 0.2}
STAT_ATOL = {"gt_masks": {"first": 1e-5, "last": 5e-4},
             "predicted_masks": {"first": 1e-5, "last": 2e-3}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(BATCH, 3, 32, 128, 3)).astype(np.float32)
    masks = np.zeros((BATCH, 32, 128), np.float32)
    for i in range(BATCH):
        for x0 in (10, 50, 90)[:1 + i % 3]:
            masks[i, 8:24, x0 + i:x0 + i + 16] = 1.0
    theta = np.tile(np.eye(3, dtype=np.float32), (BATCH, 1, 1))
    theta[:, :2] += rng.normal(scale=0.03, size=(BATCH, 2, 3)).astype(np.float32)
    return images, masks, theta


def _noise_driven(name, value):
    """Boolean array: entries of parameter ``name`` whose true gradient is zero."""
    skip = np.zeros(value.shape, bool)
    if name.endswith("attn.qkv.bias"):
        c = value.shape[0] // 3
        skip[c:2 * c] = True
    elif name in ("segmentation.unpool1.0.bias", "segmentation.unpool2.0.bias"):
        skip[:] = True
    return skip


@pytest.fixture(scope="module", params=list(REGIMES))
def runs(request):
    regime = REGIMES[request.param]
    images, masks, theta = _batch(0)
    jstudent = JaxPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                                norm_last_layer=False, drop_path_rate=0.0)
    jteacher = JaxPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    variables = jstudent.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                              jnp.zeros((2, 26, 32, 128)))
    params = perturbed_numpy_tree(variables["params"], 1)
    stats = perturbed_numpy_tree(variables["batch_stats"], 2)
    t_params = perturbed_numpy_tree({"backbone": params["backbone"], "head": params["head"]},
                                    3, amount=0.01)
    center0 = (0.01 * np.random.default_rng(4).normal(size=(1, OUT_DIM))).astype(np.float32)

    # ---- the JAX package, one jit
    tx = make_optimizer("adamw", to_jnp(params), norm_last_layer=False)
    jstate = JaxPretrainState(
        student_params=to_jnp(params), student_stats=to_jnp(stats),
        teacher_params=to_jnp(t_params), opt_state=tx.init(to_jnp(params)),
        center=jnp.asarray(center0), iteration=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(5))
    jstep = jax.jit(jax_make_pretrain_step(
        jstudent, jteacher, tx, teacher_temps=jax_teacher_temp_schedule(0.04, 0.07, 3, 10),
        gt_mask_epochs=regime["gt_mask_epochs"], use_fused_ce=regime["jax_fused"], **SCHEDULE))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))

    def jax_snapshot(st):
        student, teacher = pretrain_state_dicts_from_jax(
            as_np(st.student_params), as_np(st.student_stats), as_np(st.teacher_params))
        return dict(student={k: v.numpy() for k, v in student.items()},
                    teacher={k: v.numpy() for k, v in teacher.items()},
                    center=np.asarray(st.center))

    jmetrics, ref = [], {}
    for i in range(N_STEPS):
        jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(theta))
        jmetrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            ref["first"] = jax_snapshot(jstate)
    ref.update(jax_snapshot(jstate), metrics=jmetrics)

    # ---- the port, plain chain and fused wrapper (its plain version on the CPU)
    out = {}
    for fused in (False, True):
        student = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                                   norm_last_layer=False, drop_path_rate=0.0)
        teacher = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
        state = init_pretrain_state(student, teacher)
        s_sd, t_sd = pretrain_state_dicts_from_jax(params, stats, t_params)
        student.load_state_dict(s_sd, strict=True)
        teacher.load_state_dict(t_sd, strict=True)
        state.center = torch.from_numpy(center0.copy())
        step = make_pretrain_step(
            teacher_temps=teacher_temp_schedule(0.04, 0.07, 3, 10),
            gt_mask_epochs=regime["gt_mask_epochs"], use_fused_ce=fused, **SCHEDULE)
        def snapshot():
            return dict(student={k: v.numpy().copy() for k, v in student.state_dict().items()},
                        teacher={k: v.numpy().copy() for k, v in teacher.state_dict().items()},
                        center=state.center.numpy().copy())

        metrics, out[fused] = [], {}
        for i in range(N_STEPS):
            state, m = step(state, torch.from_numpy(images), torch.from_numpy(masks),
                            torch.from_numpy(theta))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                out[fused]["first"] = snapshot()
        out[fused].update(snapshot(), metrics=metrics, state=state)
    start = dict(student={k: v.numpy() for k, v in s_sd.items()},
                 teacher={k: v.numpy() for k, v in t_sd.items()}, center=center0)
    return ref, out, start, request.param


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
@pytest.mark.parametrize("key", ["loss", "mask_loss", "dino_loss"])
def test_losses_track_jax(runs, fused, key):
    ref, out, _, _ = runs
    want = [m[key] for m in ref["metrics"]]
    got = [m[key] for m in out[fused]["metrics"]]
    assert np.isfinite(got).all() and len(got) == N_STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
def test_schedules_and_epochs_track_jax(runs, fused):
    ref, out, _, _ = runs
    for key in ("lr", "wd", "epoch"):
        np.testing.assert_allclose([m[key] for m in out[fused]["metrics"]],
                                   [m[key] for m in ref["metrics"]], rtol=1e-6, atol=1e-12)
    assert [m["epoch"] for m in out[fused]["metrics"]] == [0, 0, 1, 1, 1, 2]
    assert out[fused]["state"].iteration == N_STEPS


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
@pytest.mark.parametrize("who", ["student", "teacher"])
def test_parameters_track_jax(runs, fused, who):
    ref, out, start, regime = runs
    got = out[fused][who]
    checksum_got = checksum_want = 0.0
    for name, want in ref[who].items():
        if "running_" in name:
            continue
        keep = ~_noise_driven(name, want)
        if not keep.any():
            continue
        moved_want = (want - start[who][name])[keep]
        moved_got = (got[name] - start[who][name])[keep]
        assert np.linalg.norm(moved_want) > 0, f"{name} did not move"
        assert np.linalg.norm(moved_got - moved_want) <= MOVE_RTOL[regime] * np.linalg.norm(moved_want), \
            name
        checksum_got += float(np.abs(got[name][keep]).sum())
        checksum_want += float(np.abs(want[keep]).sum())
    np.testing.assert_allclose(checksum_got, checksum_want, rtol=CHECKSUM_RTOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
@pytest.mark.parametrize("when", ["first", "last"])
def test_running_stats_and_center_track_jax(runs, fused, when):
    ref, out, start, regime = runs
    want, got = (ref, out[fused]) if when == "last" else (ref["first"], out[fused]["first"])
    names = [n for n in want["student"] if "running_" in n]
    assert len(names) == 16
    for name in names:
        np.testing.assert_allclose(got["student"][name], want["student"][name],
                                   atol=STAT_ATOL[regime][when], err_msg=name)
        assert np.abs(got["student"][name] - start["student"][name]).max() > 1e-3
    np.testing.assert_allclose(got["center"], want["center"], atol=STAT_ATOL[regime][when])
    assert np.abs(got["center"] - start["center"]).max() > 1e-3


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
def test_first_step_parameters_match_jax(runs, fused):
    """lr is 0 at iteration 0 (warm-up from zero): the student stays put and
    the teacher's EMA step is exact."""
    ref, out, start, regime = runs
    for who in ("student", "teacher"):
        for name, want in ref["first"][who].items():
            np.testing.assert_allclose(out[fused]["first"][who][name], want, atol=1e-6,
                                       err_msg=name)
    moved = max(np.abs(out[fused]["first"]["teacher"][n] - start["teacher"][n]).max()
                for n in start["teacher"])
    assert moved > 1e-4


def test_fused_and_plain_ce_steps_agree(runs):
    _, out, _, _ = runs
    for key in ("loss", "mask_loss", "dino_loss"):
        np.testing.assert_allclose([m[key] for m in out[True]["metrics"]],
                                   [m[key] for m in out[False]["metrics"]], rtol=LOSS_RTOL)


def test_last_layer_moves_once_unfrozen(runs):
    ref, out, start, regime = runs
    v = "head.last_layer.weight_v"
    moved = np.abs(out[False]["student"][v] - start["student"][v]).max()
    assert moved > 1e-4  # four unfrozen steps at lr ~5e-4
    np.testing.assert_allclose(moved, np.abs(ref["student"][v] - start["student"][v]).max(),
                               rtol=0.05)


def test_state_payload_names_what_a_checkpoint_needs(runs):
    _, out, _, _ = runs
    payload = pretrain_state_payload(out[True]["state"])
    assert set(payload) == {"student", "teacher", "opt_state", "center", "iteration",
                            "world_size", "generators"}
    assert payload["world_size"] == 1 and len(payload["generators"]) == 1
    assert payload["iteration"] == N_STEPS and payload["opt_state"]["count"] == N_STEPS
    assert len(payload["opt_state"]["mu"]) == len(list(out[True]["state"].student.parameters()))
    assert not any(k.startswith("segmentation") for k in payload["teacher"])


def test_frozen_weight_norm_gain_two_steps_match_jax():
    """``norm_last_layer=True`` (the ViT-Base configuration): the DINOHead's
    weight-norm gain ``last_layer.weight_g`` gets no gradient and no weight
    decay in either package, so it stays bit for bit where it started (moved
    off 1 by the seeded perturbation) while ``weight_v`` trains; two steps
    with the last layer unfrozen (the first at lr 0), the losses and
    ``weight_v``'s movement on the tolerances above."""
    images, masks, theta = _batch(1)
    schedule = dict(SCHEDULE, freeze_last_layer=0)
    jstudent = JaxPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                                norm_last_layer=True, drop_path_rate=0.0)
    jteacher = JaxPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    variables = jstudent.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                              jnp.zeros((2, 26, 32, 128)))
    params = perturbed_numpy_tree(variables["params"], 6)
    stats = perturbed_numpy_tree(variables["batch_stats"], 7)
    t_params = {"backbone": params["backbone"], "head": params["head"]}
    tx = make_optimizer("adamw", to_jnp(params), norm_last_layer=True)
    jstate = JaxPretrainState(
        student_params=to_jnp(params), student_stats=to_jnp(stats),
        teacher_params=to_jnp(t_params), opt_state=tx.init(to_jnp(params)),
        center=jnp.zeros((1, OUT_DIM)), iteration=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(5))
    jstep = jax.jit(jax_make_pretrain_step(
        jstudent, jteacher, tx, teacher_temps=jax_teacher_temp_schedule(0.04, 0.07, 3, 10),
        gt_mask_epochs=30, use_fused_ce=False, **schedule))

    student = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                               norm_last_layer=True, drop_path_rate=0.0)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    state = init_pretrain_state(student, teacher)
    s_sd, t_sd = pretrain_state_dicts_from_jax(params, stats, t_params)
    student.load_state_dict(s_sd, strict=True)
    teacher.load_state_dict(t_sd, strict=True)
    step = make_pretrain_step(teacher_temps=teacher_temp_schedule(0.04, 0.07, 3, 10),
                              gt_mask_epochs=30, **schedule)
    named = dict(student.named_parameters())
    assert not weight_decay_mask(named, True)["head.last_layer.weight_g"]
    assert not np.asarray(jax_weight_decay_mask(params, True)["head"]["last_layer_g"])

    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(theta))
        state, m = step(state, torch.from_numpy(images), torch.from_numpy(masks),
                        torch.from_numpy(theta))
        for key in ("loss", "mask_loss", "dino_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=LOSS_RTOL, err_msg=key)
    jax_head = jax.device_get(jstate.student_params["head"])
    g0, v0 = s_sd["head.last_layer.weight_g"].numpy(), s_sd["head.last_layer.weight_v"].numpy()
    assert np.abs(g0 - 1.0).max() > 1e-3  # the gain starts off its initial value of 1
    np.testing.assert_array_equal(student.head.last_layer.weight_g.detach().numpy(), g0)
    np.testing.assert_array_equal(np.asarray(jax_head["last_layer_g"]).reshape(g0.shape), g0)
    # weight_v trains, and its movement tracks JAX's as every tensor's does above
    moved_want = np.asarray(jax_head["last_layer_v"]).T - v0
    moved_got = student.head.last_layer.weight_v.detach().numpy() - v0
    assert np.abs(moved_got).max() > 1e-5
    assert np.linalg.norm(moved_got - moved_want) <= \
        MOVE_RTOL["gt_masks"] * np.linalg.norm(moved_want)
