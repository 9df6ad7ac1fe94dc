"""The pretraining options the port used to refuse or ignore, against the JAX
package on the CPU (fp32, vit_micro, plain CE chain on both sides, drop
path off where the two frameworks are compared: randomness does not cross):

  * ``optimizer: sgd`` and ``optimizer: lars``: three steps of the port's
    ``make_pretrain_step`` against JAX's ``make_pretrain_step`` with
    ``make_optimizer(name)``, the last layer frozen for the first two;
  * ``remat: True`` on the student: the same three steps against JAX's
    ``nn.remat(Block)`` student; and within the port, with drop path 0.1,
    remat against no remat: the same losses and gradients bit for bit and
    the generator left in the same state;
  * a payload of a sgd/lars state restored into a fresh state continues
    exactly as the uninterrupted run.

Tolerances as in tests/test_torch_pretrain_step.py: losses 2e-4 relative;
each parameter tensor's movement over the steps within a tenth of JAX's in
L2 (the entries whose true gradient is zero left out by name), a checksum
over all parameters to 1e-4. sgd and lars run at learning rates of their own
kind (0.03, 0.3: DINO's sgd/lars runs use lr 0.03-0.3 x batch/256): at AdamW's
5e-4 lars would move each tensor by 5e-7 of its norm, under the fp32 rounding
of the parameters themselves.
"""

import copy

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
from ccd_tpu_torch.losses import teacher_temp_schedule
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state, make_pretrain_step,
                                                  pretrain_state_payload,
                                                  restore_pretrain_state)

from _torch_port import one_torch_thread, perturbed_numpy_tree, to_jnp  # noqa: F401 (fixture)

N_STEPS, BATCH, OUT_DIM = 3, 4, 256
SCHEDULE = dict(min_lr=1e-6, total_iters=100, warmup_iters=3, weight_decay=0.04,
                weight_decay_end=0.4, momentum_teacher=0.99, clip_grad=3.0,
                freeze_last_layer=1, global_batch=BATCH,
                imgnet_based=2 * BATCH)  # epochs 0, 1, 1: frozen, then unfrozen
CASES = {"sgd": dict(optimizer="sgd", remat=False, base_lr=0.03),
         "lars": dict(optimizer="lars", remat=False, base_lr=0.3),
         "remat": dict(optimizer="adamw", remat=True, base_lr=5e-4)}
LOSS_RTOL, CHECKSUM_RTOL, MOVE_RTOL = 2e-4, 1e-4, 0.1


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
    """Entries of parameter ``name`` whose true gradient is zero (the key
    bias of every attention, the two biases in front of a BatchNorm)."""
    skip = np.zeros(value.shape, bool)
    if name.endswith("attn.qkv.bias"):
        c = value.shape[0] // 3
        skip[c:2 * c] = True
    elif name in ("segmentation.unpool1.0.bias", "segmentation.unpool2.0.bias"):
        skip[:] = True
    return skip


def _port_models(remat, drop_path_rate=0.0):
    student = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                               norm_last_layer=False, drop_path_rate=drop_path_rate,
                               remat=remat)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    return student, teacher


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    case = CASES[request.param]
    schedule = dict(SCHEDULE, base_lr=case["base_lr"])
    images, masks, theta = _batch(0)
    jstudent = JaxPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                                norm_last_layer=False, drop_path_rate=0.0,
                                remat=case["remat"])
    jteacher = JaxPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    variables = jstudent.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                              jnp.zeros((2, 26, 32, 128)))
    params = perturbed_numpy_tree(variables["params"], 1)
    stats = perturbed_numpy_tree(variables["batch_stats"], 2)
    t_params = perturbed_numpy_tree({"backbone": params["backbone"], "head": params["head"]},
                                    3, amount=0.01)
    temps = (jax_teacher_temp_schedule(0.04, 0.07, 3, 10),
             teacher_temp_schedule(0.04, 0.07, 3, 10))

    tx = make_optimizer(case["optimizer"], to_jnp(params), norm_last_layer=False)
    jstate = JaxPretrainState(
        student_params=to_jnp(params), student_stats=to_jnp(stats),
        teacher_params=to_jnp(t_params), opt_state=tx.init(to_jnp(params)),
        center=jnp.zeros((1, OUT_DIM)), iteration=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(5))
    jstep = jax.jit(jax_make_pretrain_step(jstudent, jteacher, tx, teacher_temps=temps[0],
                                           gt_mask_epochs=30, use_fused_ce=False, **schedule))
    jmetrics = []
    for _ in range(N_STEPS):
        jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(theta))
        jmetrics.append({k: float(v) for k, v in m.items()})
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    ref_student, _ = pretrain_state_dicts_from_jax(
        as_np(jstate.student_params), as_np(jstate.student_stats), as_np(jstate.teacher_params))

    student, teacher = _port_models(case["remat"])
    state = init_pretrain_state(student, teacher, optimizer=case["optimizer"])
    s_sd, t_sd = pretrain_state_dicts_from_jax(params, stats, t_params)
    student.load_state_dict(s_sd, strict=True)
    teacher.load_state_dict(t_sd, strict=True)
    step = make_pretrain_step(teacher_temps=temps[1], gt_mask_epochs=30, use_fused_ce=False,
                              **schedule)
    metrics = []
    for _ in range(N_STEPS):
        state, m = step(state, torch.from_numpy(images), torch.from_numpy(masks),
                        torch.from_numpy(theta))
        metrics.append({k: float(v) for k, v in m.items()})
    got = {k: v.numpy() for k, v in student.state_dict().items()}
    start = {k: v.numpy() for k, v in s_sd.items()}
    return dict(jax=jmetrics, port=metrics, ref={k: v.numpy() for k, v in ref_student.items()},
                got=got, start=start, state=state, case=request.param)


@pytest.mark.parametrize("key", ["loss", "mask_loss", "dino_loss"])
def test_losses_track_jax(runs, key):
    got = [m[key] for m in runs["port"]]
    assert np.isfinite(got).all() and len(got) == N_STEPS
    np.testing.assert_allclose(got, [m[key] for m in runs["jax"]], rtol=LOSS_RTOL)


def test_parameters_track_jax(runs):
    ref, got, start = runs["ref"], runs["got"], runs["start"]
    checksum_got = checksum_want = 0.0
    moved_any = 0
    for name, want in ref.items():
        if "running_" in name:
            continue
        keep = ~_noise_driven(name, want)
        if not keep.any():
            continue
        moved_want = (want - start[name])[keep]
        moved_got = (got[name] - start[name])[keep]
        if np.linalg.norm(moved_want) == 0:  # a parameter the loss does not reach yet
            np.testing.assert_array_equal(moved_got, 0.0, err_msg=name)
            continue
        moved_any += 1
        assert np.linalg.norm(moved_got - moved_want) <= \
            MOVE_RTOL * np.linalg.norm(moved_want), name
        checksum_got += float(np.abs(got[name][keep]).sum())
        checksum_want += float(np.abs(want[keep]).sum())
    assert moved_any > 40
    np.testing.assert_allclose(checksum_got, checksum_want, rtol=CHECKSUM_RTOL)
    # frozen for two steps, then unfrozen: the last layer moved on the third
    v = "head.last_layer.weight_v"
    assert np.abs(got[v] - start[v]).max() > 0


def test_the_optimizer_and_remat_are_the_ones_asked_for(runs):
    state, case = runs["state"], CASES[runs["case"]]
    assert state.opt_state.name == case["optimizer"]
    assert state.student.backbone.remat is case["remat"]
    assert state.teacher.backbone.remat is False
    payload = pretrain_state_payload(state)["opt_state"]
    if case["optimizer"] == "adamw":
        assert set(payload) == {"mu", "nu", "count"} and payload["count"] == N_STEPS
    else:
        assert payload["optimizer"] == case["optimizer"]
        assert max(float(t.abs().max()) for t in payload["trace"]) > 0


def _step_fn():
    return make_pretrain_step(teacher_temps=teacher_temp_schedule(0.04, 0.07, 3, 10),
                              gt_mask_epochs=30, base_lr=5e-4, **SCHEDULE)


def test_remat_gives_the_same_losses_gradients_and_draws_as_without():
    """drop path 0.1 and dropout drawn from the state's generator: with
    ``remat`` the recompute replays the first pass's draws, so the two
    steps agree bit for bit and leave the generator where it would be."""
    images, masks, theta = (torch.from_numpy(a) for a in _batch(1))
    out = {}
    for remat in (False, True):
        student, teacher = _port_models(remat, drop_path_rate=0.1)
        g = torch.Generator().manual_seed(7)
        student.reset_parameters(g)
        teacher.reset_parameters(g)
        state = init_pretrain_state(student, teacher, seed=3)
        step, grads = _step_fn(), []
        real_grad = torch.autograd.grad

        def spy(loss, params, **kw):
            found = real_grad(loss, params, **kw)
            grads.append([None if x is None else x.clone() for x in found])
            return found

        torch.autograd.grad = spy
        try:
            losses = [float(step(state, images, masks, theta)[1]["loss"]) for _ in range(2)]
        finally:
            torch.autograd.grad = real_grad
        out[remat] = (losses, grads, state.generator.get_state(), student.state_dict())
    (l0, g0, s0, p0), (l1, g1, s1, p1) = out[False], out[True]
    assert l0 == l1
    for a_step, b_step in zip(g0, g1):
        for a, b in zip(a_step, b_step):
            assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(s0, s1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    # the draws did happen: without drop path the loss is another one
    student, teacher = _port_models(True, drop_path_rate=0.0)
    g = torch.Generator().manual_seed(7)
    student.reset_parameters(g)
    teacher.reset_parameters(g)
    state = init_pretrain_state(student, teacher, seed=3)
    assert float(_step_fn()(state, images, masks, theta)[1]["loss"]) != l1[0]


@pytest.mark.parametrize("name", ["sgd", "lars"])
def test_a_restored_sgd_or_lars_state_continues_exactly(name):
    """Two steps, a payload, a fresh state restored from it (generators set
    to the first run's), one more step on each: the same loss and
    parameters bit for bit, the momentum carried over."""
    images, masks, theta = (torch.from_numpy(a) for a in _batch(2))
    schedule = dict(SCHEDULE, base_lr=CASES[name]["base_lr"])
    step = make_pretrain_step(teacher_temps=teacher_temp_schedule(0.04, 0.07, 3, 10),
                              gt_mask_epochs=30, **schedule)

    def fresh():
        student, teacher = _port_models(False, drop_path_rate=0.1)
        g = torch.Generator().manual_seed(11)
        student.reset_parameters(g)
        teacher.reset_parameters(g)
        return init_pretrain_state(student, teacher, seed=5, optimizer=name)

    state = fresh()
    for _ in range(2):
        state, _ = step(state, images, masks, theta)
    payload = copy.deepcopy(pretrain_state_payload(state))
    resumed = restore_pretrain_state(fresh(), payload)
    resumed.generator.set_state(state.generator.get_state())
    resumed.aug_generator.set_state(state.aug_generator.get_state())
    assert resumed.iteration == 2
    assert all(torch.equal(a, b) for a, b in zip(resumed.opt_state.trace, state.opt_state.trace))
    _, m_a = step(state, images, masks, theta)
    _, m_b = step(resumed, images, masks, theta)
    assert float(m_a["loss"]) == float(m_b["loss"])
    sd_a, sd_b = state.student.state_dict(), resumed.student.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    with pytest.raises(ValueError, match="holds sgd state|holds lars state"):
        restore_pretrain_state(init_pretrain_state(*_port_models(False)), payload)
