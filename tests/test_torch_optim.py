"""The port's AdamW, clipping, last-layer freeze and EMA against the JAX
package's (optax), same numpy parameters and gradients, fp32, CPU.

Tolerance 1e-6 absolute on O(1) parameters over several steps: the two sides
evaluate the same fp32 formula with the bias corrections folded in at
different places.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ccd_tpu.training import optim as jopt
from ccd_tpu_torch.training import optim as topt

# torch names and the Flax tree they stand for
SHAPES = {
    "backbone.blocks.0.attn.qkv.weight": (12, 4),
    "backbone.blocks.0.attn.qkv.bias": (12,),
    "backbone.norm.weight": (4,),
    "backbone.pos_embed": (1, 8, 4),
    "segmentation.cls.weight": (2, 4, 3, 3),
    "head.mlp.0.weight": (6, 4),
    "head.last_layer.weight_g": (5, 1),
    "head.last_layer.weight_v": (5, 6),
}


def _jax_tree(flat):
    """The same values under the JAX package's names (layouts do not matter
    to an elementwise optimizer; the name rules do)."""
    return {
        "backbone": {"blocks_0": {"attn": {"qkv": {
            "kernel": flat["backbone.blocks.0.attn.qkv.weight"],
            "bias": flat["backbone.blocks.0.attn.qkv.bias"]}}},
            "norm": {"scale": flat["backbone.norm.weight"]},
            "pos_embed": flat["backbone.pos_embed"]},
        "segmentation": {"cls": {"kernel": flat["segmentation.cls.weight"]}},
        "head": {"mlp_0": {"kernel": flat["head.mlp.0.weight"]},
                 "last_layer_g": flat["head.last_layer.weight_g"],
                 "last_layer_v": flat["head.last_layer.weight_v"]},
    }


def _flat_from_jax(tree):
    return {name: np.asarray(leaf) for name, leaf in zip(
        SHAPES, [tree["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"],
                 tree["backbone"]["blocks_0"]["attn"]["qkv"]["bias"],
                 tree["backbone"]["norm"]["scale"], tree["backbone"]["pos_embed"],
                 tree["segmentation"]["cls"]["kernel"], tree["head"]["mlp_0"]["kernel"],
                 tree["head"]["last_layer_g"], tree["head"]["last_layer_v"]])}


def _values(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.normal(size=s)).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("norm_last_layer", [True, False])
def test_weight_decay_mask_matches_jax(norm_last_layer):
    flat = _values(0)
    ref = _flat_from_jax(jopt.weight_decay_mask(
        jax.tree_util.tree_map(jnp.asarray, _jax_tree(flat)), norm_last_layer))
    out = topt.weight_decay_mask({n: torch.from_numpy(v) for n, v in flat.items()},
                                 norm_last_layer)
    assert out == {n: bool(v) for n, v in ref.items()}
    assert out["head.last_layer.weight_g"] is (not norm_last_layer)
    assert not out["backbone.norm.weight"] and out["backbone.pos_embed"]


@pytest.mark.parametrize("clip", [3.0, 0.5, None])
def test_clip_gradients_per_param_matches_jax(clip):
    grads = _values(1, scale=0.4)
    ref = _flat_from_jax(jopt.clip_gradients_per_param(
        jax.tree_util.tree_map(jnp.asarray, _jax_tree(grads)), clip))
    out = topt.clip_gradients_per_param([torch.from_numpy(g.copy()) for g in grads.values()],
                                        clip)
    clipped = 0
    for name, g in zip(SHAPES, out):
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-6, atol=1e-8, err_msg=name)
        clipped += int(not np.array_equal(g.numpy(), grads[name]))
    over = sum(clip / (np.linalg.norm(g) + 1e-6) < 1.0 for g in grads.values()) if clip else 0
    assert clipped == over and over == {3.0: 1, 0.5: 8, None: 0}[clip]


def test_ema_update_matches_jax():
    teacher, student = _values(2), _values(3)
    ref = _flat_from_jax(jopt.ema_update(
        jax.tree_util.tree_map(jnp.asarray, _jax_tree(teacher)),
        jax.tree_util.tree_map(jnp.asarray, _jax_tree(student)), jnp.float32(0.9995)))
    t = [torch.from_numpy(v.copy()) for v in teacher.values()]
    topt.ema_update(t, [torch.from_numpy(v) for v in student.values()], 0.9995)
    for name, v in zip(SHAPES, t):
        np.testing.assert_allclose(v.numpy(), ref[name], atol=1e-6, err_msg=name)


def _run_both(norm_last_layer, n_steps, frozen_steps, clip=3.0):
    """The optimizer part of the pretraining step on both sides: clip, cancel
    the last layer's gradients while frozen, AdamW with this step's lr and wd,
    cancel the last layer's update while frozen, apply."""
    p0 = _values(10)
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_tree(p0))
    tx = jopt.make_adamw(jparams, norm_last_layer=norm_last_layer)
    jstate = tx.init(jparams)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    tstate = topt.adamw_init(tparams)
    names = list(tparams)
    decay = topt.weight_decay_mask(tparams, norm_last_layer)
    history = []
    for i in range(n_steps):
        lr, wd = 1e-2 * (1 + i), 0.04 + 0.05 * i
        freeze = i < frozen_steps
        grads = _values(20 + i, scale=0.7)
        if norm_last_layer:
            grads["head.last_layer.weight_g"][:] = 0.0  # stop_gradient on the gain

        jg = jopt.clip_gradients_per_param(
            jax.tree_util.tree_map(jnp.asarray, _jax_tree(grads)), clip)
        jg = jopt.cancel_last_layer_grads(jg, jnp.asarray(freeze))
        jstate.hyperparams["learning_rate"] = jnp.float32(lr)
        jstate.hyperparams["weight_decay"] = jnp.float32(wd)
        updates, jstate = tx.update(jg, jstate, jparams)
        updates = jopt.cancel_last_layer_grads(updates, jnp.asarray(freeze))
        jparams = optax.apply_updates(jparams, updates)

        tg = topt.clip_gradients_per_param([torch.from_numpy(g) for g in grads.values()], clip)
        tg = topt.cancel_last_layer_grads(names, tg, freeze)
        tu = topt.adamw_updates(tg, tstate, list(tparams.values()),
                                [decay[n] for n in names], lr, wd)
        tu = topt.cancel_last_layer_grads(names, tu, freeze)
        torch._foreach_add_(list(tparams.values()), tu)
        history.append((_flat_from_jax(jparams), {n: v.numpy().copy()
                                                  for n, v in tparams.items()}))
    return p0, history, tstate


@pytest.mark.parametrize("norm_last_layer", [True, False])
def test_adamw_tracks_optax_with_changing_lr_and_wd(norm_last_layer):
    p0, history, tstate = _run_both(norm_last_layer, n_steps=6, frozen_steps=0)
    for step, (ref, out) in enumerate(history):
        for name in SHAPES:
            np.testing.assert_allclose(out[name], ref[name], atol=1e-6,
                                       err_msg=f"step {step} {name}")
    assert tstate.count == 6
    ref, out = history[-1]
    g = "head.last_layer.weight_g"
    if norm_last_layer:  # zero gradient and no decay: the frozen gain stays where it was
        np.testing.assert_array_equal(out[g], p0[g])
    else:
        assert np.abs(out[g] - p0[g]).max() > 1e-3


def test_freeze_then_unfreeze_tracks_optax():
    """While frozen the last layer does not move (no decay either) but its
    moments and the count run on zero gradients; from the second step after
    unfreezing a torch.optim.AdamW that skipped the parameter would differ."""
    p0, history, _ = _run_both(False, n_steps=6, frozen_steps=3)
    last = [n for n in SHAPES if "last_layer" in n]
    for step, (ref, out) in enumerate(history):
        for name in SHAPES:
            np.testing.assert_allclose(out[name], ref[name], atol=1e-6,
                                       err_msg=f"step {step} {name}")
        for name in last:
            if step < 3:
                np.testing.assert_array_equal(out[name], p0[name])
            else:
                assert np.abs(out[name] - p0[name]).max() > 0
    # what skipping would give: moments and count start at the unfreezing
    v = "head.last_layer.weight_v"
    p = torch.nn.Parameter(torch.from_numpy(p0[v].copy()))
    for i in range(3, 6):
        opt = torch.optim.AdamW([p], lr=1e-2 * (1 + i), weight_decay=0.04 + 0.05 * i) \
            if i == 3 else opt
        for group in opt.param_groups:
            group["lr"], group["weight_decay"] = 1e-2 * (1 + i), 0.04 + 0.05 * i
        g = _values(20 + i, scale=0.7)[v]
        norm = np.linalg.norm(g)
        p.grad = torch.from_numpy(g * min(1.0, 3.0 / (norm + 1e-6)))
        opt.step()
    assert np.abs(p.detach().numpy() - history[-1][1][v]).max() > 1e-4


# sgd and lars: five steps with the learning rate and weight decay of each
# step as the pretraining schedule hands them over (the first at wd 0)
MOMENTUM_LRS = (0.0, 1e-2, 3e-2, 2e-2, 1e-2)
MOMENTUM_WDS = (0.0, 0.04, 0.1, 0.2, 0.4)
# lars's trust ratio is 1 where a norm is 0: a parameter that is all zeros
# (the decayed pos_embed; its gradient is 0 too at every step, so its update
# norm is 0 as well) and one whose gradient is 0 at the first step, at wd 0
ZERO_PARAM, ZERO_GRAD_AT_FIRST = "backbone.pos_embed", "segmentation.cls.weight"


def _run_momentum(name, norm_last_layer, frozen_steps):
    """The optimizer part of the pretraining step with ``make_optimizer(name)``
    on both sides, in ``make_pretrain_step``'s order: clip, zero the last
    layer's gradients while frozen, the optimizer, zero its update while
    frozen, apply."""
    p0 = _values(30)
    p0[ZERO_PARAM][:] = 0.0
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_tree(p0))
    tx = jopt.make_optimizer(name, jparams, norm_last_layer=norm_last_layer)
    jstate = tx.init(jparams)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    tstate = topt.optimizer_init(name, tparams)
    names = list(tparams)
    decay = topt.weight_decay_mask(tparams, norm_last_layer)
    history = []
    for i, (lr, wd) in enumerate(zip(MOMENTUM_LRS, MOMENTUM_WDS)):
        freeze = i < frozen_steps
        grads = _values(40 + i, scale=0.7)
        grads[ZERO_PARAM][:] = 0.0
        if i == 0:
            grads[ZERO_GRAD_AT_FIRST][:] = 0.0
        if norm_last_layer:
            grads["head.last_layer.weight_g"][:] = 0.0  # stop_gradient on the gain

        jg = jopt.clip_gradients_per_param(
            jax.tree_util.tree_map(jnp.asarray, _jax_tree(grads)), 3.0)
        jg = jopt.cancel_last_layer_grads(jg, jnp.asarray(freeze))
        jstate.hyperparams["learning_rate"] = jnp.float32(lr)
        jstate.hyperparams["weight_decay"] = jnp.float32(wd)
        updates, jstate = tx.update(jg, jstate, jparams)
        updates = jopt.cancel_last_layer_grads(updates, jnp.asarray(freeze))
        jparams = optax.apply_updates(jparams, updates)

        tg = topt.clip_gradients_per_param([torch.from_numpy(g) for g in grads.values()], 3.0)
        tg = topt.cancel_last_layer_grads(names, tg, freeze)
        tu = topt.optimizer_updates(tg, tstate, list(tparams.values()),
                                    [decay[n] for n in names], lr, wd)
        tu = topt.cancel_last_layer_grads(names, tu, freeze)
        torch._foreach_add_(list(tparams.values()), tu)
        history.append((_flat_from_jax(jparams), {n: v.numpy().copy()
                                                  for n, v in tparams.items()}))
    return p0, history, tstate


@pytest.mark.parametrize("norm_last_layer", [True, False])
@pytest.mark.parametrize("name", ["sgd", "lars"])
def test_sgd_and_lars_track_optax_through_a_freeze(name, norm_last_layer):
    """Five steps of ``make_optimizer("sgd")`` / ``("lars")`` (optax 0.2.6)
    with scheduled lr and wd, the last layer frozen for the first two: every
    parameter within rtol 1e-6 (atol 1e-9 for the entries that stay at 0).
    While frozen the last layer stays put, but its momentum gathers the
    weight-decay term (and, for lars, its trust-scaled form), so it moves at
    the first unfrozen step by more than that step's own gradient would."""
    p0, history, tstate = _run_momentum(name, norm_last_layer, frozen_steps=2)
    for step, (ref, out) in enumerate(history):
        for n in SHAPES:
            np.testing.assert_allclose(out[n], ref[n], rtol=1e-6, atol=1e-9,
                                       err_msg=f"{name} step {step} {n}")
    v = "head.last_layer.weight_v"
    for step in (0, 1):
        np.testing.assert_array_equal(history[step][1][v], p0[v])
    assert np.abs(history[2][1][v] - p0[v]).max() > 0
    assert tstate.name == name and len(tstate.trace) == len(SHAPES)
    trace = dict(zip(SHAPES, tstate.trace))
    np.testing.assert_array_equal(history[-1][1][ZERO_PARAM], 0.0)  # trust ratio 1, update 0
    assert float(trace[ZERO_PARAM].abs().max()) == 0.0
    g = "head.last_layer.weight_g"
    if norm_last_layer:  # no gradient and no decay: the frozen gain never moves
        np.testing.assert_array_equal(history[-1][1][g], p0[g])


def test_sgd_and_lars_take_the_momentum_on_either_side_of_the_learning_rate():
    """One step at lr 0 and wd 0.1, then one at lr 0.1 and wd 0 with a zero
    gradient: sgd's momentum gathered ``wd * p`` at lr 0 (the momentum is
    taken before the learning rate) and moves the parameters at the second
    step; lars's gathered ``-0 * ...`` and nothing moves."""
    p = {"w": torch.full((2, 3), 2.0)}
    for name, moves in (("sgd", True), ("lars", False)):
        state = topt.optimizer_init(name, p)
        params = [p["w"].clone()]
        for lr, wd in ((0.0, 0.1), (0.1, 0.0)):
            u = topt.optimizer_updates([torch.zeros(2, 3)], state, params, [True], lr, wd)
            torch._foreach_add_(params, u)
        moved = float((params[0] - 2.0).abs().max())
        if moves:
            np.testing.assert_allclose(moved, 0.1 * 0.9 * 0.1 * 2.0, rtol=1e-6)
        else:
            assert moved == 0.0


def test_an_unknown_optimizer_name_raises_as_make_optimizer_does():
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        topt.optimizer_init("adagrad", {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        jopt.make_optimizer("adagrad", {"w": jnp.zeros(2)})
