"""The port's DINOHead, SegHead and CCDPretrainModel stages against the JAX
package's, from the same converted weights and numpy inputs, fp32, CPU.

Tolerances: 1e-5 for the DINOHead logits (unit-norm features against
unit-norm columns) and the updated running statistics; 1e-4 for the SegHead
logits, whose five BatchNorms divide by batch standard deviations; 2e-4 for
gradients, which pass through all of them backwards.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.models.heads import DINOHead as JaxDINOHead, SegHead as JaxSegHead
from ccd_tpu.models.pretrain import (CCDPretrainModel as JaxPretrainModel,
                                     char_validity_mask as jax_char_validity_mask)
from ccd_tpu_torch.checkpoints.from_jax import (dino_head_state_dict_from_jax,
                                                pretrain_state_dicts_from_jax,
                                                seg_head_state_dict_from_jax)
from ccd_tpu_torch.models.heads import DINOHead, SegHead
from ccd_tpu_torch.models.layers import BatchNorm
from ccd_tpu_torch.models.pretrain import CCDPretrainModel, char_validity_mask

from _torch_port import perturbed_numpy_tree, to_jnp


# ------------------------------------------------------------------ DINOHead

@pytest.fixture(scope="module", params=[False, True], ids=["g_trained", "g_frozen"])
def dino_pair(request):
    norm_last_layer = request.param
    jhead = JaxDINOHead(out_dim=96, norm_last_layer=norm_last_layer, hidden_dim=48,
                        bottleneck_dim=24)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    x[0, 0] = 0.0  # an empty character slot pools to a zero vector
    tree = perturbed_numpy_tree(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    thead = DINOHead(32, 96, norm_last_layer=norm_last_layer, hidden_dim=48, bottleneck_dim=24)
    thead.load_state_dict(dino_head_state_dict_from_jax(tree), strict=True)
    return jhead, tree, thead, x


def test_dino_head_logits_match_jax(dino_pair):
    jhead, tree, thead, x = dino_pair
    ref = np.asarray(jhead.apply({"params": to_jnp(tree)}, jnp.asarray(x)))
    out = thead(torch.from_numpy(x))
    assert out.shape == (3, 5, 96)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)


def test_dino_head_gradients_match_jax(dino_pair):
    """Finite everywhere (the clamp inside the sqrt keeps the zero slot's
    cotangent finite), equal to JAX's, and none for a frozen gain."""
    jhead, tree, thead, x = dino_pair
    w = np.random.default_rng(2).normal(size=(3, 5, 96)).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jhead.apply({"params": p}, jnp.asarray(x)) * w))(
        to_jnp(tree))
    thead.zero_grad()
    (thead(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    ref = dino_head_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in thead.named_parameters():
        if name == "last_layer.weight_g" and thead.norm_last_layer:
            assert p.grad is None and float(ref[name].abs().max()) == 0.0
            continue
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=2e-4, err_msg=name)


def test_dino_head_bf16_rounds_where_jax_does():
    jhead = JaxDINOHead(out_dim=64, norm_last_layer=False, hidden_dim=32, bottleneck_dim=16,
                        dtype=jnp.bfloat16)
    x = np.random.default_rng(3).normal(size=(4, 24)).astype(np.float32)
    tree = perturbed_numpy_tree(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    ref = jhead.apply({"params": to_jnp(tree)}, jnp.asarray(x))
    thead = DINOHead(24, 64, norm_last_layer=False, hidden_dim=32, bottleneck_dim=16,
                     dtype=torch.bfloat16)
    thead.load_state_dict(dino_head_state_dict_from_jax(tree), strict=True)
    out = thead(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # logits are cosines scaled by g ~ 1: a few bf16 ulps (2^-8 each) below 1
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2e-2)


# ------------------------------------------------------------------ BatchNorm / SegHead

def test_batchnorm_updates_running_stats_as_flax():
    """Biased batch variance into the running variance, momentum 0.9."""
    from flax import linen as nn
    x = np.random.default_rng(5).normal(1.0, 2.0, size=(4, 6, 5, 3)).astype(np.float32)  # NHWC
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, new = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(3).train()
    out = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]), atol=1e-6)
    # torch's own BatchNorm2d keeps the UNBIASED variance: not what Flax stores
    lib = torch.nn.BatchNorm2d(3, momentum=0.1).train()
    lib(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert float((lib.running_var - bn.running_var).abs().max()) > 1e-4
    ref_eval = jbn.clone(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": new["batch_stats"]}, jnp.asarray(x))
    out_eval = bn.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out_eval.detach().numpy(), np.asarray(ref_eval), atol=1e-5)


@pytest.fixture(scope="module")
def seg_pair():
    jseg = JaxSegHead()
    rng = np.random.default_rng(6)
    taps = [rng.normal(size=(4, 8, 32, 64)).astype(np.float32) for _ in range(3)]
    variables = jseg.init(jax.random.PRNGKey(0), [jnp.asarray(t) for t in taps])
    params = perturbed_numpy_tree(variables["params"], 7)
    stats = perturbed_numpy_tree(variables["batch_stats"], 8)
    tseg = SegHead(64)
    tseg.load_state_dict(seg_head_state_dict_from_jax(params, stats), strict=True)
    return jseg, params, stats, tseg, taps


def test_seg_head_eval_matches_jax(seg_pair):
    jseg, params, stats, tseg, taps = seg_pair
    ref = jseg.apply({"params": to_jnp(params), "batch_stats": to_jnp(stats)},
                     [jnp.asarray(t) for t in taps], train=False)
    with torch.no_grad():
        out = tseg.eval()([torch.from_numpy(t) for t in taps])
    assert out.shape == (4, 32, 128, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_seg_head_train_output_and_running_stats_match_jax(seg_pair):
    jseg, params, stats, tseg, taps = seg_pair
    ref, new = jseg.apply({"params": to_jnp(params), "batch_stats": to_jnp(stats)},
                          [jnp.asarray(t) for t in taps], train=True, mutable=["batch_stats"])
    tseg.load_state_dict(seg_head_state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = tseg.train()([torch.from_numpy(t) for t in taps])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    want = seg_head_state_dict_from_jax(
        params, jax.tree_util.tree_map(np.asarray, new["batch_stats"]))
    got = tseg.state_dict()
    moved = 0
    for name in want:
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-5,
                                       err_msg=name)
            moved += 1
    assert moved == 16  # mean and var of the eight BatchNorms


def test_seg_head_gradients_match_jax(seg_pair):
    """On a small grid: a ReLU whose input is within fp32 noise of zero may
    open on one side and not the other, and every such element moves a
    parameter's gradient by one whole term; 2 x 8 x 16 outputs make that
    unlikely where 4 x 32 x 128 make it certain."""
    jseg, params, stats, tseg, _ = seg_pair
    rng = np.random.default_rng(9)
    taps = [rng.normal(size=(2, 2, 4, 64)).astype(np.float32) for _ in range(3)]
    w = rng.normal(size=(2, 8, 16, 2)).astype(np.float32)

    def loss(p):
        out, _ = jseg.apply({"params": p, "batch_stats": to_jnp(stats)},
                            [jnp.asarray(t) for t in taps], train=True,
                            mutable=["batch_stats"])
        return jnp.mean(out * w)

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(to_jnp(params)))
    ref = seg_head_state_dict_from_jax(grads, stats)
    tseg.load_state_dict(seg_head_state_dict_from_jax(params, stats), strict=True)
    tseg.train().zero_grad()
    (tseg([torch.from_numpy(t) for t in taps]) * torch.from_numpy(w)).mean().backward()
    checked = 0
    for name, p in tseg.named_parameters():
        scale = float(ref[name].abs().max())
        if scale < 1e-7:  # a bias in front of a BatchNorm: its true gradient is zero
            assert name in ("unpool1.0.bias", "unpool2.0.bias")
            assert float(p.grad.abs().max()) < 1e-7
            continue
        np.testing.assert_allclose(p.grad.numpy() / scale, ref[name].numpy() / scale,
                                   atol=2e-4, err_msg=name)
        checked += 1
    assert checked == 26


# ------------------------------------------------------------------ CCDPretrainModel

def test_char_validity_mask_keeps_length_plus_one():
    index = np.zeros((4, 26), bool)
    index[0, :5] = True          # 5 glyphs -> slots 0..5
    index[1, :1] = True          # 1 glyph -> clamped to 3 -> slots 0..3
    index[2, :] = True           # 26 -> all
    ref = np.asarray(jax_char_validity_mask(jnp.asarray(index), 26))
    out = char_validity_mask(torch.from_numpy(index), 26).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.sum(1).tolist() == [6, 4, 26, 4]


@pytest.fixture(scope="module")
def model_pair():
    jmodel = JaxPretrainModel(arch="vit_micro", out_dim=128, norm_last_layer=False)
    rng = np.random.default_rng(10)
    images = rng.normal(size=(2, 32, 128, 3)).astype(np.float32)
    clusters = np.zeros((2, 26, 32, 128), np.float32)
    clusters[:, 0, 8:24, 10:26] = 1.0
    clusters[:, 1, 8:24, 50:66] = 1.0
    clusters[0, 2, 8:24, 90:106] = 1.0
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(clusters))
    params = perturbed_numpy_tree(variables["params"], 11)
    stats = perturbed_numpy_tree(variables["batch_stats"], 12)
    tmodel = CCDPretrainModel(arch="vit_micro", out_dim=128, norm_last_layer=False)
    student_sd, teacher_sd = pretrain_state_dicts_from_jax(
        params, stats, {"backbone": params["backbone"], "head": params["head"]})
    tmodel.load_state_dict(student_sd, strict=True)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=128, with_seg_head=False)
    teacher.load_state_dict(teacher_sd, strict=True)
    jvars = {"params": to_jnp(params), "batch_stats": to_jnp(stats)}
    ref = jmodel.apply(jvars, jnp.asarray(images), jnp.asarray(clusters))
    with torch.no_grad():
        out = tmodel.eval()(torch.from_numpy(images), torch.from_numpy(clusters))
    return jmodel, jvars, tmodel, images, clusters, ref, out


@pytest.mark.parametrize("key,atol", [("instances_view", 1e-4), ("mask", 2e-4),
                                      ("feature", 1e-4)])
def test_pretrain_model_outputs_match_jax(model_pair, key, atol):
    *_, ref, out = model_pair
    np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=atol)
    np.testing.assert_array_equal(out["index"].numpy(), np.asarray(ref["index"]))


def test_pool_project_flat_collapses_rows_on_the_head_input(model_pair):
    jmodel, jvars, tmodel, images, clusters, *_ = model_pair
    with torch.no_grad():
        region_f, _ = tmodel.encode(torch.from_numpy(images))
        flat, index = tmodel.pool_project(region_f, torch.from_numpy(clusters), flat=True)
        nested, _ = tmodel.pool_project(region_f, torch.from_numpy(clusters))
    assert flat.shape == (2 * 26, 128) and nested.shape == (2, 26, 128)
    np.testing.assert_array_equal(flat.numpy(), nested.reshape(-1, 128).numpy())
    j_region, _ = jmodel.apply(jvars, jnp.asarray(images), method="encode")
    ref, _ = jmodel.apply(jvars, j_region, jnp.asarray(clusters), method="pool_project",
                          flat=True)
    np.testing.assert_allclose(flat.numpy(), np.asarray(ref), atol=1e-4)
