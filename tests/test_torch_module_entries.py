"""The last module entries of the port against the JAX package's, from the
same converted weights and numpy inputs, fp32, CPU:

  * the attention's second branch: ``Block(return_attention=True)`` (through
    ``Attention(need_weights=True)``) and
    ``VisionTransformer.get_last_selfattention`` — 1e-5 on the (B, H, N, N)
    probabilities and the block's output (the JAX package takes the same
    non-Pallas branch on every backend when the weights are asked for);
  * ``DINOHead(use_bn=True)`` in training mode (batch statistics, running
    statistics updated: JAX with ``mutable=["batch_stats"]``) and in
    evaluation mode — 1e-5 on the logits and the running statistics, the
    weights and statistics carried by ``from_jax``;
  * ``sinkhorn_knopp_teacher`` at (64, 256) — 1e-6 relative;
  * the reference-layout export refuses a head with BatchNorm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.losses.losses import sinkhorn_knopp_teacher as jax_sinkhorn
from ccd_tpu.models.heads import DINOHead as JaxDINOHead
from ccd_tpu.models.vit import Block as JaxBlock, vit_micro as jax_vit_micro
from ccd_tpu_torch.checkpoints.from_jax import (dino_head_state_dict_from_jax,
                                                vit_state_dict_from_jax)
from ccd_tpu_torch.checkpoints.torch_export import pretrain_reference_state_dicts
from ccd_tpu_torch.losses import sinkhorn_knopp_teacher
from ccd_tpu_torch.models.heads import DINOHead
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.models.vit import vit_micro

from _torch_port import one_torch_thread, perturbed_numpy_tree, to_jnp  # noqa: F401 (fixture)

ATOL = 1e-5


@pytest.fixture(scope="module")
def vit_pair():
    jvit = jax_vit_micro()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 128, 3)).astype(np.float32)
    params = perturbed_numpy_tree(jvit.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    vit = vit_micro()
    vit.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    return jvit, params, vit.eval(), x


def test_get_last_selfattention_matches_jax(vit_pair):
    jvit, params, vit, x = vit_pair
    want = np.asarray(jvit.apply({"params": to_jnp(params)}, jnp.asarray(x),
                                 method="get_last_selfattention"))
    vit.train()  # deterministic whatever the mode, as JAX's deterministic=True
    got = vit.get_last_selfattention(torch.from_numpy(x))
    assert vit.training
    assert got.shape == (2, 2, 256, 256) and want.shape == got.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.detach().sum(-1).numpy(), 1.0, atol=ATOL)
    vit.eval()


def test_block_with_attention_weights_matches_jax(vit_pair):
    """``Block(return_attention=True)``: the block's output and its
    attention's probabilities, which ``need_weights=True`` computes in plain
    torch as the JAX package's branch computes them in plain XLA; the output
    equals the kernel path's (``need_weights=False``)."""
    jvit, params, vit, _ = vit_pair
    tokens = np.random.default_rng(1).normal(size=(2, 256, 64)).astype(np.float32)
    jblock = JaxBlock(64, 2, qkv_bias=True)
    y_want, attn_want = jblock.apply({"params": to_jnp(params["blocks_0"])},
                                     jnp.asarray(tokens), True, True)
    y, attn = vit.blocks[0](torch.from_numpy(tokens), return_attention=True)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(attn_want), atol=ATOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), atol=ATOL)
    np.testing.assert_allclose(vit.blocks[0](torch.from_numpy(tokens)).detach().numpy(),
                               y.detach().numpy(), atol=ATOL)
    out, probs = vit.blocks[0].attn(torch.from_numpy(tokens), need_weights=True)
    assert probs.shape == (2, 2, 256, 256) and out.shape == (2, 256, 64)


@pytest.fixture(scope="module")
def bn_head_pair():
    jhead = JaxDINOHead(out_dim=96, use_bn=True, norm_last_layer=False, hidden_dim=48,
                        bottleneck_dim=24)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = perturbed_numpy_tree(variables["params"], 3)
    stats = perturbed_numpy_tree(variables["batch_stats"], 4)
    head = DINOHead(32, 96, use_bn=True, norm_last_layer=False, hidden_dim=48,
                    bottleneck_dim=24)
    head.load_state_dict(dino_head_state_dict_from_jax(params, stats), strict=True)
    return jhead, params, stats, head, x


def test_bn_head_names_follow_the_reference_sequential(bn_head_pair):
    *_, head, _ = bn_head_pair
    assert [type(m).__name__ for m in head.mlp] == [
        "Dense", "_FeatureBatchNorm", "_Gelu", "Dense", "_FeatureBatchNorm", "_Gelu", "Dense"]
    names = set(head.state_dict())
    assert {"mlp.1.running_mean", "mlp.4.running_var", "mlp.6.weight"} <= names
    plain = DINOHead(32, 96, hidden_dim=48, bottleneck_dim=24)  # mlp.{0,2,4} without
    assert len(plain.mlp) == 5 and plain.mlp[4].weight.shape == (24, 48)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_head_matches_jax(bn_head_pair, train):
    jhead, params, stats, head, x = bn_head_pair
    head = head.train(train)
    before = {k: v.clone() for k, v in head.state_dict().items()}
    variables = {"params": to_jnp(params), "batch_stats": to_jnp(stats)}
    if train:
        want, updated = jhead.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        new_stats = jax.tree_util.tree_map(np.asarray, updated["batch_stats"])
    else:
        want, new_stats = jhead.apply(variables, jnp.asarray(x), train=False), stats
    got = head(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    for j, idx in ((0, 1), (1, 4)):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(head.state_dict()[f"mlp.{idx}.{ours}"].numpy(),
                                       np.asarray(new_stats[f"bn_{j}"][theirs]), atol=ATOL,
                                       err_msg=f"bn_{j} {theirs}")
    moved = max(float((head.state_dict()[k] - before[k]).abs().max())
                for k in before if "running" in k)
    assert (moved > 1e-3) if train else moved == 0.0
    head.load_state_dict(before)


def test_sinkhorn_knopp_teacher_matches_jax():
    # teacher logits of the size a DINO head gives (|x| / temp well inside exp's fp32 range)
    logits = (0.1 * np.random.default_rng(5).normal(size=(64, 256))).astype(np.float32)
    want = np.asarray(jax_sinkhorn(jnp.asarray(logits), 0.04))
    got = sinkhorn_knopp_teacher(torch.from_numpy(logits), 0.04)
    assert got.dtype == torch.float32 and got.shape == (64, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_export_refuses_a_head_with_batchnorm():
    student = CCDPretrainModel(arch="vit_micro", out_dim=64, use_bn_in_head=True)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=False,
                               use_bn_in_head=True)
    with pytest.raises(ValueError, match="use_bn_in_head head cannot be exported"):
        pretrain_reference_state_dicts(student, teacher)
