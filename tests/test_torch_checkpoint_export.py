"""The port's reference-layout export (``ccd_tpu_torch/checkpoints/torch_export.py``)
against the JAX package's (``ccd_tpu/checkpoints/torch_export.py``), CPU,
``vit_micro`` widths, weights perturbed by seeded numpy noise and carried
into the port by ``from_jax.py``.

Held exactly (``assert_array_equal``, dtypes included): the two exports key
for key and value for value, with and without ``module.``; the JAX
package's importer (``torch_import.convert_*_checkpoint``) of the port's
files against the JAX trees they came from; the port's own strict loaders of
its export; a trainer's payload file against the live model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.checkpoints.torch_export import (export_pretrain_state_dicts,
                                              export_recognizer_state_dict)
from ccd_tpu.checkpoints.torch_import import (convert_pretrain_checkpoint,
                                              convert_recognizer_checkpoint)
from ccd_tpu.models import CCDPretrainModel as JaxCCDPretrainModel
from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu_torch.builders import load_pretrained_backbone, load_recognizer_params
from ccd_tpu_torch.checkpoints import save_pretrain_torch, save_recognizer_torch
from ccd_tpu_torch.checkpoints.from_jax import (pretrain_state_dicts_from_jax,
                                                recognizer_state_dict_from_jax)
from ccd_tpu_torch.checkpoints.torch_export import (pretrain_reference_state_dicts,
                                                    recognizer_reference_state_dict)
from ccd_tpu_torch.checkpoints.torch_io import save_payload
from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.training.finetune_step import finetune_state_payload, init_finetune_state
from ccd_tpu_torch.training.pretrain_step import init_pretrain_state, pretrain_state_payload

from _torch_port import MICRO_DECODER, one_torch_thread, perturbed_numpy_tree  # noqa: F401

OUT_DIM = 64
N_LAYERS, DEPTH = MICRO_DECODER["decoder_n_layers"], 3  # vit_micro's depth


@pytest.fixture(scope="module")
def recognizer():
    """JAX parameters (perturbed) and the port's recognizer holding them."""
    jmodel = JaxCCDRecognizer(arch="vit_micro", **MICRO_DECODER)
    t = MICRO_DECODER["max_seq_len"]
    tgt = jnp.full((1, t), jmodel.padding_idx, jnp.int32).at[:, 0].set(jmodel.start_idx)
    params = jax.jit(lambda rng: jmodel.init({"params": rng, "dropout": rng},
                                             jnp.zeros((1, 32, 128, 3)), tgt,
                                             train_mode=True))(jax.random.PRNGKey(4))["params"]
    params = perturbed_numpy_tree(params, seed=41)
    model = CCDRecognizer(arch="vit_micro", **MICRO_DECODER)
    model.load_state_dict(recognizer_state_dict_from_jax(params), strict=True)
    return params, model


@pytest.fixture(scope="module")
def pretrain():
    """JAX student/teacher parameters and the student's batch statistics
    (perturbed, the teacher apart from the student), and the port's two
    models holding them."""
    student = JaxCCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                                  norm_last_layer=False)
    # the variables of ccd_tpu/training/pretrain_step.py::init_pretrain_state, jitted
    variables = jax.jit(lambda rng: student.init(
        {"params": rng, "dropout": rng}, jnp.zeros((2, 32, 128, 3)),
        jnp.zeros((2, 26, 32, 128)), train=False))(jax.random.PRNGKey(5))
    sp = perturbed_numpy_tree(variables["params"], seed=42)
    tp = perturbed_numpy_tree({k: variables["params"][k] for k in ("backbone", "head")}, seed=43)
    ss = perturbed_numpy_tree(variables["batch_stats"], seed=44)
    ss = jax.tree_util.tree_map(np.abs, ss)  # running variances stay positive
    s_sd, t_sd = pretrain_state_dicts_from_jax(sp, ss, tp)
    pstudent = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                                norm_last_layer=False)
    pteacher = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    pstudent.load_state_dict(s_sd, strict=True)
    pteacher.load_state_dict(t_sd, strict=True)
    return (sp, ss, tp), (pstudent, pteacher)


def _assert_same_state_dict(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu" and g.is_contiguous(), k
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_trees_equal(got, want):
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lg, lw):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("module_prefix", [False, True], ids=["bare", "module_prefix"])
def test_recognizer_export_equals_jax_export(recognizer, module_prefix):
    params, model = recognizer
    want = export_recognizer_state_dict(params, module_prefix=module_prefix)
    got = recognizer_reference_state_dict(model, module_prefix=module_prefix)
    _assert_same_state_dict(got, want)
    extra = ("module." if module_prefix else "") + "decoder.position_enc.position_table"
    assert got[extra].shape == (1, 200, MICRO_DECODER["decoder_d_embedding"])


def test_pretrain_export_equals_jax_export(pretrain):
    (sp, ss, tp), (student, teacher) = pretrain
    want = export_pretrain_state_dicts(sp, tp, ss)
    got_student, got_teacher = pretrain_reference_state_dicts(student, teacher)
    _assert_same_state_dict(got_student, want["student"])
    _assert_same_state_dict(got_teacher, want["teacher"])
    assert got_student["segmentation.unpool1.1.num_batches_tracked"].dtype == torch.int64
    assert got_student["segmentation.conv_mla.mla_p2.0.weight"].shape == (128, 128, 3, 3)


def test_chip_smoke_name_lists_are_the_jax_exports(recognizer, pretrain):
    """chip_smoke.py holds the card's exports to name lists written out in
    the script (it imports nothing of the JAX package): at these widths they
    are the JAX exports' names, and at ViT-Small's they count as it states."""
    import chip_smoke
    params, _ = recognizer
    (sp, ss, tp), _ = pretrain
    assert chip_smoke.reference_recognizer_keys(DEPTH, N_LAYERS) == \
        list(export_recognizer_state_dict(params))
    want = export_pretrain_state_dicts(sp, tp, ss)
    got = chip_smoke.reference_pretrain_keys(DEPTH)
    for branch in ("student", "teacher"):
        assert sorted(got[branch]) == sorted(want[branch]) and \
            len(got[branch]) == len(set(got[branch]))
    full = {"recognizer": chip_smoke.reference_recognizer_keys(),
            **chip_smoke.reference_pretrain_keys()}
    assert {k: len(v) for k, v in full.items()} == chip_smoke.REFERENCE_KEY_COUNTS


def test_jax_importer_reads_the_port_files_back(recognizer, pretrain, tmp_path):
    params, model = recognizer
    path = str(tmp_path / "best_accuracy.pth")
    save_recognizer_torch(model, path, iteration=7, module_prefix=True)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert ckpt["iteration"] == 7 and all(k.startswith("module.") for k in ckpt["net"])
    _assert_trees_equal(convert_recognizer_checkpoint(ckpt, n_layers=N_LAYERS, depth=DEPTH),
                        params)

    (sp, ss, tp), (student, teacher) = pretrain
    path = str(tmp_path / "checkpoint.pth")
    save_pretrain_torch(student, teacher, path, epoch=2, iteration=9)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["iteration"]) == (2, 9)
    s_params, s_stats = convert_pretrain_checkpoint(path, branch="student", depth=DEPTH)
    t_params, t_stats = convert_pretrain_checkpoint(path, branch="teacher", depth=DEPTH)
    _assert_trees_equal(s_params, sp)
    _assert_trees_equal(s_stats, ss)
    _assert_trees_equal(t_params, tp)
    assert t_stats == {}


def test_port_reads_its_export_back_strictly(recognizer, pretrain, tmp_path):
    _, model = recognizer
    path = str(tmp_path / "net.pth")
    for module_prefix in (False, True):
        save_recognizer_torch(model, path, module_prefix=module_prefix)
        fresh = load_recognizer_params(path, CCDRecognizer(arch="vit_micro", **MICRO_DECODER))
        _assert_same_state_dict(fresh.state_dict(), {k: v.numpy() for k, v in
                                                     model.state_dict().items()})

    _, (student, teacher) = pretrain
    path = str(tmp_path / "pretrain.pth")
    save_pretrain_torch(student, teacher, path)
    fresh = load_pretrained_backbone(path, CCDRecognizer(arch="vit_micro", **MICRO_DECODER))
    _assert_same_state_dict(fresh.backbone.state_dict(),
                            {k: v.numpy() for k, v in teacher.backbone.state_dict().items()})


def test_payload_files_export_as_the_live_models(recognizer, pretrain, tmp_path):
    _, model = recognizer
    path = str(tmp_path / "best_accuracy.pt")
    save_payload(path, finetune_state_payload(init_finetune_state(model), best_accuracy=0.5))
    model.eval()
    _assert_same_state_dict(recognizer_reference_state_dict(path),
                            {k: v.numpy() for k, v in
                             recognizer_reference_state_dict(model).items()})

    _, (student, teacher) = pretrain
    state = init_pretrain_state(student, teacher)
    path, out = str(tmp_path / "ckpt_00000003.pt"), str(tmp_path / "exported.pth")
    save_payload(path, pretrain_state_payload(state))
    save_pretrain_torch(path, None, out, iteration=3)
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    live_student, live_teacher = pretrain_reference_state_dicts(state.student, state.teacher)
    _assert_same_state_dict(ckpt["student"], {k: v.numpy() for k, v in live_student.items()})
    _assert_same_state_dict(ckpt["teacher"], {k: v.numpy() for k, v in live_teacher.items()})
    assert ckpt["iteration"] == 3
    with pytest.raises(ValueError):
        pretrain_reference_state_dicts(student)  # a module alone holds no teacher
