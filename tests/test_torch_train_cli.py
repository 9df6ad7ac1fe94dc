"""The pretraining loop of the port around the step: the fused step (raw
uint8 in, views drawn on the device), the multi step, checkpoints, the data
path and the ``train`` CLI, on the CPU at ``vit_micro`` / smoke size.

What holds the slice to the JAX package: ``pretrain_views`` against JAX's on
one key (tests/test_torch_aug_ops.py) and the step on given views against
JAX's six steps (tests/test_torch_pretrain_step.py). Here the fused step is
held to that step on the views the port's ``pretrain_views`` makes from the
same generator state, and K multi-step iterations to K fused steps: same
process, same arithmetic, so losses and parameters must be equal (0
tolerance). The CLI is checked end to end: finite losses, a checkpoint
written, a second run that resumes from it, a run at augmentation severity
2, and the TensorBoard scalars the JAX CLI writes (to a recording stand-in
for the writer: tests/_torch_port.py::recorded_writers).
"""

import copy
import logging
import os

import numpy as np
import pytest
import torch

from ccd_tpu_torch.checkpoints.torch_io import CheckpointManager
from ccd_tpu_torch.data.augment import pretrain_views
from ccd_tpu_torch.data.dataset import PretrainDataset, build_dataset, mask_env_path
from ccd_tpu_torch.data.pipeline import device_chunks, stage_pretrain_chunk
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.data.synthetic import make_synthetic_batch, write_synthetic_lmdb
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state, make_fused_pretrain_step,
                                                  make_multi_pretrain_step, make_pretrain_step,
                                                  pretrain_state_payload,
                                                  restore_pretrain_state)
from ccd_tpu_torch.utils import MetricLogger

from _torch_port import one_torch_thread, recorded_writers  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "ccd_tpu_torch", "configs", "smoke_pretrain.yaml")
VIT_BASE = os.path.join(REPO, "ccd_tpu_torch", "configs", "ccd_pretrain_vit_base.yaml")
BATCH = 4
SCHEDULE = dict(base_lr=5e-4, min_lr=1e-6, total_iters=100, warmup_iters=1,
                weight_decay=0.04, weight_decay_end=0.4, momentum_teacher=0.99,
                teacher_temps=np.full(10, 0.04, np.float32), clip_grad=3.0,
                freeze_last_layer=0, global_batch=BATCH, imgnet_based=1000)


def _state(seed: int = 0):
    student = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=True,
                               norm_last_layer=False, drop_path_rate=0.1)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=False)
    g = torch.Generator().manual_seed(seed)
    student.reset_parameters(g)
    teacher.reset_parameters(g)
    return init_pretrain_state(student, teacher, seed=seed)


def _twin(state):
    """A copy of ``state`` with copies of its generators' states."""
    twin = copy.copy(state)
    twin.student, twin.teacher = copy.deepcopy(state.student), copy.deepcopy(state.teacher)
    twin.opt_state = copy.deepcopy(state.opt_state)
    twin.center = state.center.clone()
    twin.generator, twin.aug_generator = torch.Generator(), torch.Generator()
    twin.generator.set_state(state.generator.get_state())
    twin.aug_generator.set_state(state.aug_generator.get_state())
    return twin


def _raw(k: int, seed: int = 0):
    images, masks, _ = make_synthetic_batch(k * BATCH, seed=seed)
    return (torch.from_numpy(images).reshape(k, BATCH, 32, 128, 3),
            torch.from_numpy(masks.astype(np.uint8)).reshape(k, BATCH, 32, 128))


def _assert_same_state(a, b):
    for x, y in ((a.student, b.student), (a.teacher, b.teacher)):
        for (name, p), q in zip(x.state_dict().items(), y.state_dict().values()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    for p, q in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    torch.testing.assert_close(a.center, b.center, rtol=0, atol=0)
    assert a.iteration == b.iteration


def test_fused_step_is_the_step_on_the_views_pretrain_views_draws():
    raws, masks = _raw(1)
    fused, plain = _state(), _state()
    key_gen = torch.Generator()
    key_gen.set_state(plain.aug_generator.get_state())
    fused, got = make_fused_pretrain_step(**SCHEDULE)(fused, raws[0], masks[0])
    views, theta = pretrain_views(TorchKey(key_gen), raws[0].float() / 255.0)
    plain, want = make_pretrain_step(**SCHEDULE)(plain, views, masks[0].float(), theta)
    for k in ("loss", "mask_loss", "dino_loss"):
        assert torch.isfinite(got[k]) and float(got[k]) == float(want[k]), k
    _assert_same_state(fused, plain)
    # the views were drawn from the state's own generator, which moved on
    torch.testing.assert_close(fused.aug_generator.get_state(), key_gen.get_state(),
                               rtol=0, atol=0)
    assert not torch.equal(fused.aug_generator.get_state(), _state().aug_generator.get_state())


def test_multi_step_is_k_fused_steps():
    raws, masks = _raw(3, seed=1)
    multi = _state(1)
    single = _twin(multi)
    multi, stacked = make_multi_pretrain_step(**SCHEDULE)(multi, raws, masks)
    fused = make_fused_pretrain_step(**SCHEDULE)
    history = []
    for raw, mask in zip(raws, masks):
        single, m = fused(single, raw, mask)
        history.append(m)
    assert set(stacked) == {"loss", "mask_loss", "dino_loss", "lr", "wd", "epoch",
                            "cluster_rounds"}
    rounds = stacked["cluster_rounds"]  # host ints, stacked on the CPU
    assert rounds.dtype == torch.int64 and rounds.device.type == "cpu" and (rounds >= 1).all()
    for k, v in stacked.items():
        assert v.shape == (3,)
        np.testing.assert_array_equal(v.numpy(), np.array([float(m[k]) for m in history]), k)
    _assert_same_state(multi, single)
    assert multi.iteration == 3


def test_checkpoint_manager_keeps_and_restores(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, keep_period=4)
    assert manager.latest_step() is None and manager.restore() is None
    for step in range(1, 7):
        manager.save(step, {"w": torch.full((2,), float(step)), "iteration": step})
    assert manager.all_steps() == [4, 5, 6]  # the newest two, and 4 (keep_period)
    assert manager.latest_step() == 6
    payload = manager.restore()
    assert payload["iteration"] == 6 and torch.equal(payload["w"], torch.full((2,), 6.0))


def test_restore_puts_the_payload_back(tmp_path):
    raws, masks = _raw(1, seed=2)
    trained = _state(2)
    trained, _ = make_fused_pretrain_step(**SCHEDULE)(trained, raws[0], masks[0])
    manager = CheckpointManager(str(tmp_path))
    manager.save(trained.iteration, pretrain_state_payload(trained))
    fresh = restore_pretrain_state(_state(3), manager.restore(1))
    _assert_same_state(fresh, trained)
    assert fresh.opt_state.count == trained.opt_state.count == 1


def test_pretrain_dataset_and_staging(tmp_path):
    root = str(tmp_path / "training" / "SYNTH")
    mask_root = str(tmp_path / "Mask")
    write_synthetic_lmdb(root, 6, seed=5, with_mask_lmdb=True,
                         mask_path=mask_env_path(root, mask_root))
    ds = build_dataset(PretrainDataset, [root], is_training=True, img_h=32, img_w=128,
                       mask=True, mask_path=mask_root)
    image, mask = ds[0]
    assert image.shape == (32, 128, 3) and image.dtype == np.uint8
    assert mask.shape == (32, 128) and set(np.unique(mask)) <= {0.0, 1.0} and mask.any()
    batches = iter([(np.stack([ds[i][0], ds[i + 1][0]]), np.stack([ds[i][1], ds[i + 1][1]]))
                    for i in range(0, 6, 2)])
    raws, ms, ready = next(device_chunks(batches, 3, lambda c: stage_pretrain_chunk(
        c, torch.device("cpu"))))
    assert ready is None and raws.shape == (3, 2, 32, 128, 3) and raws.dtype == torch.uint8
    assert ms.shape == (3, 2, 32, 128) and ms.dtype == torch.uint8
    assert torch.equal(ms[0, 0], torch.from_numpy(mask.astype(np.uint8)))

    def failing(_chunk):
        raise OSError("no such file")

    with pytest.raises(OSError):
        next(device_chunks(iter([(1, 2)] * 2), 1, failing))


def test_metric_logger():
    log = MetricLogger(delimiter="  ")
    for v in (1.0, 2.0, 3.0):
        log.update(loss=v)
    log.synchronize_between_processes()  # one process: nothing to do
    assert log.loss.global_avg == 2.0 and log.loss.median == 2.0
    assert str(log).startswith("loss: 2.0000")


def test_train_cli_on_the_cpu_writes_a_checkpoint_and_resumes(tmp_path, monkeypatch, caplog):
    from ccd_tpu_torch.cli.train import main
    monkeypatch.chdir(tmp_path)  # checkpoints and logs land under the working directory
    caplog.set_level(logging.INFO)  # pytest's handlers make the CLI's basicConfig a no-op
    # 16 words at batch 4: 4 iterations an epoch, 1 epoch in the smoke config
    args = ["-c", SMOKE, "--synthetic", "16", "--batch_size_per_gpu", "4", "--device", "cpu"]
    first = main(args + ["--max_iters", "2"])
    assert first["iteration"] == 2 and first["checkpoint"] == 2
    assert all(np.isfinite(first["last"][k]) for k in ("loss", "mask_loss", "dino_loss"))
    assert first["images_per_s"] > 0
    ckpt = tmp_path / "saved_models" / "smoke_pretrain" / "ckpt_00000002.pt"
    assert ckpt.is_file()
    saved = torch.load(ckpt, weights_only=True)
    assert saved["iteration"] == 2 and saved["opt_state"]["count"] == 2

    second = main(args + ["--max_iters", "3"])  # resumes at 2: runs iteration 2
    assert second["iteration"] == 3 and second["checkpoint"] == 3
    assert np.isfinite(second["last"]["loss"])
    log = (tmp_path / "workdir" / "smoke_pretrain" / "train.txt").read_text()
    assert "resuming from checkpoint step 2" in log
    assert "it 2 epoch 0" in log and "it 1 epoch 0" in log


@pytest.mark.parametrize("name,trains", [("sgd", True), ("lars", True), ("adamw", True),
                                         ("", True), ("adagrad", False)])
def test_train_cli_refuses_an_optimizer_it_has_not_ported(tmp_path, monkeypatch, caplog, name,
                                                          trains):
    """The configuration's ``optimizer`` is read: ``adamw`` (or none, as
    train.py defaults it), ``sgd`` and ``lars`` train one iteration, and a
    second run resumes from the checkpoint with the optimizer's own state
    (sgd/lars: the momentum, non-zero after a step at a non-zero learning
    rate). A name that ``make_optimizer`` does not know is refused with its
    ``ValueError`` before any step runs."""
    import yaml

    from ccd_tpu_torch.cli.train import main
    monkeypatch.chdir(tmp_path)
    caplog.set_level(logging.INFO)  # pytest's handlers make the CLI's basicConfig a no-op
    with open(SMOKE) as f:
        cfg = yaml.safe_load(f)
    cfg["optimizer"] = name
    path = tmp_path / "pretrain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["-c", str(path), "--synthetic", "8", "--batch_size_per_gpu", "4", "--device", "cpu"]
    if not trains:
        with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
            main(args + ["--max_iters", "1"])
        assert not (tmp_path / "saved_models" / "smoke_pretrain").exists()
        return
    out = main(args + ["--max_iters", "1"])
    assert out["iteration"] == 1 and np.isfinite(out["last"]["loss"])
    if name in ("sgd", "lars"):
        ckpt = tmp_path / "saved_models" / "smoke_pretrain" / "ckpt_00000001.pt"
        saved = torch.load(ckpt, weights_only=True)["opt_state"]
        assert saved["optimizer"] == name and set(saved) == {"optimizer", "trace"}
        resumed = main(args + ["--max_iters", "2"])
        assert resumed["iteration"] == 2 and np.isfinite(resumed["last"]["loss"])
        log = (tmp_path / "workdir" / "smoke_pretrain" / "train.txt").read_text()
        assert "resuming from checkpoint step 1" in log


MESH_REFUSALS = [({"model_parallel": 2}, ValueError, "model_parallel=2 must divide device count 1"),
                 ({"num_devices": 2}, ValueError, "num_devices=2 > available 1"),
                 ({"num_devices": 0}, ValueError, "processes would have no data")]


@pytest.mark.parametrize("mesh,error,words", MESH_REFUSALS,
                         ids=["model_parallel_2", "more_devices", "fewer_devices"])
def test_train_cli_refuses_a_mesh_it_cannot_lay(tmp_path, monkeypatch, mesh, error, words):
    """A ``mesh.model_parallel`` that does not divide the world size (1
    here, one process; JAX's own divisor refusal) and a
    ``mesh.num_devices`` other than the world size are refused before
    anything is built, as the JAX CLI's ``pretrain_mesh`` refuses a mesh
    it cannot lay (tests/test_train_steps.py)."""
    import yaml

    from ccd_tpu_torch.cli.train import main
    monkeypatch.chdir(tmp_path)
    with open(SMOKE) as f:
        cfg = yaml.safe_load(f)
    cfg["mesh"] = mesh
    path = tmp_path / "pretrain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(error, match=words):
        main(["-c", str(path), "--synthetic", "8", "--max_iters", "1", "--device", "cpu"])
    assert not (tmp_path / "saved_models").exists()


def test_init_pretrain_state_refuses_an_optimizer_it_has_not_ported():
    """An optimizer name ``make_optimizer`` does not know raises its
    ``ValueError``; sgd and lars build their momentum. A student with
    ``use_bn_in_head`` is refused with the JAX step's own failure: its head
    BatchNorm cannot update its statistics there."""
    student = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=False)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=False)
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        init_pretrain_state(student, teacher, optimizer="adagrad")
    assert init_pretrain_state(student, teacher, optimizer="adamw").iteration == 0
    for name in ("sgd", "lars"):
        state = init_pretrain_state(student, teacher, optimizer=name)
        assert state.opt_state.name == name
        assert len(state.opt_state.trace) == len(list(student.parameters()))
    bn_student = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=False,
                                  use_bn_in_head=True)
    bn_teacher = CCDPretrainModel(arch="vit_micro", out_dim=64, with_seg_head=False,
                                  use_bn_in_head=True)
    with pytest.raises(NotImplementedError, match="ModifyScopeVariableError"):
        init_pretrain_state(bn_student, bn_teacher)


def test_train_cli_at_severity_2_writes_the_jax_clis_scalars(tmp_path, monkeypatch,
                                                            recorded_writers):
    """Two iterations with ``dataset.augmentation_severity: 2`` (the
    SomeOf chain with crops, elastic and perspective warps); at every show
    boundary (every iteration in the smoke config) the five scalars of
    train.py:250-252 at the iteration, to a writer named after the run."""
    import yaml

    from ccd_tpu_torch.cli.train import main
    monkeypatch.chdir(tmp_path)
    with open(SMOKE) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"]["augmentation_severity"] = 2
    path = tmp_path / "pretrain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = main(["-c", str(path), "--synthetic", "8", "--batch_size_per_gpu", "4",
                "--device", "cpu", "--max_iters", "2"])
    assert out["iteration"] == 2
    assert all(np.isfinite(out["last"][k]) for k in ("loss", "mask_loss", "dino_loss"))
    [writer] = recorded_writers
    assert writer.name == "smoke_pretrain" and writer.closed and not writer.images
    tags = [f"metric/{k}" for k in ("loss", "mask_loss", "dino_loss", "lr", "wd",
                                    "cluster_rounds")]
    assert [(tag, step) for tag, _, step in writer.scalars] == \
        [(tag, step) for step in (1, 2) for tag in tags]
    assert all(np.isfinite(value) for _, value, _ in writer.scalars)
    assert [v for tag, v, step in writer.scalars if step == 2 and tag == "metric/loss"] == \
        [out["last"]["loss"]]


class _Built(Exception):
    """Ends a CLI run once its models are built."""


def test_train_cli_takes_the_vit_base_config(tmp_path, monkeypatch):
    """``ccd_pretrain_vit_base.yaml`` through the CLI up to its models:
    ViT-Base (C = 512, 12 blocks, 8 heads of 64), bf16, ``out_dim`` 65536,
    ``norm_last_layer: True`` (the gain ``weight_g`` out of the weight decay;
    its freezing is held in tests/test_torch_pretrain_step.py), batch 48,
    severity 5. Built on the meta device, so no full-width weights are made
    here; the card runs this configuration's steps (chip_smoke.py)."""
    from ccd_tpu_torch import builders
    from ccd_tpu_torch.cli.train import main
    from ccd_tpu_torch.training.optim import weight_decay_mask

    real, seen = builders.build_pretrain_models, {}

    def build_on_meta(config, device="cuda", generator=None):
        with torch.device("meta"):
            seen["models"] = real(config, device="meta", generator=generator)
        seen["config"] = config
        raise _Built

    monkeypatch.setattr(builders, "build_pretrain_models", build_on_meta)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(_Built):
        main(["-c", VIT_BASE, "--synthetic", "8", "--device", "cpu"])
    config, (student, teacher) = seen["config"], seen["models"]
    assert int(config.batch_size_per_gpu) == 48 and config.dataset_augmentation_severity == 5
    for model in (student, teacher):
        vit = model.backbone
        assert (vit.embed_dim, len(vit.blocks), vit.blocks[0].attn.num_heads) == (512, 12, 8)
        assert model.dtype == torch.bfloat16 and model.out_dim == 65536
        assert tuple(model.head.last_layer.weight_v.shape) == (65536, 256)
    assert student.norm_last_layer and student.segmentation is not None
    assert not weight_decay_mask(dict(student.named_parameters()),
                                 student.norm_last_layer)["head.last_layer.weight_g"]
