"""The finetune loop of the port around its step, on the CPU at smoke size:
the ``train_finetune`` CLI (train, evaluate, checkpoint, keep the best,
resume; the ABINet-style chain; the TensorBoard scalars and attention images
of the JAX CLI, to a recording stand-in for the writer
(tests/_torch_port.py::recorded_writers) and, in one test, to TensorBoard's
own), the ``calibrate`` CLI at tiny shapes, every shipped configuration
against the JAX package's, and the evaluation runner's loader cache and mode
handling. What holds the step itself to the JAX package is
tests/test_torch_finetune_step.py.
"""

import json
import logging
import math
import os

import pytest
import torch

from ccd_tpu.config import Config as JaxConfig
from ccd_tpu_torch.cli import calibrate
from ccd_tpu_torch.cli import train_finetune
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
from ccd_tpu_torch.evaluation import runner
from ccd_tpu_torch.models import CCDRecognizer

from _torch_port import MICRO_DECODER, one_torch_thread, recorded_writers  # noqa: F401

from ccd_tpu_torch.utils import logging as log_utils

REAL_SUMMARY_WRITER = log_utils.summary_writer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "ccd_tpu_torch", "configs", "smoke_finetune.yaml")


CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "ccd_tpu", "configs"))
                 if f.endswith(".yaml") and f != "template.yaml")


@pytest.mark.parametrize("name", CONFIGS)
def test_port_finetune_config_is_the_jax_one(name):
    """Every configuration both packages ship, key for key after the
    template merge, the package's own name aside (the templates name each
    package's charset file and model class)."""
    jax_cfg = vars(JaxConfig(os.path.join(REPO, "ccd_tpu", "configs", name)))
    port_cfg = vars(Config(os.path.join(REPO, "ccd_tpu_torch", "configs", name)))
    unprefixed = {k: v.replace("ccd_tpu_torch", "ccd_tpu") if isinstance(v, str) else v
                  for k, v in port_cfg.items()}
    assert unprefixed == jax_cfg
    if not name.startswith("smoke"):
        assert port_cfg["training_steps_per_dispatch"] == 8


def test_the_port_ships_every_jax_config():
    assert len(CONFIGS) == 7
    assert set(CONFIGS) <= set(os.listdir(os.path.join(REPO, "ccd_tpu_torch", "configs")))


def test_train_finetune_cli_trains_evaluates_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                                     caplog):
    monkeypatch.chdir(tmp_path)
    caplog.set_level(logging.INFO)
    common = ["-c", SMOKE, "--synthetic", "16", "--batch_size", "4", "--device", "cpu"]
    first = train_finetune.main(common + ["--max_iters", "2"])
    run_dir = tmp_path / "saved_models" / "smoke_finetune"
    assert first["iteration"] == 2 and first["checkpoint"] == 2
    assert (run_dir / "ckpt_00000002.pt").is_file() and (run_dir / "best_accuracy.pt").is_file()
    log = (run_dir / "log_all_evaluation.txt").read_text()
    assert "iteration: 2" in log and "total_accuracy:" in log
    best = torch.load(run_dir / "best_accuracy.pt", weights_only=True)
    assert best["iteration"] == 2 and {"net", "opt_state", "best_accuracy"} <= set(best)

    second = train_finetune.main(common + ["--max_iters", "4"])
    assert second["iteration"] == 4 and second["checkpoint"] == 4
    assert "continue to train:2" in caplog.text
    assert second["best_accuracy"] >= first["best_accuracy"]
    assert (run_dir / "log_all_evaluation.txt").read_text().count("total_accuracy:") == 2
    assert (tmp_path / "workdir" / "smoke_finetune" / "train.txt").is_file()


@pytest.mark.parametrize("mesh,error,words", [
    ({"model_parallel": 2}, NotImplementedError, "ROADMAP M11b"),
    ({"num_devices": 2}, ValueError, "num_devices=2 > available 1"),
    ({"num_devices": 0}, ValueError, "processes would have no data")],
    ids=["model_parallel_2", "more_devices", "fewer_devices"])
def test_train_finetune_cli_refuses_a_mesh_it_cannot_lay(tmp_path, monkeypatch, mesh, error,
                                                         words):
    """The JAX CLI lays a data mesh over ``mesh.num_devices``
    (train_finetune.py:244): a number other than the world size (1 here)
    is refused, and so is ``mesh.model_parallel`` above 1, before anything
    is built."""
    import yaml
    monkeypatch.chdir(tmp_path)
    with open(SMOKE) as f:
        cfg = yaml.safe_load(f)
    cfg["mesh"] = mesh
    path = tmp_path / "finetune.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(error, match=words):
        train_finetune.main(["-c", str(path), "--synthetic", "8", "--max_iters", "1",
                             "--device", "cpu"])
    assert not (tmp_path / "saved_models").exists()


def _abinet_config(tmp_path) -> str:
    """The smoke configuration with ``dataset.use_abi`` (the ABINet-style
    chain) and an evaluation every 2 iterations."""
    import yaml
    with open(SMOKE) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"]["use_abi"] = True
    cfg["training"]["eval_iters"] = 2
    path = tmp_path / "finetune_abi.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


ABINET_RUN = ["--synthetic", "16", "--batch_size", "4", "--device", "cpu", "--max_iters", "2"]


def test_train_finetune_cli_with_abinet_writes_the_jax_clis_tags(tmp_path, monkeypatch,
                                                                recorded_writers):
    """Two iterations through ``abinet_augment``; at every show boundary
    (every iteration) train_finetune.py:248-253's scalars and the two
    attention images, (3, 32, 128) and (3, 32 * ceil(T / 5), 128 * 5) with
    T = 25, and after the periodic evaluation at iteration 2 its accuracy."""
    monkeypatch.chdir(tmp_path)
    out = train_finetune.main(["-c", _abinet_config(tmp_path)] + ABINET_RUN)
    assert out["iteration"] == 2 and 0.0 <= out["accuracy"] <= 1.0
    [writer] = recorded_writers
    assert writer.name == "smoke_finetune" and writer.closed
    assert [(tag, step) for tag, _, step in writer.scalars] == [
        ("metric/train_loss", 1), ("metric/lr", 1),
        ("metric/train_loss", 2), ("metric/lr", 2), ("metric/eval_acc", 2)]
    assert all(math.isfinite(v) for _, v, _ in writer.scalars)
    assert writer.images == [(tag, shape, step) for step in (1, 2) for tag, shape in (
        ("Mask/Input_image", (3, 32, 128)), ("Mask/vis_Maps", (3, 32 * 5, 128 * 5)))]


def test_train_finetune_cli_tensorboard_events_read_back(tmp_path, monkeypatch):
    """The one test with TensorBoard's own writer: the event file under
    ./tensorboard/<name> holds the CLI's scalars and images, as TensorBoard's
    ``EventAccumulator`` reads them."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setattr(log_utils, "summary_writer", REAL_SUMMARY_WRITER)
    monkeypatch.chdir(tmp_path)
    train_finetune.main(["-c", _abinet_config(tmp_path)] + ABINET_RUN)
    events = EventAccumulator(str(tmp_path / "tensorboard" / "smoke_finetune"))
    events.Reload()
    tags = events.Tags()
    assert set(tags["scalars"]) == {"metric/train_loss", "metric/lr", "metric/eval_acc"}
    assert set(tags["images"]) == {"Mask/Input_image", "Mask/vis_Maps"}
    assert [e.step for e in events.Scalars("metric/train_loss")] == [1, 2]
    assert [e.step for e in events.Scalars("metric/eval_acc")] == [2]
    maps = events.Images("Mask/vis_Maps")[-1]
    assert (maps.height, maps.width) == (160, 640)


def test_train_finetune_cli_run_only_test(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = train_finetune.main(["-c", SMOKE, "--synthetic", "16", "--batch_size", "4",
                               "--device", "cpu", "--run_only_test"])
    assert out["iteration"] == 0 and 0.0 <= out["accuracy"] <= 1.0
    assert not (tmp_path / "saved_models" / "smoke_finetune" / "best_accuracy.pt").exists()


def test_calibrate_cli_runs_at_small_shapes(capsys):
    result = calibrate.main(["--device", "cpu", "--small", "--iters", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    names = [r["name"] for r in result["rows"]]
    assert len(names) == 13 and any(n.startswith("flash fwd+bwd") for n in names)
    assert result["device"] == "cpu" and result["measured_matmul_peak_tflop_per_s"] > 0
    # on CPU tensors the wrappers take their plain versions: no launches
    assert set(result["kernel_launches"].values()) == {0}


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench") / "evaluation" / "SYNTH")
    write_synthetic_lmdb(root, 8, seed=4)
    return root


def test_runner_reuses_cached_loaders_and_restores_the_mode(bench_root, monkeypatch):
    built = []
    real_build = runner.build_dataset
    monkeypatch.setattr(runner, "build_dataset",
                        lambda *a, **k: built.append(a) or real_build(*a, **k))
    model = CCDRecognizer(arch="vit_micro", **MICRO_DECODER).train()
    cache = {}
    args = dict(batch_size=4, max_seq_len=MICRO_DECODER["max_seq_len"], num_workers=1,
                loader_cache=cache)
    first, acc1 = runner.evaluate_benchmarks(model, [bench_root], names=["bench"], **args)
    assert model.training  # found in training mode, left in it
    second, acc2 = runner.evaluate_benchmarks(model.eval(), [bench_root], **args)
    assert not model.training
    assert len(built) == 1 and len(cache) == 1  # one dataset and loader for both calls
    assert first[0]["name"] == "bench" and second[0]["name"] == bench_root
    assert first[0]["words"] == second[0]["words"] == 8 and acc1 == acc2
