"""The finetune loop of the port around its step, on the CPU at smoke size:
the ``train_finetune`` CLI (train, evaluate, checkpoint, keep the best,
resume), the ``calibrate`` CLI at tiny shapes, the shipped finetune
configuration against the JAX package's, and the evaluation runner's loader
cache and mode handling. What holds the step itself to the JAX package is
tests/test_torch_finetune_step.py.
"""

import json
import logging
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

from _torch_port import MICRO_DECODER, one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "ccd_tpu_torch", "configs", "smoke_finetune.yaml")


def test_port_finetune_config_is_the_jax_one():
    """Key for key after the template merge, the package's own name aside
    (the templates name each package's charset file and model class)."""
    jax_cfg = vars(JaxConfig(os.path.join(REPO, "ccd_tpu", "configs", "ccd_finetune_ard.yaml")))
    port_cfg = vars(Config(os.path.join(REPO, "ccd_tpu_torch", "configs",
                                        "ccd_finetune_ard.yaml")))
    unprefixed = {k: v.replace("ccd_tpu_torch", "ccd_tpu") if isinstance(v, str) else v
                  for k, v in port_cfg.items()}
    assert unprefixed == jax_cfg
    assert port_cfg["training_steps_per_dispatch"] == 8


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
