"""``python -m ccd_tpu_torch.cli.convergence_demo --smoke`` on the CPU in a
temporary workdir: the three corpora, the pretrain process, the two finetune
processes (the handoff's backbone read from the pretrain checkpoint) and the
debug decode of each arm's best checkpoint connect; the summary carries the
JAX tool's keys and lands in the workdir, and the repository's own
``CONVERGENCE.json`` (the JAX demo's record) is not touched. Accuracies at
this scale mean nothing and are not checked. Then ``--resummarize`` rebuilds
the summary from the logs without running anything, and ``cli.debug_decode``
runs on its own on the scratch arm's checkpoint.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"pretrain", "finetune", "handoff", "scratch", "smoke", "command"}


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("convergence_smoke")
    before = _digest(os.path.join(REPO, "CONVERGENCE.json"))
    # the three phase processes train without a TensorBoard writer: its
    # import (TensorFlow where installed) would cost each of them seconds, and
    # the writers are held by the CLI tests (tests/test_torch_train_cli.py)
    stub = tmp_path_factory.mktemp("no_tensorboard")
    (stub / "tensorboard").mkdir()
    (stub / "tensorboard" / "__init__.py").write_text(
        'raise ImportError("TensorBoard is left out of this test\'s processes")\n')
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(stub), REPO]))
    cmd = [sys.executable, "-m", "ccd_tpu_torch.cli.convergence_demo", "--smoke",
           "--device", "cpu", "--workdir", str(workdir)]
    proc = subprocess.run(cmd, cwd=str(workdir), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(workdir / "CONVERGENCE.json") as f:
        summary = json.load(f)
    return workdir, summary, proc.stdout, before


def test_smoke_finishes_with_the_jax_tools_summary(smoke):
    workdir, summary, out, _ = smoke
    assert JAX_KEYS <= set(summary)
    assert summary["smoke"] is True and "--smoke" in summary["command"]
    assert summary["pretrain"]["arch"] == "vit_micro" and summary["pretrain"]["iters"] == 3
    assert summary["finetune"] == {"iters": 3, "labeled_samples": 32, "eval_samples": 16}
    for arm in ("handoff", "scratch"):
        assert set(summary[arm]) == {"best_acc", "final_acc", "trajectory_iter_acc"}
        assert summary[arm]["trajectory_iter_acc"][-1][0] == 3
        assert 0.0 <= summary[arm]["best_acc"] <= 1.0
        decoded = summary["debug_decode"][arm]
        assert len(decoded["rows"]) == 8 and decoded["split"] == "train"
    assert set(summary["wall_s"]) == {"data", "pretrain", "handoff", "scratch"}
    assert summary["device"] == "cpu"
    with open(workdir / "conv_ft_handoff.log") as f:
        assert "Read pretrain vision model from" in f.read()
    with open(workdir / "pretrain.log") as f:
        assert "LMDB reader: native" in f.read()


def test_the_repository_record_is_untouched(smoke):
    workdir, _, _, before = smoke
    assert _digest(os.path.join(REPO, "CONVERGENCE.json")) == before
    # each phase runs in the workdir: nothing of its lands in the repository
    with open(workdir / "pretrain.log") as f:
        assert "no TensorBoard writer" in f.read()  # the stub above; training went on
    assert not os.path.exists(os.path.join(REPO, "tensorboard", "conv_pretrain"))
    assert not os.path.exists(os.path.join(REPO, "saved_models", "conv_pretrain"))


def test_resummarize_rebuilds_the_summary_from_the_logs(smoke):
    from ccd_tpu_torch.cli.convergence_demo import main
    workdir, summary, _, before = smoke
    again = main(["--resummarize", "--smoke", "--workdir", str(workdir), "--device", "cpu"])
    for key in ("pretrain", "finetune", "handoff", "scratch", "command", "debug_decode"):
        assert again[key] == summary[key], key
    assert _digest(os.path.join(REPO, "CONVERGENCE.json")) == before


def test_debug_decode_on_the_scratch_arms_checkpoint(smoke, capsys):
    from ccd_tpu_torch.cli.debug_decode import main
    workdir, summary, _, _ = smoke
    out = main(["--config", str(workdir / "configs" / "conv_ft_scratch.yaml"),
                "--checkpoint", str(workdir / "saved_models" / "conv_ft_scratch" /
                                    "best_accuracy.pt"),
                "--eval", "--n", "4", "--device", "cpu"])
    assert out["split"] == "eval" and len(out["rows"]) == 4 and out["iteration"] == 3
    assert 0 <= out["greedy_correct"] <= 4
    printed = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("gt=") for line in printed) == 4
