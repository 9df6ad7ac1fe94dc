"""The port stands alone: it imports torch, never jax/flax, and nothing of
the JAX package (nor TensorBoard, until a trainer makes its writer); its entry
points refuse to carry on without a card."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ccd_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "orbax", "ccd_tpu")
# every module that holds a kernel wrapper or a piece of the two ported paths
MODULES = ("ops.flash_attention", "ops.fused_dino_ce", "ops.image", "ops.pooling", "ops.warp",
           "ops.cc_label", "ops._build", "models.heads", "models.layers", "models.pretrain",
           "models.vit", "losses.losses", "schedules", "training.optim",
           "training.pretrain_step", "builders", "checkpoints.from_jax", "cli.evaluate",
           "ops.bilateral", "data.random", "data.aug_ops", "data.augment", "data.dataset",
           "data.pipeline", "utils.logging", "utils.meters", "checkpoints.torch_io", "cli.train",
           "training.finetune_step", "cli.train_finetune", "cli.calibrate",
           "evaluation.runner", "models.recognizer", "models.nrtr",
           "checkpoints.torch_export", "cli.parity_eval", "cli.overfit_probe",
           "cli.generate_masks", "ops.kmeans_mask")


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        if "_build" in dirpath:
            continue
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_fresh_interpreter_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ccd_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ccd_tpu_torch.__path__, 'ccd_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert len(names) >= 57, names\n"
        "for n in %r: assert 'ccd_tpu_torch.' + n in names, n\n"
        "print('BAD', bad)\n"
        "print('TENSORBOARD', sorted(m for m in sys.modules if 'tensorboard' in m))\n"
        % (FORBIDDEN, MODULES))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    # the trainers import TensorBoard when they make a writer, not when imported
    assert "TENSORBOARD []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, f"{path}: imports {mod}"


def test_port_does_not_call_library_attention():
    """Nothing in the package stands in for a kernel: no fused library
    attention and no torch.compile anywhere; the library's softmax and
    cross-entropy stay out of the module that wraps the fused CE kernels,
    except in its plain version."""
    with open(os.path.join(PKG, "ops", "fused_dino_ce.py")) as f:
        text = f.read()
    plain = text[text.index("def fused_dino_row_ce_plain"):text.index("def _call")]
    rest = text.replace(plain, "")
    for word in ("torch.softmax", "torch.log_softmax", "cross_entropy", "logsumexp", "F."):
        assert word not in rest, word
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue  # times the library call once, as a yardstick only
        with open(path) as f:
            text = f.read()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


def test_cuda_request_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot be shown")
    from ccd_tpu_torch.builders import build_recognizer
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.utils.device import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()  # the default is the card
    assert resolve_device("cpu").type == "cpu"
    cfg = Config(os.path.join(PKG, "configs", "smoke_finetune.yaml"))
    with pytest.raises(RuntimeError):
        build_recognizer(cfg)
    from ccd_tpu_torch.builders import build_pretrain_models
    with pytest.raises(RuntimeError):
        build_pretrain_models(Config(os.path.join(PKG, "configs", "smoke_pretrain.yaml")))
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.evaluate import main
        main(["-c", os.path.join(PKG, "configs", "smoke_finetune.yaml"), "--synthetic", "4"])
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.train import main as train_main
        train_main(["-c", os.path.join(PKG, "configs", "smoke_pretrain.yaml"), "--synthetic", "4"])
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.train_finetune import main as finetune_main
        finetune_main(["-c", os.path.join(PKG, "configs", "smoke_finetune.yaml"),
                       "--synthetic", "4"])
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.calibrate import main as calibrate_main
        calibrate_main(["--small"])
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.parity_eval import main as parity_main
        parity_main(["--pth", "absent.pth", "--test_root", REPO, "-c",
                     os.path.join(PKG, "configs", "smoke_finetune.yaml")])
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.overfit_probe import main as probe_main
        probe_main(["--steps", "1"])
    with pytest.raises(RuntimeError):
        from ccd_tpu_torch.cli.generate_masks import main as masks_main
        masks_main(["--src", REPO, "--mask_root", os.path.join(REPO, "absent")])


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
