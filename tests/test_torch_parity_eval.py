"""The port's released-weight harness (``ccd_tpu_torch/cli/parity_eval.py``)
against the JAX package's (``tools/parity_eval.py``), the twin of
``tests/test_parity_eval.py``.

Released weights are absent, so the harness is anchored on an exported file
of perturbed random weights and on synthetic LMDBs named like benchmarks.
So that the word accuracy is not trivially 0, the second benchmark holds the
first one's images, half of them labelled with what the model reads there.
Held exactly: the harness's weighted accuracy against a direct
``evaluate_benchmarks`` of the same model, its rows against the JAX
harness's on the JAX export of the same weights, and the strings each
predicts, image by image. The tolerance gates the return value and the exit
code; an Orbax directory is refused.
"""

import json
import os

import pytest

import jax
import jax.numpy as jnp

import tools.parity_eval as jax_harness
from ccd_tpu.builders import build_recognizer as jax_build_recognizer
from ccd_tpu.checkpoints.torch_export import save_recognizer_torch as jax_save_recognizer_torch
from ccd_tpu.config import Config as JaxConfig
import ccd_tpu.evaluation.runner as jax_runner
from ccd_tpu_torch.builders import build_recognizer
from ccd_tpu_torch.checkpoints import save_recognizer_torch
from ccd_tpu_torch.checkpoints.from_jax import recognizer_state_dict_from_jax
from ccd_tpu_torch.cli import parity_eval
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.data.lmdb import LmdbReader, LmdbWriter
from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
from ccd_tpu_torch.evaluation import runner

from _torch_port import one_torch_thread, perturbed_numpy_tree  # noqa: F401

CFG = """
global: {name: parity_test, phase: test, stage: train-supervised, workdir: %s, seed: 0}
dataset:
  scheme: supervised
  train: {roots: [], batch_size: 8}
  test: {roots: [], batch_size: 8}
  num_workers: 2
  charset_type: 'DICT90'
decoder:
  n_layers: 2
  d_embedding: 64
  n_head: 2
  d_model: 64
  d_inner: 64
  d_k: 32
  d_v: 32
  max_seq_len: 8
  start_idx: 91
  padding_idx: 92
arch: 'vit_micro'
patch_size: 4
drop_path_rate: 0.0
compute_dtype: float32
"""
WORDS = 24


def test_canonical_names_match_the_jax_harness():
    cases = {"/data/evaluation/IIIT5k_3000": "IIIT5k", "/data/evaluation/SVTP": "SVTP",
             "/data/evaluation/SVT": "SVT", "/data/evaluation/IC15_1811": "IC15",
             "/data/evaluation/IC13_1015/": "IC13", "cute80": "CUTE80", "/x/COCOText": "COCOText",
             "/x/totaltext": "TotalText", "/x/ctw": "CTW", "/x/HOST": "HOST", "/x/WOST": "WOST",
             "/x/iiit_probe": "IIIT5k", "/x/unknown_set": "unknown_set"}
    for root, want in cases.items():
        assert parity_eval.canonical_name(root) == want == jax_harness.canonical_name(root), root
    assert parity_eval.PUBLISHED == jax_harness.PUBLISHED


def test_discover_roots_matches_the_jax_harness(tmp_path):
    for rel in ("evaluation/IIIT5k_3000", "evaluation/benchmark/SVT", "evaluation/empty/x"):
        os.makedirs(tmp_path / rel)
    for rel in ("evaluation/IIIT5k_3000", "evaluation/benchmark/SVT"):
        (tmp_path / rel / "data.mdb").write_bytes(b"")
    paths = [str(tmp_path / "evaluation"), str(tmp_path / "evaluation" / "IIIT5k_3000")]
    got = parity_eval.discover_roots(paths)
    assert got == jax_harness.discover_roots(paths)
    assert got == [str(tmp_path / "evaluation" / "IIIT5k_3000"),
                   str(tmp_path / "evaluation" / "benchmark" / "SVT"),
                   str(tmp_path / "evaluation" / "IIIT5k_3000")]


def _relabel(src: str, dst: str, labels) -> None:
    """``src``'s images under new labels."""
    with LmdbReader(src) as reader, LmdbWriter(dst) as writer:
        for i, label in enumerate(labels, start=1):
            writer.put(f"image-{i:09d}".encode(), reader.get(f"image-{i:09d}".encode()))
            writer.put(f"label-{i:09d}".encode(), label.encode())
        writer.put(b"num-samples", str(len(labels)).encode())


def _record_predictions(monkeypatch):
    """Both runners' predict functions wrapped to keep what they read, in order."""
    seen = {"port": [], "jax": []}
    for side, module in (("port", runner), ("jax", jax_runner)):
        def make(*args, _make=module.make_predict_fn, _seen=seen[side], **kwargs):
            predict = _make(*args, **kwargs)

            def recording(images):
                texts = predict(images)
                _seen.extend(texts)
                return texts
            return recording
        monkeypatch.setattr(module, "make_predict_fn", make)
    return seen


@pytest.fixture
def recorded(monkeypatch):
    return _record_predictions(monkeypatch)


@pytest.fixture(scope="module")
def harness_setup(tmp_path_factory):
    """The config, two benchmarks, the port's and the JAX package's exports
    of the same weights, and the direct evaluation of the port's model."""
    tmp_path = tmp_path_factory.mktemp("parity")
    with pytest.MonkeyPatch.context() as monkeypatch:
        return _harness_setup(tmp_path, _record_predictions(monkeypatch))


def _harness_setup(tmp_path, recorded):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CFG % str(tmp_path / "workdir"))
    evaluation = tmp_path / "evaluation"
    iiit = str(evaluation / "IIIT5k_3000")
    words = write_synthetic_lmdb(iiit, WORDS, seed=7)

    jconfig = JaxConfig(str(cfg))
    jmodel, _ = jax_build_recognizer(jconfig)
    rng = jax.random.PRNGKey(3)
    tgt = jnp.full((1, jmodel.max_seq_len), jmodel.padding_idx, jnp.int32)
    params = jax.jit(lambda key: jmodel.init({"params": key, "dropout": key},
                                             jnp.zeros((1, 32, 128, 3)), tgt,
                                             train_mode=True))(rng)["params"]
    params = perturbed_numpy_tree(params, seed=8, amount=0.5)
    jax_pth = str(tmp_path / "jax_export.pth")
    jax_save_recognizer_torch(params, jax_pth, iteration=5)

    config = Config(str(cfg))
    model, _ = build_recognizer(config, device="cpu")
    model.load_state_dict(recognizer_state_dict_from_jax(params), strict=True)
    pth = str(tmp_path / "port_export.pth")
    save_recognizer_torch(model, pth, iteration=5, module_prefix=True)

    kwargs = dict(batch_size=8, max_seq_len=8, charset_type="DICT90")
    runner.evaluate_benchmarks(model, [iiit], **kwargs)
    read = list(recorded["port"])
    svt = str(evaluation / "SVT")
    _relabel(iiit, svt, [read[i] if i % 2 == 0 else words[i] for i in range(WORDS)])
    recorded["port"].clear()
    results, weighted = runner.evaluate_benchmarks(model, [iiit, svt], names=["IIIT5k", "SVT"],
                                                   **kwargs)
    direct = {str(r["name"]): 100.0 * float(r["cwr"]) for r in results}
    assert direct["SVT"] >= 50.0  # the relabelled half reads right
    return dict(cfg=str(cfg), evaluation=str(evaluation), pth=pth, jax_pth=jax_pth,
                direct=direct, weighted=weighted, predictions=list(recorded["port"]))


def test_harness_is_bit_identical_to_direct_evaluation(harness_setup, recorded, tmp_path):
    s = harness_setup
    recorded["port"].clear()
    out = str(tmp_path / "parity.json")
    baseline = {k: round(v, 3) for k, v in s["direct"].items()}
    rows, weighted, ok = parity_eval.run_parity_eval(
        s["pth"], [s["evaluation"]], s["cfg"], baseline, tol=0.2, out_path=out, device="cpu")
    assert ok, rows
    assert weighted == s["weighted"]
    assert recorded["port"] == s["predictions"]
    assert [r["benchmark"] for r in rows] == ["IIIT5k", "SVT"]
    assert [r["word_acc_pct"] for r in rows] == [round(s["direct"][n], 3)
                                                 for n in ("IIIT5k", "SVT")]
    artifact = json.load(open(out))
    assert artifact["ok"] and artifact["device"] == {"type": "cpu", "name": "cpu"}
    assert artifact["weighted_acc_pct"] == round(100.0 * s["weighted"], 3)


def test_tolerance_gates_return_value_and_exit_code(harness_setup, tmp_path, capsys):
    s = harness_setup
    baseline = {k: round(v, 3) for k, v in s["direct"].items()}
    moved = dict(baseline, SVT=baseline["SVT"] + 0.5)
    _rows, _weighted, ok = parity_eval.run_parity_eval(
        s["pth"], [s["evaluation"]], s["cfg"], moved, tol=0.2, device="cpu")
    assert not ok
    for name, base, code in (("ok.json", baseline, None), ("moved.json", moved, 1)):
        path = tmp_path / name
        path.write_text(json.dumps(base))
        argv = ["--pth", s["pth"], "--test_root", s["evaluation"], "-c", s["cfg"],
                "--baseline", str(path), "--device", "cpu"]
        if code is None:
            parity_eval.main(argv)
            assert "PARITY OK" in capsys.readouterr().out
        else:
            with pytest.raises(SystemExit) as exit_info:
                parity_eval.main(argv)
            assert exit_info.value.code == code
            assert "PARITY FAIL" in capsys.readouterr().err


def test_jax_harness_gives_the_same_rows(harness_setup, recorded):
    s = harness_setup
    baseline = {k: round(v, 3) for k, v in s["direct"].items()}
    recorded["port"].clear()
    rows, weighted, ok = parity_eval.run_parity_eval(
        s["pth"], [s["evaluation"]], s["cfg"], baseline, device="cpu")
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        jrows, jweighted, jok = jax_harness.run_parity_eval(
            s["jax_pth"], [s["evaluation"]], s["cfg"], baseline)
    finally:  # the JAX harness points the cache next to its config
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert rows == jrows and ok == jok
    assert weighted == jweighted
    assert recorded["port"] == recorded["jax"]


def test_orbax_directory_is_refused(harness_setup, tmp_path):
    s = harness_setup
    orbax = tmp_path / "orbax_ckpt"
    (orbax / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        parity_eval.run_parity_eval(str(orbax), [s["evaluation"]], s["cfg"], {}, device="cpu")
    with pytest.raises(ValueError, match="Orbax"):
        parity_eval.main(["--pth", str(orbax), "--test_root", s["evaluation"], "-c", s["cfg"],
                          "--device", "cpu"])
