"""The port's evaluation CLI and runner against the JAX package's runner on
the same synthetic LMDB and the same (converted) weights, and the port's
copies of the JAX-free modules against their originals.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccd_tpu.builders as jax_builders
import ccd_tpu.charsets as jax_charsets
import ccd_tpu.config as jax_config
from ccd_tpu.checkpoints.torch_export import save_recognizer_torch
from ccd_tpu.convertor import AttnConvertor as JaxAttnConvertor
from ccd_tpu.data.synthetic import write_synthetic_lmdb as jax_write_synthetic_lmdb
from ccd_tpu.evaluation.accuracy import TextAccuracy as JaxTextAccuracy
from ccd_tpu.evaluation.editdistance import levenshtein as jax_levenshtein
from ccd_tpu.evaluation.runner import evaluate_benchmarks as jax_evaluate_benchmarks

import ccd_tpu_torch
import ccd_tpu_torch.charsets as charsets
from ccd_tpu_torch.cli import evaluate as cli
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
from ccd_tpu_torch.evaluation.accuracy import TextAccuracy
from ccd_tpu_torch.evaluation.editdistance import levenshtein

from _torch_port import perturbed_numpy_tree, to_jnp

SMOKE_YAML = os.path.join(os.path.dirname(ccd_tpu_torch.__file__), "configs",
                          "smoke_finetune.yaml")
METRICS = ("cwr", "ccr", "ned", "ted", "words")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX recognizer of the port's smoke config, its weights as a reference
    ``.pth`` for the CLI's --checkpoint."""
    jmodel, _ = jax_builders.build_recognizer(jax_config.Config(SMOKE_YAML))
    rng = jax.random.PRNGKey(0)
    img = jnp.zeros((1, 32, 128, 3))
    tgt = jnp.full((1, 25), jmodel.padding_idx, jnp.int32)
    params = jmodel.init({"params": rng, "dropout": rng}, img, tgt, train_mode=True)["params"]
    tree = perturbed_numpy_tree(params, seed=11, amount=0.02)
    tree["decoder"]["classifier"]["kernel"] = tree["decoder"]["classifier"]["kernel"] * 20.0
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "smoke.pth")
    save_recognizer_torch(tree, ckpt)
    return jmodel, to_jnp(tree), ckpt


def _compare(res, jres):
    for k in METRICS:
        assert res[k] == pytest.approx(jres[k], abs=1e-9), k


def test_cli_matches_jax_runner(jax_side, capsys):
    jmodel, jparams, ckpt = jax_side
    results, weighted = cli.main(["-c", SMOKE_YAML, "--synthetic", "32", "--batch_size", "8",
                                  "--device", "cpu", "--checkpoint", ckpt])
    printed = capsys.readouterr().out
    assert "dataset: SYNTH --> word_num: 32 --> accuracy:" in printed
    assert f"total_accuracy: {weighted:0.3f}" in printed
    root = results[0]["name"]  # the LMDB the CLI generated
    jresults, jweighted = jax_evaluate_benchmarks(jmodel, jparams, [root], batch_size=8,
                                                  num_workers=1)
    assert results[0]["words"] == 32
    _compare(results[0], jresults[0])
    assert weighted == pytest.approx(jweighted, abs=1e-9)
    assert results[0]["ned"] > 0  # random weights: the comparison is of real distances


def test_ragged_last_batch_matches_jax_runner(jax_side, tmp_path):
    """20 images at batch 8: the last batch holds 4. The port decodes it as it
    is; the JAX runner pads it to 8 and slices."""
    from ccd_tpu_torch.builders import build_recognizer, load_recognizer_params
    from ccd_tpu_torch.evaluation.runner import evaluate_benchmarks
    jmodel, jparams, ckpt = jax_side
    root = str(tmp_path / "evaluation" / "RAGGED")
    words = write_synthetic_lmdb(root, 20, seed=9)
    model, _ = build_recognizer(Config(SMOKE_YAML), device="cpu")
    load_recognizer_params(ckpt, model)
    results, weighted = evaluate_benchmarks(model, [root], batch_size=8, num_workers=2)
    jresults, jweighted = jax_evaluate_benchmarks(jmodel, jparams, [root], batch_size=8,
                                                  num_workers=1)
    assert results[0]["words"] == len(words) == 20
    _compare(results[0], jresults[0])
    # and the batching does not change the port's own answer
    whole, _ = evaluate_benchmarks(model, [root], batch_size=20, num_workers=1)
    _compare(results[0], whole[0])


def test_synthetic_lmdb_copies_write_the_same_data(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert write_synthetic_lmdb(a, 6, seed=4) == jax_write_synthetic_lmdb(b, 6, seed=4)
    from ccd_tpu.data.lmdb import LmdbReader as JaxReader
    from ccd_tpu_torch.data.lmdb import LmdbReader
    ra, rb = LmdbReader(a), JaxReader(b)
    for key in (b"num-samples", b"image-000000003", b"label-000000006"):
        assert ra.get(key) == rb.get(key)


def _random_strings(rng, n, alphabet):
    return ["".join(rng.choice(list(alphabet), size=rng.integers(0, 12))) for _ in range(n)]


def test_charsets_copy_agrees():
    assert set(charsets.DICTS) == set(jax_charsets.DICTS)
    for name in charsets.DICTS:
        assert list(charsets.DICTS[name]) == list(jax_charsets.DICTS[name]), name


def test_convertor_copy_agrees():
    rng = np.random.default_rng(0)
    strings = _random_strings(rng, 40, "abcXYZ019!?- é")
    a = AttnConvertor("DICT90", max_seq_len=10, with_unknown=True)
    b = JaxAttnConvertor("DICT90", max_seq_len=10, with_unknown=True)
    assert (a.num_classes(), a.start_idx, a.padding_idx) == \
        (b.num_classes(), b.start_idx, b.padding_idx) == (93, 91, 92)
    np.testing.assert_array_equal(a.str2tensor(strings), b.str2tensor(strings))
    probs = rng.random(size=(5, 10, 92)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    ia, sa = a.tensor2idx(probs)
    ib, sb = b.tensor2idx(probs)
    assert ia == ib and sa == sb
    assert a.idx2str(ia) == b.idx2str(ib)


def test_editdistance_and_accuracy_copies_agree():
    rng = np.random.default_rng(1)
    gts = _random_strings(rng, 60, "abcdEF12 -")
    preds = _random_strings(rng, 60, "abcdEF12 -")
    for g, p in zip(gts, preds):
        assert levenshtein(g, p) == jax_levenshtein(g, p)
    for case_sensitive in (False, True):
        a, b = TextAccuracy(case_sensitive), JaxTextAccuracy(case_sensitive)
        a.update(preds, gts)
        b.update(preds, gts)
        ra, rb = a.result(), b.result()
        assert {k: ra[k] for k in METRICS} == {k: rb[k] for k in METRICS}


def test_accuracy_sync_is_single_process_only(monkeypatch):
    """One process: a no-op. Under a group (data parallelism) the counters
    are summed over the ranks and the inference time is their largest: here
    through stand-in collectives for a second rank that counted the same
    words and took 3 s (two real gloo processes:
    tests/test_torch_parallel_cli.py)."""
    import ccd_tpu_torch.evaluation.accuracy as accuracy_mod
    acc = TextAccuracy()
    acc.update(["ab", "cd"], ["ab", "ce"])
    acc.inference_time = 1.0
    before = acc.result()
    acc.synchronize_between_processes()  # one process: no-op
    assert acc.result() == before
    monkeypatch.setattr(accuracy_mod, "all_reduce_sum", lambda t, group, what: t.mul_(2))
    monkeypatch.setattr(accuracy_mod, "all_reduce_max",
                        lambda t, group, what: t.clamp_min_(3.0))
    acc.synchronize_between_processes(group=object())
    after = acc.result()
    assert after["words"] == 4 and after["ted"] == 2 * before["ted"]
    assert after["cwr"] == before["cwr"] == 0.5 and after["ccr"] == before["ccr"]
    assert after["time"] == 3.0
