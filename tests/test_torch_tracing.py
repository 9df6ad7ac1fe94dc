"""The port's spans (``ccd_tpu_torch/utils/tracing.py``) and the benchmark's
readers of them (``portbench/spans.py``, ``portbench/metrics/``).

Without a profiler a span is one shared no-op context. Under
``torch.profiler`` (the CPU's activities here) each span is a
``record_function`` range where the work happens: the recognizer's parts,
the whole greedy decode, the convertor, each flood round of the glyph
clustering and each choose-one chain of the augmentation. The readers are
held to hand-computed values on Chrome-trace events made by hand.
"""

import contextlib
import json
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.synthetic import make_synthetic_batch
from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.ops.cc_label import label_clusters
from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state, make_fused_pretrain_step,
                                                  make_multi_pretrain_step)
from ccd_tpu_torch.utils import tracing
from ccd_tpu_torch.utils.tracing import span
from portbench import harness
from portbench.tracing import SEGMENT, read_chrome_trace

from _torch_port import MICRO_DECODER, one_torch_thread  # noqa: F401 (fixture)

BATCH = 4
SCHEDULE = dict(base_lr=5e-4, min_lr=1e-6, total_iters=100, warmup_iters=1,
                weight_decay=0.04, weight_decay_end=0.4, momentum_teacher=0.99,
                teacher_temps=np.full(10, 0.04, np.float32), clip_grad=3.0,
                freeze_last_layer=0, global_batch=BATCH, imgnet_based=1000)
SPANS = ("backbone", "encoder", "decoder", "decode", "convert", "flood_round", "one_of",
         "augment", "label_clusters")


def _profiled(fn):
    """``fn()`` under the profiler: (its result, {span name: sorted (start,
    end)}) as the benchmark reads them, from the exported Chrome trace (the
    profiler's own event list folds a range into a lone child of its name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(SEGMENT):
            out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    ranges = {}
    for a, b, name in read_chrome_trace(events["traceEvents"]).ranges:
        if name in SPANS:
            ranges.setdefault(name, []).append((a, b))
    return out, {k: sorted(v) for k, v in ranges.items()}


def _within(inner, outer) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def _recognizer():
    model = CCDRecognizer(arch="vit_micro", **MICRO_DECODER)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _pretrain_state(seed: int = 0):
    student = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=True,
                               norm_last_layer=False, drop_path_rate=0.1)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=False)
    g = torch.Generator().manual_seed(seed)
    student.reset_parameters(g)
    teacher.reset_parameters(g)
    return init_pretrain_state(student, teacher, seed=seed)


def _raw(k: int, seed: int = 0):
    images, masks, _ = make_synthetic_batch(k * BATCH, seed=seed)
    return (torch.from_numpy(images).reshape(k, BATCH, 32, 128, 3),
            torch.from_numpy(masks.astype(np.uint8)).reshape(k, BATCH, 32, 128))


# ------------------------------------------------------------ the helper

def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = span("decode")
    assert off is span("one_of") is tracing._OFF
    assert isinstance(off, contextlib.nullcontext)
    with off, span("decode"):  # re-entrant, and records nothing
        pass
    _, ranges = _profiled(lambda: None)
    assert ranges == {}


def test_span_under_a_profiler_is_a_range():
    def body():
        with span("decode"):
            with span("decode"):  # a nested span of the same name is its own range
                torch.ones(2) + 1
    _, ranges = _profiled(body)
    assert len(ranges["decode"]) == 2
    assert _within(ranges["decode"][1], ranges["decode"][:1])
    assert span("decode") is tracing._OFF  # off again once the profiler stops


# ---------------------------------------------------- the program's spans

def test_recognizer_eval_forward_spans_its_parts_and_the_decode():
    model = _recognizer().eval()
    images = torch.rand(2, 32, 128, 3)
    with torch.no_grad():
        probs, ranges = _profiled(lambda: model(images, train_mode=False))
    assert probs.shape == (2, MICRO_DECODER["max_seq_len"], 92)
    assert {k: len(v) for k, v in ranges.items()} == {"backbone": 1, "encoder": 1, "decode": 1}
    (b0, b1), (e0, e1), (d0, d1) = ranges["backbone"][0], ranges["encoder"][0], \
        ranges["decode"][0]
    assert b1 <= e0 and e1 <= d0  # backbone, then encoder, then the whole decode


def test_recognizer_test_speed_decode_is_one_span():
    model = _recognizer().eval()
    with torch.no_grad():
        _, ranges = _profiled(lambda: model(torch.rand(2, 32, 128, 3), train_mode=False,
                                            test_speed=True))
    assert len(ranges["decode"]) == 1


def test_recognizer_train_forward_spans_the_teacher_forced_decoder():
    model = _recognizer().train()
    targets = torch.randint(0, 90, (2, MICRO_DECODER["max_seq_len"]))
    (logits, _), ranges = _profiled(
        lambda: model(torch.rand(2, 32, 128, 3), targets, train_mode=True,
                      generator=torch.Generator().manual_seed(1)))
    assert logits.shape[:2] == targets.shape
    assert {k: len(v) for k, v in ranges.items()} == {"backbone": 1, "encoder": 1,
                                                      "decoder": 1}


def test_convertor_spans_its_host_work():
    convertor = AttnConvertor("DICT90", max_seq_len=6)
    scores = np.random.default_rng(0).random((3, 6, convertor.num_classes() - 1))

    def convert():
        indexes, _ = convertor.tensor2idx(scores)
        return convertor.idx2str(indexes)

    strings, ranges = _profiled(convert)
    assert len(strings) == 3
    assert len(ranges["convert"]) == 2  # tensor2idx, then idx2str


def test_label_clusters_returns_its_flood_rounds():
    masks = np.zeros((2, 32, 128), np.float32)
    for r in range(0, 30, 2):  # a serpentine: many rounds to flood
        masks[0, r, 2:126] = 1.0
        masks[0, r + 1, 2 if (r // 2) % 2 else 125] = 1.0
    masks[1, 5:20, 10:30] = 1.0
    (clusters, rounds), ranges = _profiled(lambda: label_clusters(torch.from_numpy(masks)))
    assert clusters.shape == (2, 26, 32, 128)
    assert isinstance(rounds, int) and rounds > 2
    assert len(ranges["flood_round"]) == rounds
    assert not hasattr(label_clusters, "rounds")


def test_multi_pretrain_step_reports_each_steps_flood_rounds():
    raws, masks = _raw(2, seed=3)
    step = make_multi_pretrain_step(**SCHEDULE)
    (_, metrics), ranges = _profiled(lambda: step(_pretrain_state(), raws, masks))
    rounds = metrics["cluster_rounds"]
    assert rounds.shape == (2,) and rounds.device.type == "cpu"
    clusters = ranges["label_clusters"]
    assert len(clusters) == 2
    per_step = [sum(1 for r in ranges["flood_round"] if _within(r, [c])) for c in clusters]
    assert rounds.tolist() == per_step
    assert sum(per_step) == len(ranges["flood_round"])


def test_every_one_of_lies_inside_the_augment_span():
    raws, masks = _raw(1, seed=4)
    step = make_fused_pretrain_step(**SCHEDULE)
    _, ranges = _profiled(lambda: step(_pretrain_state(), raws[0], masks[0]))
    assert len(ranges["augment"]) == 1 and ranges["one_of"]
    assert all(_within(r, ranges["augment"]) for r in ranges["one_of"])


# ------------------------------------------------------- the readers

def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts):
    return _event("cuda_runtime", "cudaLaunchKernel", ts, 5.0, corr)


def _kernel(corr, ts, dur):
    return _event("kernel", f"k{corr}", ts, dur, corr)


def _hand_trace():
    """Two batches (or steps) in 10 ms, and what each reader should find:

    * decode, 100-1100 and 5100-6100 us: 2 ms of host time; launches at 200
      and 300 us and one at 5200 us that put two operations on the card (a
      graph replay): 3 host calls;
    * convert, 1200-1500 and 1500-1600 (adjacent) and 6200-6500: 0.7 ms;
    * five flood_round ranges;
    * one_of, 1900-3000 with another one_of nested at 2100-2500, and
      7000-7500: operations launched at 2000 (100 us), 2200 (40 us, inside
      both) and 7100 (60 us) make 0.2 ms; the one launched at 8000 is outside.
    """
    ann = "user_annotation"
    events = [_event(ann, SEGMENT, 0.0, 10000.0)]
    events += [_event(ann, "decode", a, 1000.0) for a in (100.0, 5100.0)]
    events += [_event(ann, "convert", a, d) for a, d in ((1200.0, 300.0), (1500.0, 100.0),
                                                         (6200.0, 300.0))]
    events += [_event(ann, "flood_round", 3000.0 + 100.0 * i, 50.0) for i in range(5)]
    events += [_event(ann, "one_of", a, d) for a, d in ((1900.0, 1100.0), (2100.0, 400.0),
                                                        (7000.0, 500.0))]
    events += [_launch(c, t) for c, t in ((1, 200.0), (2, 300.0), (3, 5200.0), (4, 2000.0),
                                          (5, 2200.0), (6, 7100.0), (7, 8000.0))]
    events += [_kernel(1, 400.0, 50.0), _kernel(2, 500.0, 30.0), _kernel(3, 5300.0, 10.0),
               _kernel(3, 5310.0, 20.0), _kernel(4, 2100.0, 100.0), _kernel(5, 2300.0, 40.0),
               _kernel(6, 7200.0, 60.0), _kernel(7, 8100.0, 1000.0)]
    return events


def _reading(events):
    tr = read_chrome_trace(events)
    tr.work = {"batches": 2, "steps": 2, "images": 8}
    return SimpleNamespace(trace=tr, window={"metrics": {}}, ctx=None)


READINGS = {"decode_host_ms.eval": 1.0, "decode_launches.eval": 1.5,
            "convert_host_ms.eval": 0.35, "cluster_rounds.pretrain": 2.5,
            "one_of_ms.train": 0.1}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_a_hand_made_trace(name):
    assert harness.reader(name).read(_reading(_hand_trace())) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_without_its_span_gives_none(name):
    events = [e for e in _hand_trace() if e["cat"] != "user_annotation" or e["name"] == SEGMENT]
    assert harness.reader(name).read(_reading(events)) is None
