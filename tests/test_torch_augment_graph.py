"""The augmentation's CUDA-graph dispatch (``data/augment.py::graphed_augment``)
and its cache, on the CPU.

A CUDA graph cannot be captured here, so the cache is handed a fake capture
that keeps a graph's contract with its generators: "capturing" runs the
function once and puts each generator's state back (a capture draws nothing
net), a replay runs it again on the static input, drawing from each
generator's state at that moment, and writes the static output in place.
``_graphable`` is false for every CPU tensor, so the dispatch tests force it
true. What only the card can show (a replay drawing what eager code draws,
bit for bit) is ``chip_smoke.py``'s ``augment_graph`` phase.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ccd_tpu_torch.data import augment
from ccd_tpu_torch.data.augment import (abinet_augment, graphed_augment, pretrain_views,
                                        supervised_augment)
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.data.synthetic import make_synthetic_batch
from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.training.finetune_step import (_augment_normalize, init_finetune_state,
                                                  make_multi_finetune_step)
from ccd_tpu_torch.training.pretrain_step import init_pretrain_state, make_multi_pretrain_step
from ccd_tpu_torch.utils import cuda_graphs
from ccd_tpu_torch.utils.cuda_graphs import GraphCache
from portbench import harness
from portbench.tracing import Trace

from _torch_port import MICRO_DECODER, one_torch_thread  # noqa: F401 (fixture)

SEED = 2_718_281_828  # wider than 31 bits, as a run's seeds are
CHAINS = {"pretrain_views_severity_5": (pretrain_views, (5,)),
          "supervised_augment": (_augment_normalize, (supervised_augment,))}


class FakeCapture:
    """``capture(fn, static_in, generators) -> (replay, static_out)`` without
    a card, with a CUDA graph's contract with ``generators``."""

    def __init__(self):
        self.captures = self.replays = 0
        self.generators = []

    def __call__(self, fn, static_in, generators=()):
        self.captures += 1
        self.generators.append(tuple(generators))
        states = [g.get_state() for g in generators]
        static_out = fn(static_in)
        for g, state in zip(generators, states):
            g.set_state(state)

        def replay():
            self.replays += 1
            out = fn(static_in)
            for dst, src in zip(_tuple(static_out), _tuple(out)):
                dst.copy_(src)
        return replay, static_out


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _assert_equal(out, want):
    assert len(_tuple(out)) == len(_tuple(want))
    for a, b in zip(_tuple(out), _tuple(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _gen(seed: int = SEED) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _images(n: int, b: int = 2, seed: int = 0):
    """``n`` batches of ``b`` rendered words in [0, 1], all different."""
    images, _, _ = make_synthetic_batch(n * b, seed=seed)
    return list(torch.from_numpy(images).float().div(255.0).reshape(n, b, 32, 128, 3))


@pytest.fixture
def forced(monkeypatch):
    """The graph path on the CPU: every input graphable, and every cache
    made from now on (the steps' too) captures with one fake."""
    monkeypatch.setattr(augment, "_graphable", lambda images: True)
    fake = FakeCapture()
    monkeypatch.setattr(cuda_graphs, "CudaGraphCapture", lambda: fake)
    return fake


# ------------------------------------------------------------ the entry

@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_graphed_calls_equal_eager_calls_and_leave_the_generator_where_they_do(forced, chain):
    fn, args = CHAINS[chain]
    graphs = GraphCache("augment_graph")
    g, g_eager = _gen(), _gen()
    for i, x in enumerate(_images(4)):
        out = graphed_augment(graphs, g, x, fn, *args)
        _assert_equal(out, fn(TorchKey(g_eager), x, *args))
        assert torch.equal(g.get_state(), g_eager.get_state()), f"call {i}"
    # eager, capture and replay, replay, replay
    assert (forced.captures, forced.replays, len(graphs)) == (1, 3, 1)
    assert forced.generators == [(g,)]


def test_a_restored_state_continues_the_eager_stream(forced):
    fn, args = CHAINS["pretrain_views_severity_5"]
    graphs = GraphCache("augment_graph")
    g, g_eager = _gen(), _gen()
    xs = _images(4)
    for x in xs[:2]:                           # eager, then captured
        graphed_augment(graphs, g, x, fn, *args)
    resumed = _gen(SEED + 1).get_state()       # a checkpoint's state
    g.set_state(resumed)
    g_eager.set_state(resumed)
    for x in xs[2:]:
        _assert_equal(graphed_augment(graphs, g, x, fn, *args), fn(TorchKey(g_eager), x, *args))
        assert torch.equal(g.get_state(), g_eager.get_state())
    assert (forced.captures, forced.replays) == (1, 3)


def test_shape_severity_aug_fn_and_generator_each_make_a_new_key(forced):
    graphs = GraphCache("augment_graph", capacity=8)
    g1, g2 = _gen(1), _gen(2)
    x, = _images(1)
    x3, = _images(1, b=3)
    calls = [(g1, x, pretrain_views, 5), (g1, x3, pretrain_views, 5),
             (g1, x, pretrain_views, 2), (g2, x, pretrain_views, 5),
             (g1, x, _augment_normalize, supervised_augment),
             (g1, x, _augment_normalize, abinet_augment)]
    for g, images, chain, arg in calls:
        graphed_augment(graphs, g, images, chain, arg)
    assert len(graphs._seen) == len(calls) and forced.captures == 0
    for g, images, chain, arg in calls:      # each key's second call captures its own graph
        graphed_augment(graphs, g, images, chain, arg)
    assert forced.captures == len(calls) and len(graphs) == len(calls)
    graphed_augment(graphs, g1, x.clone(), pretrain_views, 5)   # another tensor, same key
    assert forced.captures == len(calls) and forced.replays == len(calls) + 1


def test_cpu_tensors_run_eagerly_and_never_enter_the_cache():
    fake = FakeCapture()
    graphs = GraphCache("augment_graph", capture=fake)
    g, g_eager = _gen(), _gen()
    for x in _images(3):
        out = graphed_augment(graphs, g, x, pretrain_views, 5)
        _assert_equal(out, pretrain_views(TorchKey(g_eager), x, 5))
    assert torch.equal(g.get_state(), g_eager.get_state())
    assert (len(graphs), len(graphs._seen), fake.captures) == (0, 0, 0)


def test_graphable_needs_the_card_and_no_capture(monkeypatch):
    assert not augment._graphable(torch.zeros(1, 32, 128, 3))       # a CPU tensor
    on_card = SimpleNamespace(is_cuda=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert augment._graphable(on_card)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not augment._graphable(on_card)                          # a capture under way


def test_tuple_outputs_are_clones_and_never_alias_the_static_outputs(forced):
    graphs = GraphCache("augment_graph")
    g = _gen()
    a, b, c = _images(3)
    graphed_augment(graphs, g, a, pretrain_views, 5)
    out_b = graphed_augment(graphs, g, b, pretrain_views, 5)
    kept = tuple(t.clone() for t in out_b)
    out_c = graphed_augment(graphs, g, c, pretrain_views, 5)
    (_, _, static_out), = graphs._graphs.values()
    assert isinstance(static_out, tuple) and len(static_out) == len(out_b) == 2   # views, theta
    for got_b, got_c, static in zip(out_b, out_c, static_out):
        assert len({got_b.data_ptr(), got_c.data_ptr(), static.data_ptr()}) == 3
    _assert_equal(out_b, kept)                # the next replay left it as it was
    assert not torch.equal(out_b[0], out_c[0])


# ------------------------------------------------------------ the steps

def _recognizer():
    model = CCDRecognizer(arch="vit_micro", drop_path_rate=0.0, decoder_dropout=0.0,
                          encoder_drop=0.0, **MICRO_DECODER)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _pretrain_models():
    student = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=True,
                               norm_last_layer=False, drop_path_rate=0.1)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=False)
    g = torch.Generator().manual_seed(0)
    student.reset_parameters(g)
    teacher.reset_parameters(g)
    return student, teacher


FINETUNE = dict(base_lr=1e-3, min_lr=1e-5, total_iters=20, warmup_iters=2, weight_decay=0.05,
                clip_grad=0.5)
PRETRAIN = dict(base_lr=5e-4, min_lr=1e-6, total_iters=100, warmup_iters=1, weight_decay=0.04,
                weight_decay_end=0.4, momentum_teacher=0.99,
                teacher_temps=np.full(10, 0.04, np.float32), clip_grad=3.0,
                freeze_last_layer=0, global_batch=2, imgnet_based=1000)


def _raw(k: int, seed: int):
    images, masks, words = make_synthetic_batch(k * 2, seed=seed)
    return (torch.from_numpy(images).reshape(k, 2, 32, 128, 3),
            torch.from_numpy(masks.astype(np.uint8)).reshape(k, 2, 32, 128), words)


def test_finetune_steps_through_the_graph_equal_eager_steps(monkeypatch):
    raws, _, _ = _raw(3, seed=7)
    targets = torch.randint(0, 90, (3, 2, MICRO_DECODER["max_seq_len"]),
                            generator=torch.Generator().manual_seed(1), dtype=torch.int64)
    step = make_multi_finetune_step(aug_fn=supervised_augment, **FINETUNE)
    eager, m_eager = step(init_finetune_state(_recognizer(), seed=SEED), raws, targets)
    monkeypatch.setattr(augment, "_graphable", lambda images: True)
    fake = FakeCapture()
    monkeypatch.setattr(cuda_graphs, "CudaGraphCapture", lambda: fake)
    step = make_multi_finetune_step(aug_fn=supervised_augment, **FINETUNE)
    graphed, m_graphed = step(init_finetune_state(_recognizer(), seed=SEED), raws, targets)
    assert (fake.captures, fake.replays) == (1, 2)
    assert m_graphed["loss"].tolist() == m_eager["loss"].tolist()
    assert torch.equal(graphed.aug_generator.get_state(), eager.aug_generator.get_state())
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)


def test_pretrain_steps_through_the_graph_equal_eager_steps(monkeypatch):
    raws, masks, _ = _raw(3, seed=8)
    step = make_multi_pretrain_step(**PRETRAIN)
    eager, m_eager = step(init_pretrain_state(*_pretrain_models(), seed=SEED), raws, masks)
    monkeypatch.setattr(augment, "_graphable", lambda images: True)
    fake = FakeCapture()
    monkeypatch.setattr(cuda_graphs, "CudaGraphCapture", lambda: fake)
    step = make_multi_pretrain_step(**PRETRAIN)
    graphed, m_graphed = step(init_pretrain_state(*_pretrain_models(), seed=SEED), raws, masks)
    assert (fake.captures, fake.replays) == (1, 2)
    for key in ("loss", "mask_loss", "dino_loss"):
        assert m_graphed[key].tolist() == m_eager[key].tolist()
    assert torch.equal(graphed.aug_generator.get_state(), eager.aug_generator.get_state())
    assert torch.equal(graphed.center, eager.center)


# ------------------------------------------------------------ the metric

def test_augment_graph_share_reads_nothing_without_graph_spans():
    ranges = [(0.0, 5.0, "augment"), (10.0, 15.0, "augment"), (11.0, 14.0, "augment_graph")]
    tr = Trace(device=[], ranges=ranges, host_ops=[], window=(0.0, 20.0))
    read = harness.reader("augment_graph_share.train").read
    assert read(SimpleNamespace(trace=tr)) == pytest.approx(50.0)
    tr.ranges = ranges[:2]                   # a program without the span: no number
    assert read(SimpleNamespace(trace=tr)) is None
    tr.ranges = []
    assert read(SimpleNamespace(trace=tr)) is None
