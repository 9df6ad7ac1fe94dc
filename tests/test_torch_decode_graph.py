"""The greedy decode's CUDA-graph dispatch and its cache, on the CPU.

A CUDA graph cannot be captured here, so the cache (``utils/cuda_graphs.py::
GraphCache``) is handed a fake capture with the same contract: "capturing"
runs the function once and keeps its output as the static output, a replay
runs it again on the static input and writes the static output in place.
The decoder's own choice (``NRTRDecoder.graphable``) is false for every CPU
tensor, so the dispatch tests force it true. What only the card can show
(the replay equal to the eager decode bit for bit, parameters updated in
place between calls) is ``chip_smoke.py``'s ``decode_graph`` phase.
"""

import copy
import json
import os
import tempfile
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ccd_tpu_torch.models.layers import Dense, uncached_casts
from ccd_tpu_torch.models.nrtr import NRTRDecoder
from ccd_tpu_torch.utils.cuda_graphs import GraphCache
from portbench import harness
from portbench.tracing import SEGMENT, Trace, read_chrome_trace

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

CFG = dict(n_layers=2, d_embedding=64, n_head=2, d_k=32, d_v=32, d_model=64, d_inner=64,
           max_seq_len=6, d_enc=48)


class FakeCapture:
    """``capture(fn, static_in, generators) -> (replay, static_out)``
    without a card (the decode names no generator)."""

    def __init__(self):
        self.captures = self.replays = 0

    def __call__(self, fn, static_in, generators=()):
        self.captures += 1
        static_out = fn(static_in)

        def replay():
            self.replays += 1
            static_out.copy_(fn(static_in))
        return replay, static_out


def _decoder(dtype=torch.float32, seed=0, dropout=0.1):
    dec = NRTRDecoder(**CFG, dtype=dtype, dropout=dropout)
    g = torch.Generator().manual_seed(seed)
    dec.reset_parameters(g)
    with torch.no_grad():  # the biases start at 0: move them so every parameter counts
        for p in dec.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return dec.eval()


def _enc(b=3, seed=1, dtype=torch.float32):
    return torch.randn(b, 16, CFG["d_enc"], generator=torch.Generator().manual_seed(seed)
                       ).to(dtype)


def _today(dec, enc):
    """The greedy decode as it was written before the graph dispatch."""
    enc_kvs, caches, tok, positions = dec._decode_state(enc)
    steps = []
    for t in range(dec.max_seq_len):
        probs, tok = dec._decode_step(tok, t, enc_kvs, caches, positions)
        steps.append(probs)
    return torch.stack(steps, dim=1)


@pytest.fixture
def forced(monkeypatch):
    """A bf16 decoder whose dispatch takes the graph path on the CPU, with a
    fake capture."""
    monkeypatch.setattr(NRTRDecoder, "graphable", lambda self, out_enc: True)
    dec = _decoder(torch.bfloat16)
    fake = FakeCapture()
    dec.decode_graphs = GraphCache("decode_graph", capture=fake)
    return dec, fake


# ------------------------------------------------------------ the eager path

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["eval_no_grad", "train_mode", "grad_enabled"])
def test_eager_path_is_unchanged_bit_for_bit(dtype, mode):
    # training mode draws no dropout without a generator: a decoder without any
    dec = _decoder(dtype, dropout=0.0 if mode == "train_mode" else 0.1)
    enc = _enc(dtype=dtype)
    if mode == "train_mode":
        dec.train()
    with torch.set_grad_enabled(mode == "grad_enabled"):
        out = dec.decode_greedy(enc)
        want = _today(dec, enc)
    assert out.shape == (3, CFG["max_seq_len"], dec.num_classes - 1)
    assert out.dtype == torch.float32
    assert torch.equal(out, want)
    assert len(dec.decode_graphs) == 0 and len(dec.decode_graphs._seen) == 0


def test_graphable_needs_the_card_eval_mode_no_grad_and_no_capture(monkeypatch):
    dec = _decoder()
    with torch.no_grad():
        assert not dec.graphable(_enc())                    # a CPU tensor
    on_card = SimpleNamespace(is_cuda=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with torch.no_grad():
        assert dec.graphable(on_card)
        assert not dec.train().graphable(on_card)           # training mode
    dec.eval()
    with torch.enable_grad():
        assert not dec.graphable(on_card)                   # autograd records
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with torch.no_grad():
        assert not dec.graphable(on_card)                   # a capture under way


# ------------------------------------------------------------ the dispatch

def test_first_call_is_eager_the_second_captures_the_third_replays(forced):
    dec, fake = forced
    encs = [_enc(seed=s, dtype=torch.bfloat16) for s in (1, 2, 3)]
    with torch.no_grad():
        first = dec.decode_greedy(encs[0])
        assert (fake.captures, fake.replays, len(dec.decode_graphs)) == (0, 0, 0)
        assert len(dec.decode_graphs._seen) == 1
        second = dec.decode_greedy(encs[1])
        assert (fake.captures, fake.replays, len(dec.decode_graphs)) == (1, 1, 1)
        assert len(dec.decode_graphs._seen) == 0
        third = dec.decode_greedy(encs[2])
        assert (fake.captures, fake.replays, len(dec.decode_graphs)) == (1, 2, 1)
        for out, enc in zip((first, second, third), encs):  # each its own input's decode
            assert torch.equal(out, _today(dec, enc))


def test_returned_tensor_does_not_alias_the_static_output(forced):
    dec, _ = forced
    a, b, c = (_enc(seed=s, dtype=torch.bfloat16) for s in (1, 2, 3))
    with torch.no_grad():
        dec.decode_greedy(a)
        out_b = dec.decode_greedy(b)
        kept = out_b.clone()
        out_c = dec.decode_greedy(c)
    (_, _, static_out), = dec.decode_graphs._graphs.values()
    assert out_b.data_ptr() != static_out.data_ptr() != out_c.data_ptr()
    assert out_b.data_ptr() != out_c.data_ptr()
    assert torch.equal(out_b, kept)             # the next replay left it as it was
    assert not torch.equal(out_b, out_c)


def test_in_place_updates_keep_the_key_and_reach_the_replay(forced):
    dec, fake = forced
    enc = _enc(dtype=torch.bfloat16)
    with torch.no_grad():
        dec.decode_greedy(enc)
        before = dec.decode_greedy(enc)
        key = dec.graph_key(enc)
        for p in dec.parameters():
            p.mul_(1.5)
        assert dec.graph_key(enc) == key
        after = dec.decode_greedy(enc)
        assert fake.captures == 1 and fake.replays == 2
        assert not torch.equal(after, before)
        assert torch.equal(after, _today(dec, enc))


def test_a_replaced_parameter_a_shape_or_a_dtype_makes_a_new_key():
    dec = _decoder()
    enc = _enc()
    key = dec.graph_key(enc)
    assert dec.graph_key(enc.clone()) == key                       # another tensor, same kind
    assert dec.graph_key(_enc(b=4)) != key                         # shape
    assert dec.graph_key(enc.to(torch.bfloat16)) != key            # dtype
    with torch.inference_mode():
        assert dec.graph_key(enc) != key                           # inference mode
    w = dec.classifier.weight   # kept alive: its address is not reused
    dec.classifier.weight = torch.nn.Parameter(w.detach().clone())  # replaced, same values
    replaced = dec.graph_key(enc)
    assert replaced != key
    table = dec.pos_table
    dec.pos_table = table.clone()                                  # a replaced buffer
    assert dec.graph_key(enc) != replaced


def test_cache_never_holds_more_than_its_bound():
    fake = FakeCapture()
    cache = GraphCache("g", capacity=2, capture=fake)
    fn = lambda x: x * 2 + 1  # noqa: E731
    x = torch.arange(4.0)
    for key in range(5):            # each key twice: seen, then captured
        for _ in range(2):
            assert torch.equal(cache(key, fn, x), fn(x))
            assert len(cache) <= 2
    assert fake.captures == 5 and len(cache) == 2
    assert torch.equal(cache(4, fn, x), fn(x)) and fake.captures == 5   # the newest: a replay
    assert torch.equal(cache(0, fn, x), fn(x))                          # evicted: eager again
    assert fake.captures == 5 and len(cache._seen) == 1
    for key in range(100, 130):     # keys seen once
        cache(key, fn, x)
        assert len(cache._seen) <= 4 * 2
    assert len(cache._seen) == 8
    with pytest.raises(ValueError):
        GraphCache("g", capacity=0)


def test_least_recently_used_graph_goes_first():
    fake = FakeCapture()
    cache = GraphCache("g", capacity=2, capture=fake)
    fn = lambda x: x + 1  # noqa: E731
    x = torch.zeros(2)
    for key in ("a", "a", "b", "b", "a", "c", "c"):  # "a" replayed after "b": "b" goes
        cache(key, fn, x)
    assert list(cache._graphs) == ["a", "c"]


def test_early_stop_never_enters_the_graph_path(forced):
    dec, fake = forced
    enc = _enc(dtype=torch.bfloat16)
    with torch.no_grad():
        for _ in range(3):
            dec.decode_greedy_early_stop(enc)
        assert (len(dec.decode_graphs), len(dec.decode_graphs._seen), fake.captures) == (0, 0, 0)
        dec.decode_greedy(enc)          # the forced dispatch does engage the full decode
    assert len(dec.decode_graphs._seen) == 1


def test_a_copy_of_the_decoder_starts_with_an_empty_cache(forced):
    dec, _ = forced
    enc = _enc(dtype=torch.bfloat16)
    with torch.no_grad():
        dec.decode_greedy(enc)
        dec.decode_greedy(enc)
    twin = copy.deepcopy(dec)
    assert len(dec.decode_graphs) == 1
    assert len(twin.decode_graphs) == 0 and len(twin.decode_graphs._seen) == 0
    assert twin.decode_graphs is not dec.decode_graphs


# ------------------------------------------------------------ the casts

def test_uncached_casts_cast_afresh_once_and_restore_the_outer_cache():
    dec = _decoder(torch.bfloat16)
    dense = dec.classifier
    with torch.no_grad():
        outer = dense.cast_param("weight")
        assert dense.cast_param("weight") is outer          # cached outside
        with uncached_casts(dec):
            inner = dense.cast_param("weight")
            assert inner is not outer and torch.equal(inner, outer)
            assert dense.cast_param("weight") is inner      # once a parameter inside
        assert dense.cast_param("weight") is outer
    denses = [m for m in dec.modules() if isinstance(m, Dense)]
    assert len(denses) == 2 * (4 + 4 + 2) + 1


# ------------------------------------------------------------ the span and its metric

def _ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(SEGMENT):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return read_chrome_trace(events["traceEvents"])


def test_decode_graph_span_surrounds_each_replay_inside_the_decode(forced):
    dec, _ = forced

    def three_calls():
        with torch.no_grad():
            for s in (1, 2, 3):
                dec.decode_greedy(_enc(seed=s, dtype=torch.bfloat16))
    tr = _ranges(three_calls)
    decode = sorted((a, b) for a, b, n in tr.ranges if n == "decode")
    graph = sorted((a, b) for a, b, n in tr.ranges if n == "decode_graph")
    assert len(decode) == 3 and len(graph) == 2     # the eager first call opens none
    for a, b in graph:
        assert any(c <= a and b <= d for c, d in decode[1:])
    reading = SimpleNamespace(trace=tr, window={"metrics": {}}, ctx=None)
    assert harness.reader("decode_graph_share.eval").read(reading) == pytest.approx(200 / 3)


def test_decode_graph_share_reads_nothing_without_graph_spans():
    ranges = [(0.0, 5.0, "decode"), (10.0, 15.0, "decode"), (11.0, 14.0, "decode_graph")]
    tr = Trace(device=[], ranges=ranges, host_ops=[], window=(0.0, 20.0))
    read = harness.reader("decode_graph_share.eval").read
    assert read(SimpleNamespace(trace=tr)) == pytest.approx(50.0)
    tr.ranges = ranges[:2]                   # a program without the span: no number
    assert read(SimpleNamespace(trace=tr)) is None
    tr.ranges = []
    assert read(SimpleNamespace(trace=tr)) is None
