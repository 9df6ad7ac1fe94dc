"""Replaying a function of one tensor as a captured CUDA graph, one graph a key.

A loop of small eager kernels is paced by the host's issue (~40 µs a launch
on the card's host) long before the card is busy; replaying it as one
``torch.cuda.CUDAGraph`` costs one launch. :class:`GraphCache` decides per
call from its key alone: a key's first call runs the function eagerly, its
second captures it and replays the capture, later calls replay. So a shape
seen once (a ragged last batch) never pays a capture.

What a replay may rely on, and the cache keeps true:

* it reads its input from a static tensor outside the graphs' memory pool,
  which the call fills first, and every other tensor it reads is written
  earlier in the same replay or lies outside the pool (the caller's
  parameters, whose addresses belong in the key, and tables that are never
  freed, as ``utils/device.py::device_constant``'s);
* its output, a tensor or a tuple of tensors, is cloned right after the
  replay on the same stream, so every call returns tensors of its own and no
  caller holds the static output. That is also why all graphs of one cache
  may share one memory pool and replay in any order: what one replay leaves
  in the pool, no other reads;
* it draws random numbers only from the generators the call names, which
  are registered on its graph: a replay draws from each generator's state
  at that moment and advances it as the eager call would, and the capture
  draws nothing net, so eager calls, captures and replays of a key draw one
  stream of numbers.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Sequence, Tuple, Union

import torch

from ccd_tpu_torch.utils.tracing import span

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
Replay = Callable[[], None]
Capture = Callable[[Callable[[torch.Tensor], Outputs], torch.Tensor, Sequence[torch.Generator]],
                   Tuple[Replay, Outputs]]


class CudaGraphCapture:
    """``capture(fn, static_in, generators=()) -> (replay, static_out)``:
    ``fn(static_in)`` run once eagerly on the capture stream (cuBLAS handles
    and workspaces are made per stream, and nothing may be made during a
    capture), then captured as a ``torch.cuda.CUDAGraph``. Each generator
    is registered on the graph before the capture, and its state is put
    back after the eager run, so that neither the run nor the capture
    leaves a draw behind. Every graph of one instance allocates from one
    memory pool. Other threads' CUDA calls do not break the capture
    (``capture_error_mode="thread_local"``): a loader's pin-memory thread
    may be running."""

    def __init__(self):
        self._pool = None
        self._streams = {}

    def __call__(self, fn, static_in: torch.Tensor, generators: Sequence[torch.Generator] = ()):
        device = static_in.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.device(device):
            states = [g.get_state() for g in generators]
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                fn(static_in)
            for g, state in zip(generators, states):
                g.set_state(state)
            torch.cuda.current_stream().wait_stream(stream)
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                static_out = fn(static_in)
        return graph.replay, static_out


def _clone(out: Outputs) -> Outputs:
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


class GraphCache:
    """``cache(key, fn, x, generators=())``: ``fn(x)``, eagerly on the key's
    first call, from a captured graph from its second on (see the module's
    docstring).

    ``key`` must tell apart every call that would capture another graph: the
    input's shape, dtype and device, the address of every tensor outside
    the input that ``fn`` reads, and every generator it draws from, which
    the call names in ``generators``. It holds at most ``capacity`` graphs,
    and remembers at most ``4 * capacity`` keys seen once, dropping the
    least recently used. A ``span_name`` span surrounds each replay with its
    input copy and output clone. ``capture`` is :class:`CudaGraphCapture`
    unless a test hands in another with the same contract."""

    def __init__(self, span_name: str, capacity: int = 4, capture: Capture = None):
        if capacity < 1:
            raise ValueError(f"capacity must be at least 1, got {capacity}")
        self.span_name = span_name
        self.capacity = capacity
        self.capture = CudaGraphCapture() if capture is None else capture
        self._seen: "OrderedDict[Hashable, None]" = OrderedDict()
        self._graphs: "OrderedDict[Hashable, tuple]" = OrderedDict()

    def __len__(self) -> int:
        """The graphs held."""
        return len(self._graphs)

    def __deepcopy__(self, memo):
        # a copy of the module owning this cache has tensors of its own: its
        # graphs would read the original's
        return GraphCache(self.span_name, self.capacity)

    def __call__(self, key: Hashable, fn: Callable[[torch.Tensor], Outputs], x: torch.Tensor,
                 generators: Sequence[torch.Generator] = ()) -> Outputs:
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
        elif key in self._seen:
            del self._seen[key]
            static_in = x.clone()
            entry = (static_in,) + tuple(self.capture(fn, static_in, tuple(generators)))
            self._graphs[key] = entry
            while len(self._graphs) > self.capacity:
                self._graphs.popitem(last=False)
        else:
            self._seen[key] = None
            while len(self._seen) > 4 * self.capacity:
                self._seen.popitem(last=False)
            return fn(x)
        static_in, replay, static_out = entry
        with span(self.span_name):
            static_in.copy_(x)
            replay()
            return _clone(static_out)
