"""The port's one span helper: named ranges in a ``torch.profiler`` trace.

``with span("decode"): ...`` opens a ``torch.profiler.record_function``
range while a profiler records, so the range lands in the same Kineto trace,
on the same clock, as the card's kernels and copies that its code launched;
a trace reader can put device time and idle gaps down to the range whose
host code launched them. With no profiler recording it returns one shared
no-op context: entering a ``record_function`` costs microseconds of host
time even when nothing records, the check below a fraction of one.

A span measures nothing by itself (no host clock is read); the trace holds
its start and end. Spans of one name may nest; readers count their union.
No span goes inside a per-token, per-op or per-sample loop. ``PERF.md`` §3
lists every span with the metric that reads it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records
    on this thread, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
