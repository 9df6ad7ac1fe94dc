"""What the readers of the program's own spans share.

The program opens its spans through ``ccd_tpu_torch/utils/tracing.py::span``:
``record_function`` ranges, which the traced segment holds in
``Trace.ranges``. Spans of one name may nest (a ``one_of`` inside another
chain's ``one_of``), so every reading here is over the union of the name's
ranges, and a device operation counts where its launch (``launch_us``) lies
in that union. Each function returns None where the trace holds no range of
the name, as with a program that opens no such span.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.tracing import Trace, _inside


def union(tr: Trace, name: str) -> List[Tuple[float, float]]:
    """The union of the ranges named ``name``, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted((a, b) for a, b, n in tr.ranges if n == name):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def launched(tr: Trace, name: str) -> Optional[list]:
    """The device operations launched inside the union of ``name``."""
    spans = union(tr, name)
    if not spans:
        return None
    return [op for op in tr.device if op[3] is not None and _inside(spans, op[3])]


def device_ms(tr: Trace, name: str) -> Optional[float]:
    """Device ms of the operations launched inside ``name``."""
    ops = launched(tr, name)
    return None if ops is None else sum(d for _, d, _, _ in ops) / 1e3


def launches(tr: Trace, name: str) -> Optional[int]:
    """Host calls that put work on the card inside ``name``: the distinct
    launch times of its device operations (a graph replay counts once)."""
    ops = launched(tr, name)
    return None if ops is None else len({at for _, _, _, at in ops})


def host_ms(tr: Trace, name: str) -> Optional[float]:
    """Host ms inside the union of ``name``."""
    spans = union(tr, name)
    return sum(b - a for a, b in spans) / 1e3 if spans else None


def count(tr: Trace, name: str) -> Optional[int]:
    """The ranges named ``name``."""
    n = sum(1 for _, _, m in tr.ranges if m == name)
    return n or None


def per(value, reading, unit: str) -> Optional[float]:
    """``value`` over the traced segment's ``unit`` (steps, batches)."""
    n = reading.trace.work.get(unit)
    return None if value is None or not n else value / n
