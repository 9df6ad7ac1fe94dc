"""The traced segment of a run: ``torch.profiler`` over the CPU and the card,
exported as a Chrome trace into ``TMPDIR`` and read back into plain lists.

What the readers of ``portbench/metrics/`` get (:class:`Trace`):

* ``device``: every operation that ran on the card (kernels, copies, sets)
  as ``(start_us, duration_us, name, launch_us)``; ``launch_us`` is the host
  time of the runtime call that launched it (None where the trace has none);
* ``ranges``: every ``record_function`` range of the host, the program's own
  spans and the benchmark's, as ``(start_us, end_us, name)``;
* ``host_ops``: the host's aten operations as ``(start_us, end_us, name)``;
* ``window``: ``(start_us, end_us)`` of the traced segment.

Busy time is the union of the device intervals, so two overlapping kernels
count once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

SEGMENT = "portbench.traced"       # the range around the traced segment
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    device: List[Tuple[float, float, str, Optional[float]]]
    ranges: List[Tuple[float, float, str]]
    host_ops: List[Tuple[float, float, str]]
    window: Tuple[float, float]
    work: dict = field(default_factory=dict)   # what the segment did: steps, images, batches

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(self.device)) / 1e6

    def device_s(self, name_part: str = "") -> float:
        """Seconds of the device operations whose name holds ``name_part``."""
        return sum(d for _, d, n, _ in self.device if name_part in n) / 1e6

    def count(self, name_part: str) -> int:
        return sum(1 for _, _, n, _ in self.device if name_part in n)

    def device_s_in(self, range_name: str) -> Optional[float]:
        """Seconds of the device operations launched inside a host range
        named ``range_name``; None when the trace holds no such range."""
        spans = sorted((a, b) for a, b, n in self.ranges if n == range_name)
        if not spans:
            return None
        return sum(d for _, d, _, at in self.device
                   if at is not None and _inside(spans, at)) / 1e6

    def host_ops_in(self, range_name: str, op: str) -> Optional[int]:
        """Host operations named ``op`` inside ranges named ``range_name``."""
        spans = sorted((a, b) for a, b, n in self.ranges if n == range_name)
        if not spans:
            return None
        return sum(1 for a, _, n in self.host_ops if n == op and _inside(spans, a))


def _inside(spans: List[Tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of the sorted, non-nested ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def merged(device) -> List[Tuple[float, float]]:
    """The union of the device intervals, sorted."""
    out: List[List[float]] = []
    for a, d, _, _ in sorted(device):
        b = a + d
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_chrome_trace(events: list) -> Trace:
    launches: Dict[int, float] = {}
    device, ranges, host_ops = [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation":
            if name == SEGMENT:
                window = (ts, ts + dur)
            else:
                ranges.append((ts, ts + dur, name))
        elif cat == "cpu_op":
            host_ops.append((ts, ts + dur, name))
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            device.append((float(e["ts"]), float(e.get("dur", 0.0)), e.get("name", ""),
                           launches.get(corr)))
    if window is None:
        raise RuntimeError(f"the trace holds no {SEGMENT!r} range")
    if device:  # the segment ends when its last device operation does
        window = (window[0], max(window[1], max(a + d for a, d, _, _ in device)))
    return Trace(device, ranges, host_ops, window)


def trace(fn: Callable[[], dict]) -> Trace:
    """Run ``fn`` (which returns what it did) under the profiler, the card
    synchronised before and after, and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SEGMENT):
            work = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    out = read_chrome_trace(events["traceEvents"] if isinstance(events, dict) else events)
    out.work = work
    return out


def _innermost(ranges_sorted, t: float) -> str:
    """The name of the shortest host range that holds ``t``."""
    best, best_len = "(no range)", float("inf")
    for a, b, n in ranges_sorted:
        if a > t:
            break
        if b >= t and b - a < best_len:
            best, best_len = n, b - a
    return best


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing: the innermost range around the launch of
    the operation that ended the gap."""
    by_name: Dict[str, float] = defaultdict(float)
    for _, d, n, _ in tr.device:
        by_name[n[:160]] += d / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = merged(tr.device)
    starts = {}
    for a, _, _, at in tr.device:
        if a not in starts or (at is not None and starts[a] is None):
            starts[a] = at
    ranges_sorted = sorted(tr.ranges)
    gaps: Dict[str, float] = defaultdict(float)
    prev_end = tr.window[0]
    for a, b in spans:
        if a > prev_end:
            at = starts.get(a)
            label = _innermost(ranges_sorted, at) if at is not None else "(no launch)"
            gaps[label] += (a - prev_end) / 1e6
        prev_end = max(prev_end, b)
    if tr.window[1] > prev_end:
        gaps["(after the last operation)"] += (tr.window[1] - prev_end) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}
