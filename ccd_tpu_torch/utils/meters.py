"""Training meters (parity: SmoothedValue/MetricLogger,
Dino/modules/utils.py:235-411), as the train CLI uses them, and the
finetune loop's Averager and Timer (Dino/utils/util.py:5-25,
Dino/utils/utils.py:118-157).

Cross-process synchronisation sums each meter's count and total over the
processes (the default ``torch.distributed`` group, as the reference's
``dist.all_reduce``), so ``global_avg`` covers every rank; it is a no-op on
a single process. The windowed values stay local, as in the reference.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np
import torch

from ccd_tpu_torch.parallel.mesh import Group, all_reduce_sum, default_group


class SmoothedValue:
    """Windowed median/avg meter with global total/count."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, group: Group = None) -> None:
        """Sum count and total over ``group`` (default: the default group;
        nothing without one)."""
        group = default_group() if group is None else group
        if group is None:
            return
        t = all_reduce_sum(torch.tensor([self.count, self.total], dtype=torch.float64),
                           group, "meters")
        self.count, self.total = int(t[0]), float(t[1])

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self, group: Group = None) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes(group)

    def __getattr__(self, attr: str):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())


class Averager:
    """Simple running average (Dino/utils/util.py:5-25)."""

    def __init__(self):
        self.reset()

    def add(self, v: float) -> None:
        self.n_count += 1
        self.sum += float(v)

    def reset(self) -> None:
        self.n_count = 0
        self.sum = 0.0

    def val(self) -> float:
        return self.sum / self.n_count if self.n_count else 0.0


class Timer:
    """Data/compute phase timer on the host's clock (Dino/utils/utils.py:118-157).
    A caller that times work on the card synchronises the stream before each
    ``toc_*``."""

    def __init__(self):
        self.data_total_time = 0.0
        self.data_call = 0
        self.running_total_time = 0.0
        self.running_call = 0
        self._t = time.time()

    def tic(self) -> None:
        self._t = time.time()

    def toc_data(self) -> None:
        now = time.time()
        self.data_total_time += now - self._t
        self.data_call += 1
        self._t = now

    def toc_running(self) -> None:
        now = time.time()
        self.running_total_time += now - self._t
        self.running_call += 1
        self._t = now

    def average_data_time(self) -> float:
        return self.data_total_time / (self.data_call or 1)

    def average_running_time(self) -> float:
        return self.running_total_time / (self.running_call or 1)
