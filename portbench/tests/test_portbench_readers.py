"""The per-layer readers on a trace made by hand: what each reads, and that
a trace with nothing to read gives no number."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tracing import Trace


def reading(device, window=(0.0, 1000.0)):
    tr = Trace(device=device, ranges=[], host_ops=[], window=window, work={"images": 4})
    return SimpleNamespace(trace=tr, window={"metrics": {}}, ctx=None)


@pytest.mark.parametrize("name", ["idle_share.train", "idle_share.eval"])
def test_idle_share_is_the_traced_segments(name):
    # busy 0-300 us and 500-600 us (two overlapping operations count once)
    device = [(0.0, 200.0, "a", None), (100.0, 200.0, "b", None), (500.0, 100.0, "c", None)]
    assert harness.reader(name).read(reading(device)) == pytest.approx(60.0)


@pytest.mark.parametrize("name", ["idle_share.train", "idle_share.eval"])
def test_idle_share_without_device_operations(name):
    assert harness.reader(name).read(reading([])) is None
