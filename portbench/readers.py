"""What the per-layer metrics' readers (``portbench/metrics/<name>.py``)
share. Each reader gets a ``reading``: ``trace`` (``tracing.Trace`` of the
traced segment, with ``trace.work`` what it did), ``window`` (the measured
window's result), ``ctx`` (configuration, traffic mix, seed)."""

from __future__ import annotations

from typing import Optional

from portbench import flops, roofline

K1_FORWARD = "attention_fwd"        # the packed attention kernels, by name
K1_BACKWARD = "attention_bwd_dq"    # one of the backward's two kernels a call


def idle_percent(reading) -> Optional[float]:
    """The card's idle share of the traced segment: 1 - the union of its
    device operations over the segment's length. The profiler's recording of
    every host operation slows the host, and with it a host-paced step, so
    this reads above the untraced window's idle share."""
    tr = reading.trace
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def attention_shape(reading):
    """(B, S, C, H) of the packed attention's calls in this cell: the
    pretraining step runs the ViT on both views of each image."""
    cfg, mix = reading.ctx.cfg, reading.ctx.mix
    width, _, heads = flops.ARCHS[cfg["arch"]]
    gh, gw = flops.grid(cfg["patch_size"])
    views = 2 if mix["driver"] == "pretrain" else 1
    return views * int(mix["batch"]), gh * gw, width, heads


def attention_roofline_percent(reading, backward: bool) -> Optional[float]:
    """The K1 kernels' share of their roofline: the sum of their calls'
    bounds over the sum of their device time."""
    tr = reading.trace
    dtype = reading.ctx.cfg["compute_dtype"]
    n_fwd = tr.count(K1_FORWARD)
    n_bwd = tr.count(K1_BACKWARD) if backward else 0
    seconds = tr.device_s(K1_FORWARD) + (tr.device_s("attention_bwd_") if backward else 0.0)
    if n_fwd + n_bwd == 0 or seconds <= 0:
        return None
    shape = attention_shape(reading)
    bound_ms = n_fwd * roofline.attention_bound(*shape, dtype, True)[0] \
        + n_bwd * roofline.attention_bwd_bound(*shape, dtype, True)[0]
    return 100.0 * bound_ms / 1e3 / seconds


def mfu_percent(reading, rate_name: str) -> Optional[float]:
    rate = reading.window["metrics"].get(rate_name)
    if not rate:
        return None
    per_image = flops.PER_IMAGE[reading.ctx.mix["driver"]](reading.ctx.cfg)
    peak = roofline.PEAK_FLOPS[reading.ctx.cfg["compute_dtype"]]
    return 100.0 * per_image * rate / peak


def per_unit_ms(seconds: Optional[float], reading, unit: str) -> Optional[float]:
    n = reading.trace.work.get(unit)
    if seconds is None or not n or seconds <= 0:
        return None
    return seconds * 1e3 / n
