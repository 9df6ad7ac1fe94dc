"""Recognition's LayerNorms: their bound a batch (layernorm.py) over the device time of the LayerNorm kernels."""

from portbench import layernorm


def read(reading):
    return layernorm.roofline_percent(reading, "batches")
