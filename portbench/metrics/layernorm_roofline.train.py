"""Training's LayerNorms, forward and backward: their bound a step (layernorm.py) over the device time of the LayerNorm kernels."""

from portbench import layernorm


def read(reading):
    return layernorm.roofline_percent(reading, "steps")
