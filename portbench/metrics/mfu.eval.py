"""Model FLOPs of the window's recognised images a second (flops.py) over the bf16 peak."""

from portbench import readers


def read(reading):
    return readers.mfu_percent(reading, "eval_images_per_s")
