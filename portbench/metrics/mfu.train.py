"""Model FLOPs of the window's training images a second (flops.py) over the bf16 peak."""

from portbench import readers


def read(reading):
    return readers.mfu_percent(reading, "train_images_per_s")
