"""The card's idle share of the traced segment: 1 - the union of its device
operations over the segment's length (torch.profiler)."""

from portbench import readers


def read(reading):
    return readers.idle_percent(reading)
