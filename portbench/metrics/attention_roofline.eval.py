"""K1 forward: the calls' roofline bounds over their device time."""

from portbench import readers


def read(reading):
    return readers.attention_roofline_percent(reading, backward=False)
