"""Host calls a batch that put work on the card inside the program's decode
spans: the distinct launch times of the device operations launched there."""

from portbench import spans


def read(reading):
    return spans.per(spans.launches(reading.trace, "decode"), reading, "batches")
