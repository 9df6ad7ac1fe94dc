"""Host ms a batch inside the program's decode spans (the whole greedy decode)."""

from portbench import spans


def read(reading):
    return spans.per(spans.host_ms(reading.trace, "decode"), reading, "batches")
