"""Host ms a batch inside the program's convert spans (the convertor's
tensor2idx and idx2str)."""

from portbench import spans


def read(reading):
    return spans.per(spans.host_ms(reading.trace, "convert"), reading, "batches")
