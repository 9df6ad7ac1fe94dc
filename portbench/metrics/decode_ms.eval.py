"""Device ms a batch of the operations launched in the greedy decode (the benchmark's portbench.decoder range)."""

from portbench import readers


def read(reading):
    return readers.per_unit_ms(reading.trace.device_s_in("portbench.decoder"), reading, "batches")
