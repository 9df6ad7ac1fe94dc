"""Device ms a step of the operations launched in the program's augment span."""

from portbench import readers


def read(reading):
    return readers.per_unit_ms(reading.trace.device_s_in("augment"), reading, "steps")
