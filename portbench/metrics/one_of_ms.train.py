"""Device ms a step of the operations launched inside the program's one_of
spans (the augmentation's choose-one chains, nested ones counted once)."""

from portbench import spans


def read(reading):
    return spans.per(spans.device_ms(reading.trace, "one_of"), reading, "steps")
