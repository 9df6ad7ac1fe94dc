"""The glyph clustering's flood rounds a step: the program's flood_round
spans, one a round, each with its host read."""

from portbench import spans


def read(reading):
    return spans.per(spans.count(reading.trace, "flood_round"), reading, "steps")
