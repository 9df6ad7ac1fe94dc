"""Share of the program's training-step augmentations that replayed a
captured CUDA graph: its ``augment_graph`` spans (one around each replay)
over its ``augment`` spans (one around each step's augmentation), in %.
Nothing where the program opens no ``augment_graph`` span."""

from portbench import spans


def read(reading):
    graphs = spans.count(reading.trace, "augment_graph")
    augments = spans.count(reading.trace, "augment")
    return None if graphs is None or augments is None else 100.0 * graphs / augments
