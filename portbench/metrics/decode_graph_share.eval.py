"""Share of the program's greedy decodes that replayed a captured CUDA graph:
its ``decode_graph`` spans (one around each replay) over its ``decode`` spans
(one around each decode), in %. Nothing where the program opens no
``decode_graph`` span."""

from portbench import spans


def read(reading):
    graphs = spans.count(reading.trace, "decode_graph")
    decodes = spans.count(reading.trace, "decode")
    return None if graphs is None or decodes is None else 100.0 * graphs / decodes
