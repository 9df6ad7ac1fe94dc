"""Host reads a step inside the program's label_clusters span: the flood
fill's convergence tests (``torch.equal``, one a round), each draining the
queue."""


def read(reading):
    n = reading.trace.host_ops_in("label_clusters", "aten::equal")
    steps = reading.trace.work.get("steps")
    return None if n is None or not steps else n / steps
