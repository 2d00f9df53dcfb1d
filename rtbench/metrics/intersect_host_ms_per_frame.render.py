"""Host milliseconds a frame in the bounce loop's closest-hit query (the span
``render.intersect``: the kernel's wrapper and the hit rows) over the
traced stretch."""

from rtbench.spans import counters, per_frame  # noqa: F401


def read(trace):
    return per_frame(trace, "render.intersect.host_ms")
