"""Host milliseconds a frame in the bounce loop's ``materials.scatter`` (the
span ``render.scatter``: the RNG hash and the next directions) over the
traced stretch."""

from rtbench.spans import counters, per_frame  # noqa: F401


def read(trace):
    return per_frame(trace, "render.scatter.host_ms")
