"""Host milliseconds a viewer frame in the span ``planes.pack`` (the
scene's planes packed anew by ``ops/closest_hit.scene_planes``)."""

from rtbench.spans import counters, per_frame  # noqa: F401


def read(trace):
    return per_frame(trace, "planes.pack.host_ms")
