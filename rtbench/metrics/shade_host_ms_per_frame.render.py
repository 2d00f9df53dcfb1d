"""Host milliseconds a frame of shading: the self time of the span
``render.bounce`` (a segment less its intersect and scatter calls:
emission, NEE, throughput, sky, next rays, roulette) over the traced
stretch."""

from rtbench.spans import counters, per_frame  # noqa: F401


def read(trace):
    return per_frame(trace, "render.bounce.self_ms")
