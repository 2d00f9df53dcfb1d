"""Host milliseconds a viewer frame in the span ``image.encode`` (the
flip, the sRGB curve and the uint8 cast of ``io/image.to_uint8``)."""

from rtbench.spans import counters, per_frame  # noqa: F401


def read(trace):
    return per_frame(trace, "image.encode.host_ms")
