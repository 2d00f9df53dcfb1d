"""Host milliseconds a viewer frame in the span ``image.to_host`` (the
image's copy to the host, which waits for the device's frame)."""

from rtbench.spans import counters, per_frame  # noqa: F401


def read(trace):
    return per_frame(trace, "image.to_host.host_ms")
