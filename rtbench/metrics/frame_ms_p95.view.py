"""The 95th percentile of the viewer frames' times over the window of the
traced run (``ViewerCore.frame()`` to the 8-bit image on the host, every
frame of the window): the hitches that the mean frame time hides."""


def read(trace):
    return trace.context.get("frame_ms_p95")
