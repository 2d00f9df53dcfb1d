"""Host milliseconds per frame from entering ``render_progressive`` to its
return, before any synchronize, over the untraced window's calls: the
time the host takes to issue a frame's work."""


def read(trace):
    return trace.context.get("enqueue_ms_per_frame")
