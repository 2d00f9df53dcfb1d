"""Device kernels launched per rendered frame in the traced stretch
(copies and fills left out): a count that repeats exactly."""


def read(trace):
    return trace.kernels / trace.frames if trace.frames else None
