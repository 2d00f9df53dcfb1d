"""Share of the traced stretch of viewer frames in which the device ran no
kernel, copy or fill."""


def read(trace):
    return trace.idle_pct()
