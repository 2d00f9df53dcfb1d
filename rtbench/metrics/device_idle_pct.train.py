"""Share of the traced stretch of training steps in which the device ran no
kernel, copy or fill."""


def read(trace):
    return trace.idle_pct()
