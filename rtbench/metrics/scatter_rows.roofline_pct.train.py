"""Share of the HBM bound that the scatter-add kernel reaches over a
training step's launches: its contract's bytes
(``roofline/scatter_rows.py``) at the published peak over its device
time. None where it did not run."""


def read(trace):
    return trace.roofline("scatter_rows")
