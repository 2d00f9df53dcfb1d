"""Share of the HBM bound that the blocked_hit kernel reaches over a render's
launches: its contract's bytes (``roofline/blocked_hit.py``) at the published
peak over its device time. None where it did not run."""


def read(trace):
    return trace.roofline("blocked_hit")
