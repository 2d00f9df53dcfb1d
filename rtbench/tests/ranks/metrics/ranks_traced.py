"""How many ranks' busy and window seconds the traced stretch holds: the
entries of ``trace.ranks`` that are each a rank's {busy_s, window_s}."""


def read(trace):
    return sum(isinstance(r, dict) and set(r) == {"busy_s", "window_s"}
               and all(isinstance(v, float) and v >= 0 for v in r.values())
               for r in trace.ranks)
