"""CUDA stream milliseconds a render call of the span ``parallel.gather``
(the all-gather of the image, its unpadding and its unblocking) on the
rank that reached it last, which waits for no other: the least of the
ranks' readings in each of the driver's measured calls
(``rank_spans``), their mean. None where a rank timed no event pair (no
card) or where the program has no such span."""

from rtbench.drivers.render_mesh import rank_readings


def read(trace):
    calls = rank_readings(trace, "parallel.gather")
    if calls is None:
        return None
    return sum(min(call) for call in calls) / len(calls)
