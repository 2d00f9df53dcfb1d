"""Share of the published NVLink bandwidth of an H100 SXM (450 GB/s a
direction) that the render call's all-gather reaches: the bytes a rank
receives a gather by the layout's contract, over the CUDA stream time of
the span ``parallel.all_gather`` (the collective alone) on the rank that
reached it last, the least of the ranks' readings in each of the
driver's measured calls (``rank_spans``). The others' readings hold
their wait for that rank; its own holds the transfer. None on one rank,
where a rank timed no event pair (no card), or where the program has no
such span."""

from rtbench.drivers.render_mesh import rank_readings

NVLINK_PEAK = 450e9      # bytes/s a direction, H100 SXM's published NVLink


def received_bytes(context: dict) -> int:
    """Bytes one rank receives in one all-gather: the other ranks' runs,
    each padded to the longest, of float32 RGB. The runs are whole
    share tiles of the image's lanes, the first ranks one tile more."""
    ranks, unit = context["ranks"], context["shard_unit"]
    units = -(-context["image_lanes"] // unit)
    longest = -(-units // ranks) * unit
    return (ranks - 1) * longest * 3 * 4


def read(trace):
    calls = rank_readings(trace, "parallel.all_gather")
    if calls is None or len(calls[0]) < 2:
        return None
    secs = sum(min(call) for call in calls) / 1e3
    if secs <= 0:
        return None
    moved = len(calls) * received_bytes(trace.context)
    return 100.0 * moved / NVLINK_PEAK / secs
