"""How unevenly the ranks take to render their runs of the image: 100 ×
(largest − smallest) / largest of the ranks' CUDA stream milliseconds of
the span ``parallel.shard`` (a rank's frames of its own run, which end
where its all-gather starts, so no rank's wait for another is in it),
summed over the driver's measured calls (``rank_spans``). None on one
rank, where a rank timed no event pair (no card), or where the program
has no such span."""

from rtbench.drivers.render_mesh import rank_readings


def read(trace):
    calls = rank_readings(trace, "parallel.shard")
    if calls is None or len(calls[0]) < 2:
        return None
    per_rank = [sum(call[r] for call in calls) for r in range(len(calls[0]))]
    if max(per_rank) <= 0:
        return None
    return 100.0 * (max(per_rank) - min(per_rank)) / max(per_rank)
