"""The port's spans (``ray_tracer_tpu_torch.utils.metrics.span``) as
counters of a traced run: ``counters()`` switches them on and reads their
totals by name, and ``per_frame`` / ``per_step`` turn a total's change
over the traced stretch into a metric.

``core.run_cell`` calls a reader's ``counters()`` only in a ``--trace 1``
run, first at the traced stretch's start, after the timed window: the
window runs with the spans off. A program without the spans gives no
counters, and its readers give None.
"""


def counters():
    """The spans' totals now (``<span>.count``, ``.host_ms``, ``.self_ms``,
    ``.stream_ms``, ``.stream_n``), with the spans switched on; empty
    where the program has no spans."""
    try:
        from ray_tracer_tpu_torch.utils.metrics import span_totals, tracing
    except ImportError:
        return {}
    tracing(True)
    return span_totals()


def _per(trace, key, units, stream):
    if not units or key not in trace.counts:
        return None
    if stream:
        # a stream time is read only from event pairs that were timed: on
        # the CPU, or with none read, there is no number
        name = key.rsplit(".", 1)[0]
        if not trace.counts.get(f"{name}.stream_n"):
            return None
    return trace.counts[key] / units


def per_frame(trace, key, stream=False):
    """The change of span total ``key`` over the stretch, per frame."""
    return _per(trace, key, trace.frames, stream)


def per_step(trace, key, stream=False):
    """The change of span total ``key`` over the stretch, per step."""
    return _per(trace, key, trace.steps, stream)
