"""CUDA stream milliseconds a step from the start to the end of the span
``train.optimizer`` (the gradients handed over and Adam's step). None
where no event pair was timed (no card)."""

from rtbench.spans import counters, per_step  # noqa: F401


def read(trace):
    return per_step(trace, "train.optimizer.stream_ms", stream=True)
