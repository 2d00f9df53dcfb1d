"""CUDA stream milliseconds a step from the start to the end of the span
``train.backward`` (``torch.autograd.grad``): its device work and the
idle inside it. None where no event pair was timed (no card)."""

from rtbench.spans import counters, per_step  # noqa: F401


def read(trace):
    return per_step(trace, "train.backward.stream_ms", stream=True)
