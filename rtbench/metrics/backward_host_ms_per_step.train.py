"""Host milliseconds a step in the span ``train.backward``
(``torch.autograd.grad``): what the host takes to launch the backward."""

from rtbench.spans import counters, per_step  # noqa: F401


def read(trace):
    return per_step(trace, "train.backward.host_ms")
