"""Host-side metrics: frame clocks, stage timers and spans.

Port of ``ray_tracer_tpu.utils.metrics``, shared by the command line, the
viewer and ``chip_smoke.py``:

  * ``FrameClock``: ring buffer of recent frame times with their mean and
    rate (the viewer's status line);
  * ``StageTimer``: named wall-clock stages (build / render / checkpoint /
    io) accumulated through context managers and emitted through
    ``logging`` (logger ``ray_tracer_tpu_torch.metrics``);
  * ``span``: named intervals at the port's layer boundaries (``SPANS``),
    off unless ``tracing(True)``; ``span_totals()`` sums them by name and
    ``span_records()`` keeps the latest ones.

Difference from the reference: PyTorch returns before a CUDA device
finishes, so a host clock around a stage measures only what the stage
enqueued. Where this process has initialized CUDA, ``StageTimer``
synchronizes the current device when a stage starts and when it ends, so
a stage's time includes the device work issued inside it and none issued
before it. ``FrameClock`` records what its caller measured (the viewer's
frame ends in a copy of the image to the host, which waits for the
device). A span never synchronizes: its host time is what its layer took
to enqueue, and a stream span marks the CUDA stream with a pair of events
whose elapsed time is read once both have completed.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

logger = logging.getLogger("ray_tracer_tpu_torch.metrics")


class FrameClock:
    """Sliding-window frame-time statistics."""

    def __init__(self, window: int = 120):
        self._dts = deque(maxlen=window)

    def record(self, dt_s: float) -> None:
        """Record an externally measured frame time."""
        if dt_s > 0.0:
            self._dts.append(dt_s)

    @property
    def count(self) -> int:
        return len(self._dts)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self._dts) / len(self._dts) if self._dts else 0.0

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1e3 / m if m > 0 else 0.0


def _sync() -> None:
    """Wait for the current CUDA device where this process uses one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulate named wall-clock stages, each synchronized with the CUDA
    device at its start and end (module docstring).

    >>> st = StageTimer()
    >>> with st.stage("build"):
    ...     build_scene()
    >>> st.log()          # -> logging.info: stages: build=0.12s ...
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def format(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in self.totals.items())

    def log(self, level: int = logging.INFO) -> None:
        if self.totals:
            logger.log(level, "stages: %s", self.format())


# -- spans ---------------------------------------------------------------------

# Every span of the port by name → whether it also times the CUDA stream.
# ``span_totals()`` carries each of them from the start, so a difference of
# two readings never misses a key.
SPANS: Dict[str, bool] = {
    "render.frame": False,       # renderer.render_frame
    "render.bounce": False,      # one segment of renderer.trace; self: shading
    "render.intersect": False,   # its closest-hit query and hit rows
    "render.scatter": False,     # its materials.scatter
    "planes.pack": False,        # ops.closest_hit.scene_planes packing anew
    "train.step": True,          # grad.inverse.make_train_step's step_fn
    "train.forward": True,       # the loss (or the chunked value and grad)
    "train.backward": True,      # autograd's gradient and the edge term
    "train.optimizer": True,     # the gradients handed over, the step
    "viewer.frame": False,       # viewer.ViewerCore.frame
    "image.to_host": False,      # io.image: the copy to the host; on a
                                 # card the 8-bit copy and its wait
    "image.encode": False,       # io.image: flip, sRGB curve, uint8; on a
                                 # card the kernel's launch
    "parallel.render": False,    # parallel.progressive: a call on a mesh
    "parallel.shard": True,      # its frames of this rank's run
    "parallel.gather": True,     # its all-gather, unpadding and unblocking
    "parallel.all_gather": True,  # the collective alone
}
SPAN_RING = 1 << 15              # closed spans kept by span_records()


class SpanRecord(NamedTuple):
    """One closed span. ``seq`` numbers spans in the order they opened;
    ``parent`` is the ``seq`` of the span open around it (None at the
    top); ``request`` is the frame or step it served, the outermost
    span's where that gave one. Times are ``time.time_ns()``, the clock
    torch's profiler stamps its events with (an event's ``time_range`` in
    microseconds after ``kineto_results.trace_start_ns()``)."""
    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: Optional[int]


class _Spans:
    """The process's span state: the switch, the open spans, the totals
    by name ([count, host ns, self ns, stream ms, stream pairs]), the ring
    of closed spans and the stream pairs not yet read. One thread opens
    and closes spans at a time: the caller's, or autograd's while the
    caller waits in its backward (a recomputed segment under ``remat``)."""

    def __init__(self):
        self.on = False
        self.open: List["_Span"] = []
        self.totals = {name: [0, 0, 0, 0.0, 0] for name in SPANS}
        self.ring = deque(maxlen=SPAN_RING)
        self.pending = []
        self.seq = 0

    def read_stream(self):
        """Add the elapsed time of every pair whose events have completed;
        keep the others. Queries only: nothing waits for the device."""
        left = []
        for total, start, end in self.pending:
            if end.query() and start.query():
                total[3] += start.elapsed_time(end)
                total[4] += 1
            else:
                left.append((total, start, end))
        self.pending = left


_spans = _Spans()


def _wrap(name: str, fn):
    """``fn`` run inside ``span(name)``, decided at each call."""
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


class _Off:
    """A declared span while tracing is off: a context that does nothing,
    one per name, shared by every call."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _wrap(self.name, fn)


_OFF = {name: _Off(name) for name in SPANS}


class _Span:
    """An open span while tracing is on."""
    __slots__ = ("name", "request", "seq", "parent", "start", "children",
                 "event")

    def __init__(self, name: str, request):
        self.name = name
        self.request = request

    def __call__(self, fn):
        return _wrap(self.name, fn)

    def __enter__(self):
        s = _spans
        self.parent = s.open[-1] if s.open else None
        if self.parent is not None and self.parent.request is not None:
            self.request = self.parent.request
        s.seq += 1
        self.seq = s.seq
        self.children = 0
        self.event = None
        if SPANS[self.name] and torch.cuda.is_initialized():
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        s.open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        s = _spans
        s.open.pop()
        took = end - self.start
        total = s.totals[self.name]
        total[0] += 1
        total[1] += took
        total[2] += took - self.children
        parent = self.parent
        if parent is not None:
            parent.children += took
        if self.event is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            s.pending.append((total, self.event, stop))
            if len(s.pending) >= 64:
                s.read_stream()
        s.ring.append(SpanRecord(self.seq, self.name, self.start, end,
                                 None if parent is None else parent.seq,
                                 self.request))
        return False


def span(name: str, request: Optional[int] = None):
    """A context manager (or decorator) timing the layer ``name`` of
    ``SPANS``; ``request`` is the frame or step it serves, kept where no
    enclosing span gave one. Off (the default) it costs a flag check and
    returns a shared context that does nothing. On, it adds to the name's
    count, host time and self time (host time less its child spans'), and
    keeps a ``SpanRecord``; a stream span on a CUDA process also records an
    event pair on the current stream (``span_totals``). Nothing enters
    torch's profiler. A name not in ``SPANS`` raises KeyError, on or off
    (on, when the span is entered)."""
    if not _spans.on:
        return _OFF[name]
    return _Span(name, request)


def tracing(on: bool) -> None:
    """Switch the spans on or off."""
    _spans.on = bool(on)


def span_totals() -> Dict[str, float]:
    """Every declared span's totals since the process started: for each
    name ``<name>.count``, ``.host_ms`` and ``.self_ms``, and for a stream
    span ``.stream_ms`` and ``.stream_n``, the milliseconds and number of
    its event pairs read so far (pairs still in flight are read by a
    later call; 0 without CUDA). Zero where a span never ran."""
    _spans.read_stream()
    out = {}
    for name, stream in SPANS.items():
        count, host_ns, self_ns, stream_ms, stream_n = _spans.totals[name]
        out[f"{name}.count"] = count
        out[f"{name}.host_ms"] = host_ns / 1e6
        out[f"{name}.self_ms"] = self_ns / 1e6
        if stream:
            out[f"{name}.stream_ms"] = stream_ms
            out[f"{name}.stream_n"] = stream_n
    return out


def span_records() -> List[SpanRecord]:
    """The latest ``SPAN_RING`` closed spans, oldest first."""
    return list(_spans.ring)
