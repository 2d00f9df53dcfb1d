"""Host-side metrics: frame clocks and stage timers.

Port of ``ray_tracer_tpu.utils.metrics``, shared by the command line, the
viewer and ``chip_smoke.py``:

  * ``FrameClock``: ring buffer of recent frame times with mean/p50/p95
    and ray segments per second derived from RenderParams (the viewer's
    status line);
  * ``StageTimer``: named wall-clock stages (build / render / checkpoint /
    io) accumulated through context managers and emitted through
    ``logging`` (logger ``ray_tracer_tpu_torch.metrics``).

Difference from the reference: PyTorch returns before a CUDA device
finishes, so a host clock around a stage measures only what the stage
enqueued. Where this process has initialized CUDA, ``StageTimer``
synchronizes the current device when a stage starts and when it ends, so
a stage's time includes the device work issued inside it and none issued
before it. ``FrameClock`` records what its caller measured (the viewer's
frame ends in a copy of the image to the host, which waits for the
device).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from typing import Dict

import torch

logger = logging.getLogger("ray_tracer_tpu_torch.metrics")


class FrameClock:
    """Sliding-window frame-time statistics."""

    def __init__(self, window: int = 120):
        self._dts = deque(maxlen=window)
        self._t_last = None

    def tick(self) -> float:
        """Mark a frame boundary; returns the dt (s) since the last tick
        (0.0 on the first)."""
        now = time.perf_counter()
        dt = 0.0 if self._t_last is None else now - self._t_last
        self._t_last = now
        if dt > 0.0:
            self._dts.append(dt)
        return dt

    def record(self, dt_s: float) -> None:
        """Record an externally measured frame time."""
        if dt_s > 0.0:
            self._dts.append(dt_s)

    @property
    def count(self) -> int:
        return len(self._dts)

    def _sorted(self):
        return sorted(self._dts)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self._dts) / len(self._dts) if self._dts else 0.0

    @property
    def p50_ms(self) -> float:
        s = self._sorted()
        return 1e3 * s[len(s) // 2] if s else 0.0

    @property
    def p95_ms(self) -> float:
        s = self._sorted()
        return 1e3 * s[min(len(s) - 1, int(len(s) * 0.95))] if s else 0.0

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1e3 / m if m > 0 else 0.0

    def segments_per_s(self, params) -> float:
        """Traced ray segments per second at the current mean frame time
        (width*height*rpp*(bounces+1) per frame)."""
        m = self.mean_ms
        if m <= 0:
            return 0.0
        segs = (params.width * params.height * params.rays_per_pixel
                * (params.bounces + 1))
        return segs / (m * 1e-3)

    def summary(self, params=None) -> str:
        s = (f"{self.mean_ms:.1f} ms/frame (p50 {self.p50_ms:.1f}, "
             f"p95 {self.p95_ms:.1f}, {self.fps:.2f} fps")
        if params is not None:
            s += f", {self.segments_per_s(params) / 1e6:.1f} M segs/s"
        return s + f", n={self.count})"


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
