"""Reading a traced stretch: device busy time, kernel times by name, the
port's counters over the stretch (``counts``), idle gaps by what the host
was doing, and the roofline share of a kernel by its contract's bytes
(``roofline/<kernel>.py``).

Device intervals are the profiler's CUDA events (kernels, copies and
fills); the busy time is the length of their union, so overlapping
kernels count once.
"""

from __future__ import annotations

import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_PEAK = 3.35e12        # bytes/s, H100 SXM's published HBM3 bandwidth
_NOT_KERNELS = ("Memcpy", "Memset")
_HOST_RUNTIME = re.compile(r"^(cuda|cu[A-Z]|Profiler|\[memory\])")


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """One traced stretch of ``units`` loop units. ``context``: the
    cell's ``layer_context`` (frames and steps per unit, lanes per
    launch, the scene's sizes, host enqueue times of the window). Host
    ops are there only where the stretch recorded them. ``ranks``: each
    rank's busy and window seconds of the same stretch, in rank order
    (this stretch's alone on one card), from which a reader can take the
    imbalance of the ranks' shards."""

    def __init__(self, prof, window_s: float, counts: dict, units: int,
                 context: dict):
        from torch.autograd import DeviceType
        self.window_s = float(window_s)
        self.counts = counts
        self.units = units
        self.context = context
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        self.device = [(e.name, e.time_range.start, e.time_range.end)
                       for e in dev]
        self.host = [(e.name, e.time_range.start, e.time_range.end)
                     for e in events if e.device_type == DeviceType.CPU
                     and not _HOST_RUNTIME.match(e.name)]
        self.busy = _union((a, b) for _, a, b in self.device)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6
        self.ranks = [{"busy_s": self.busy_s, "window_s": self.window_s}]

    # -- what readers ask --------------------------------------------------

    @property
    def frames(self) -> float:
        return self.units * self.context.get("frames_per_unit", 0)

    @property
    def steps(self) -> float:
        return self.units * self.context.get("steps_per_unit", 0)

    @property
    def kernels(self) -> int:
        """Device kernels in the stretch (copies and fills left out)."""
        return sum(1 for n, _, _ in self.device
                   if not n.startswith(_NOT_KERNELS))

    def idle_pct(self):
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_time(self, names):
        """(seconds, launches of the first name) of the device kernels
        whose names hold one of ``names`` as a whole word."""
        pats = [re.compile(rf"\b{re.escape(n)}\b") for n in names]
        secs, count = 0.0, 0
        for n, a, b in self.device:
            hit = [p.search(n) is not None for p in pats]
            if any(hit):
                secs += (b - a) / 1e6
                count += hit[0]
        return secs, count

    def roofline(self, kernel: str):
        """Percent of the HBM bound: the contract's bytes of every launch
        of ``kernel`` (``roofline/<kernel>.py``) at the mean live lanes a
        launch that its probe counted, at the published peak, over the
        kernel's device time. None where it did not run or its probe saw
        no launch."""
        from .core import load_module
        mod = load_module(HERE / "roofline" / f"{kernel}.py")
        secs, launches = self.kernel_time(mod.KERNELS)
        live = self.context.get("live", {}).get(kernel)
        if not launches or secs <= 0 or live is None:
            return None
        need = launches * mod.launch_bytes(self.context, live) / HBM_PEAK
        return 100.0 * need / secs

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by_op = {}
        for n, a, b in self.device:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), s] for n, s in ops]

    def idle_gaps(self, top: int = 10) -> list:
        """[name, seconds] of the device's idle time between its
        intervals, by the innermost host op running at each gap's middle
        ("host outside any op" where none was)."""
        gaps = [(a1, b0) for (_, a1), (b0, _) in zip(self.busy,
                                                      self.busy[1:])]
        host = sorted(self.host, key=lambda h: h[1])
        idle = {}
        j, stack = 0, []
        for a, b in sorted(gaps):
            mid = (a + b) / 2
            while j < len(host) and host[j][1] <= mid:
                stack.append(host[j])
                j += 1
            stack = [h for h in stack if h[2] > mid]
            name = (max(stack, key=lambda h: h[1])[0] if stack
                    else "host outside any op")
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), s] for n, s in gaps_top]


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
