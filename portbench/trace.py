"""The device trace of a `--trace 1` run, and the arithmetic on it.

`DeviceTrace` records the card's activity (kernels, copies, fills) with
`torch.profiler` over the measured window, CUDA activity only, and maps
each event onto the host's `time.perf_counter` clock by a marker kernel
launched right after a synchronise at the window's start.  The functions
below take plain lists, so a canned trace tests them on the CPU:

  * events: [(name, start_s, end_s)] on the host clock;
  * spans: [(label, start_s, end_s)], the benchmark's own host spans.
"""

from __future__ import annotations

import time
from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES) and MARKER not in name


def clip(events, t0: float, t1: float) -> list:
    """The events' parts inside [t0, t1], the markers left out."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in events
            if b > t0 and a < t1 and MARKER not in n]


def busy_intervals(events) -> list:
    """The union of the events' intervals, as sorted disjoint [a, b]."""
    merged = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(events) -> float:
    return sum(b - a for a, b in busy_intervals(events))


def idle_gaps(events, t0: float, t1: float, spans) -> list:
    """[(label, seconds)] of every stretch of [t0, t1] with nothing on the
    device, longest first, each labelled by the host span around its
    middle ("other" where none is)."""
    gaps, at = [], t0
    for a, b in busy_intervals(events) + [[t1, t1]]:
        if a > at:
            mid = (at + a) / 2
            label = next((s for s, sa, sb in spans if sa <= mid < sb), "other")
            gaps.append((label, a - at))
        at = max(at, b)
    return sorted(gaps, key=lambda g: -g[1])


def top_ops(events, n: int = 10) -> list:
    """[(name, seconds)] of the device operations that took most time."""
    total = defaultdict(float)
    for name, a, b in events:
        total[name] += b - a
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]


class DeviceTrace:
    """Context manager: the card's events of the enclosed code, on the host
    clock, in `events` after exit."""

    def __init__(self):
        self.events = []

    def _marker(self) -> float:
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return t

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t_mark = self._marker()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        raw = self._device_events()
        marks = [a for n, a, _ in raw if MARKER in n]
        if not raw:
            raise RuntimeError("the profiler recorded no device activity")
        # a kernel starts a few microseconds after its launch: the marker's
        # start is taken as the host time read just before launching it
        origin = marks[0] if marks else min(a for _, a, _ in raw)
        self.events = [(n, self._t_mark + (a - origin) * 1e-9, self._t_mark + (b - origin) * 1e-9)
                       for n, a, b in raw]
        return False

    def _device_events(self) -> list:
        """[(name, start_ns, end_ns)] of the device's events, read from the
        profiler's raw results (its per-event Python objects are slow to
        build for a window of 10^5 kernels), or from `events()` where the
        raw results are not there."""
        from torch.autograd import DeviceType

        try:
            raw = self._prof.profiler.kineto_results.events()
            return [(e.name(), e.start_ns(), e.end_ns()) for e in raw
                    if e.device_type() == DeviceType.CUDA]
        except AttributeError:
            return [(e.name, e.time_range.start * 1000, e.time_range.end * 1000)
                    for e in self._prof.events() if e.device_type == DeviceType.CUDA]
