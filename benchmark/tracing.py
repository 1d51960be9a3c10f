"""The measured window, the harness's spans, and the reading of a trace.

A driver runs its traffic while `Window.running()` is true. In a traced run
(`--trace 1`) the window also opens `torch.profiler` over a stretch of
`trace_seconds` in its middle, with the card synchronised at both ends so
that the work issued in that stretch also ends in it, and snapshots the
driver's counters at both ends. `Trace` holds what the per-layer metrics
read: the card's kernels and copies, the host's operators, the harness's
spans, and the counters' deltas, all on the profiler's clock
(`time.time_ns`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

Interval = Tuple[int, int]


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def union(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """Merged intervals clipped to [lo, hi)."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """One traced stretch: device events, host operators, spans, counters."""

    def __init__(self, t0: int, t1: int, events, spans, before: Dict, after: Dict):
        self.t0, self.t1 = t0, t1
        self.kernels: List[Tuple[str, int, int]] = []   # (name, start_ns, end_ns)
        self.copies: List[Tuple[str, int, int]] = []    # memcpy and memset
        self.host: List[Tuple[str, int, int]] = []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if end <= t0 or start >= t1:
                continue
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith(("Memcpy", "Memset")):
                    self.copies.append((name, start, end))
                else:
                    self.kernels.append((name, start, end))
            else:
                self.host.append((name, start, end))
        self.spans = [s for s in spans if s[1] >= t0 and s[2] <= t1]
        self.delta = {k: after[k] - before[k] for k in before}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy(self) -> List[Interval]:
        return union([(a, b) for _, a, b in self.kernels + self.copies], self.t0, self.t1)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.kernels if match(n)) * 1e-9

    def gaps(self) -> List[Interval]:
        gaps, at = [], self.t0
        for a, b in self.busy():
            if a > at:
                gaps.append((at, a))
            at = b
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def host_at(self, t: int) -> str:
        """What the host was doing at t: the harness's span and the
        innermost operator running then (the one that started last)."""
        span = next((n for n, a, b in self.spans if a <= t < b), "no harness span")
        ops = [(a, n) for n, a, b in self.host if a <= t < b]
        return "%s / %s" % (span, max(ops)[1] if ops else "no operator")

    def breakdown(self, top: int = 10):
        by_name: Dict[str, int] = {}
        for n, a, b in self.kernels + self.copies:
            by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], ns * 1e-9] for n, ns in ops],
                "idle_gaps": [[self.host_at((a + b) // 2)[:160], (b - a) * 1e-9] for a, b in gaps]}


class Window:
    """The measured window of one run."""

    def __init__(self, seconds: float, device, trace_seconds: Optional[float] = None,
                 counters: Callable[[], Dict] = dict):
        self.seconds = float(seconds)
        self.device = device
        self.trace_seconds = None if trace_seconds is None else min(float(trace_seconds),
                                                                     self.seconds)
        self._trace_at = (self.seconds - (self.trace_seconds or 0.0)) / 2.0
        self._counters = counters
        self.spans: List[Tuple[str, int, int]] = []
        self.trace: Optional[Trace] = None
        self._prof = None
        self._t0 = None
        self.elapsed = None

    @staticmethod
    def warm_profiler(device) -> None:
        """Start and stop the profiler once at set-up: its first start is slow."""
        with torch.profiler.profile(activities=_activities(device)):
            torch.zeros(1, device=device).add_(1)
            synchronize(device)

    def start(self) -> None:
        synchronize(self.device)
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def running(self) -> bool:
        el = self.now()
        if self.trace_seconds is not None:
            if self._prof is None and self.trace is None and el >= self._trace_at:
                self._open()
            elif self._prof is not None and el >= self._trace_at + self.trace_seconds:
                self._close()
        return el < self.seconds or self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))

    def finish(self) -> None:
        """Close the window (once)."""
        if self.elapsed is not None:
            return
        if self._prof is not None:
            self._close()
        synchronize(self.device)
        self.elapsed = self.now()

    def _open(self) -> None:
        synchronize(self.device)
        self._before = self._counters()
        self._prof = torch.profiler.profile(activities=_activities(self.device))
        self._prof.start()
        self._trace_t0 = time.time_ns()

    def _close(self) -> None:
        synchronize(self.device)
        t1 = time.time_ns()
        after = self._counters()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self.trace = Trace(self._trace_t0, t1, events, self.spans, self._before, after)
        self._prof = None


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts
