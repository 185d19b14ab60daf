"""The benchmark's own reading of a ``torch.profiler`` trace of the window:
which device operations ran and when, the device's busy time as the union of
its kernel, copy and set intervals, kernel time by name, and the longest idle
gaps with the host operation that was running meanwhile.

The window is marked by a ``record_function`` span (``WINDOW``) on the host;
device intervals are clipped to it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench.window"


@dataclass
class Trace:
    """A traced window: device intervals (ns, clipped to the window), their
    names, and the host operations (ns) with their names."""

    t0: int
    t1: int
    dev_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    dev_end: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    dev_name: list = field(default_factory=list)
    host_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    host_end: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    host_name: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """(k, 2) disjoint intervals in which some device operation ran."""
        if self.dev_start.size == 0:
            return np.zeros((0, 2), np.int64)
        order = np.argsort(self.dev_start, kind="stable")
        s, e = self.dev_start[order], self.dev_end[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(s.size, bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        ends = np.append(reach[np.nonzero(new)[0][1:] - 1], reach[-1])
        return np.stack([starts, ends], 1)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float(np.sum(iv[:, 1] - iv[:, 0])) / 1e9

    def idle_pct(self) -> float | None:
        if self.t1 <= self.t0 or self.dev_start.size == 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s(self, name_part: str) -> float:
        """Device seconds of the operations whose name holds ``name_part``."""
        sel = np.array([name_part in n for n in self.dev_name], bool)
        return float(np.sum(self.dev_end[sel] - self.dev_start[sel])) / 1e9 if sel.size else 0.0

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most time."""
        tot: dict[str, int] = {}
        for n, d in zip(self.dev_name, (self.dev_end - self.dev_start).tolist()):
            tot[n] = tot.get(n, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """[[what the host was doing, seconds], ...]: the longest gaps in
        which the device ran nothing, each named by the innermost host
        operation running at its middle."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.t0], iv.ravel(), [self.t1]]).reshape(-1, 2)
        gaps = [(int(a), int(b)) for a, b in edges if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            inside = np.nonzero((self.host_start <= mid) & (self.host_end >= mid))[0]
            if inside.size:
                name = self.host_name[int(inside[np.argmax(self.host_start[inside])])]
            else:
                name = "no host operation"
            out.append([_short(name), (b - a) / 1e9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


class Tracer:
    """A ``torch.profiler`` trace (CPU and CUDA activity) of the window or of
    a part of it: the driver calls ``start()`` where the traced part starts
    and ``stop()`` where it ends; the harness stops it at the
    window's end if the driver did not. Disabled, both do nothing and
    ``trace`` stays None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self._prof = self._mark = None

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self.trace is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        import time

        from portbench.harness import say

        self._mark.__exit__(None, None, None)
        t0 = time.perf_counter()
        self._prof.stop()
        t1 = time.perf_counter()
        self.trace = read_profile(self._prof)
        self._prof = self._mark = None
        say(f"[trace] the profiler stopped in {t1 - t0:.1f} s, its events read in "
            f"{time.perf_counter() - t1:.1f} s: {self.trace.dev_start.size} device operations in a "
            f"{self.trace.window_s:.3f} s traced window")


def span(name: str, on: bool):
    """A named host span in a traced run; nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def read_profile(prof) -> Trace:
    """The traced window from a stopped profiler's Kineto events (name,
    device type, start and duration in ns, whether a span). Names are read for the device operations, for the longest
    host operations (to find the window) and for those that label a gap."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cuda = DeviceType.CUDA
    rows = []
    for i, e in enumerate(events):
        s0 = e.start_ns()
        rows.append((i, e.device_type() == cuda, s0, s0 + e.duration_ns()))
    return _trace(rows, lambda i: events[i].name(), lambda i: events[i].is_user_annotation())


def trace_from_rows(rows) -> Trace:
    """A Trace from (name, device type, activity, start ns, end ns) rows."""
    keyed = [(j, "CUDA" in d, s, e) for j, (n, d, a, s, e) in enumerate(rows)]
    return _trace(keyed, lambda j: rows[j][0], lambda j: "annotation" in rows[j][2])


def _trace(rows, name_of, annotation) -> Trace:
    """rows: (key, on the device, start ns, end ns); name_of(key) and
    annotation(key) read an event's name and whether it is a span. The
    window is the host span ``WINDOW``, found among the longest host rows;
    device operations are the device rows but the spans the profiler
    mirrors onto the device's timeline; host operations are the other host
    rows."""
    host_rows = sorted((r for r in rows if not r[1]), key=lambda r: r[2] - r[3])
    window = next((r for r in host_rows[:16] if name_of(r[0]) == WINDOW), None)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    t0, t1 = window[2:]
    inside = [r for r in rows if r[3] > t0 and r[2] < t1 and r is not window]
    dev = [(name_of(k), max(s, t0), min(e, t1)) for k, d, s, e in inside if d and not annotation(k)]
    host = sorted((k, s, e) for k, d, s, e in inside if not d)
    arr = lambda xs, j: np.array([x[j] for x in xs], np.int64)
    return Trace(t0=t0, t1=t1, dev_start=arr(dev, 1), dev_end=arr(dev, 2), dev_name=[x[0] for x in dev],
                 host_start=arr(host, 1), host_end=arr(host, 2),
                 host_name=_Names([x[0] for x in host], name_of))


class _Names:
    """Host operations' names, read on demand."""

    def __init__(self, keys, name_of):
        self.keys, self.name_of = keys, name_of

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, j):
        return self.name_of(self.keys[j])
