"""The harness's own spans, and what it reads from the profiler and torch's
sync debug mode.

`kineto_events` and `reads_in` copy the arithmetic of the port's
`chip_smoke.py::device_events` and `reads_in`: the profiler's raw Kineto
events (building its event objects costs ~0.1 ms each), and every
synchronising operation that sync debug mode "warn" reports, but its one
notice that the mode is a prototype.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
import warnings
from typing import NamedTuple

import torch

SYNC_DEBUG_NOTICE = "debug mode is a prototype feature"
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")  # the profiler's own host work
SCAN_BACK = 4096  # host ranges looked at, back from a gap, for the one that covers it


class Span(NamedTuple):
    name: str
    request: int
    start: float   # perf_counter seconds
    end: float


class Spans:
    """Spans kept in memory: `with spans("upload", request):`. While
    `profiling` is set, each span is also a `record_function` range named
    "bench.<name>", so that the trace can say what the host was doing."""

    def __init__(self):
        self.items: list[Span] = []
        self.request = -1
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(f"bench.{name}") if self.profiling
               else contextlib.nullcontext())
        start = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.items.append(Span(name, self.request, start, time.perf_counter()))


def write_spans(path, spans, t0: float):
    """One JSON line a span, times in seconds from t0."""
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps({"name": s.name, "request": s.request, "start_s": s.start - t0,
                                "end_s": s.end - t0}) + "\n")


class Event(NamedTuple):
    name: str
    start: int   # ns on the profiler's clock
    end: int


def kineto_events(prof):
    """(device events, host events) of a finished trace, from the profiler's
    raw Kineto results. Ranges opened by `record_function` appear on both
    sides; the device side's copies are left out, so that the device's
    events are its kernels, copies and fills alone."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != cuda:
            host.append(ev)
        elif not (e.is_user_annotation() or ev.name.startswith("bench.")):
            device.append(ev)
    device.sort(key=lambda e: e.start)
    return device, host


def union_ns(events) -> int:
    """The length of the union of the events' intervals (sorted by start)."""
    total, end = 0, None
    for e in events:
        if end is None or e.start > end:
            total += e.end - e.start
            end = e.end
        elif e.end > end:
            total += e.end - end
            end = e.end
    return total


def top_device_ops(events, top=10):
    """[[name, seconds]] of the device operations that took the most time."""
    by_name: dict[str, int] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + e.end - e.start
    ranked = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def idle_gaps(device, host, lo: int, hi: int, top=10, small_ns=10_000):
    """[[what the host was doing, seconds]]: the device's idle time in [lo,
    hi] summed by the innermost host range at each gap's middle, prefixed
    by the harness span around it; the largest `top` sums. Gaps under
    `small_ns` (the device's own between kernels of a graph or a queue)
    are summed as "device:between kernels"."""
    bench = [h for h in host if h.name.startswith("bench.") and h.name != "bench.request"]
    ops = sorted((h for h in host if not h.name.startswith("bench.") and h.end > lo
                  and h.start < hi and h.name not in PROFILER_OWN), key=lambda h: h.start)
    starts = [h.start for h in ops]
    gaps, cursor = [], lo
    for e in device:
        if e.start > cursor:
            gaps.append((cursor, min(e.start, hi)))
        cursor = max(cursor, e.end)
    if cursor < hi:
        gaps.append((cursor, hi))
    sums: dict[str, int] = {}
    for a, b in gaps:
        if b - a < small_ns:
            name = "device:between kernels"
        else:
            mid = (a + b) // 2
            outer = min((h for h in bench if h.start <= mid <= h.end),
                        key=lambda h: h.end - h.start, default=None)
            inner = None
            # the latest-starting range that covers mid is the innermost
            for k in range(bisect.bisect_right(starts, mid) - 1,
                           max(bisect.bisect_right(starts, mid) - 1 - SCAN_BACK, -1), -1):
                if ops[k].end >= mid:
                    inner = ops[k]
                    break
            name = ((outer.name[6:] if outer else "request") + ":"
                    + (inner.name if inner else "python"))
        sums[name] = sums.get(name, 0) + b - a
    ranked = sorted(sums.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def reads_in(fn):
    """fn() under sync debug mode "warn": (its result, the synchronising
    operations it ran)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = [w for w in caught if "synchroniz" in str(w.message)
             and SYNC_DEBUG_NOTICE not in str(w.message)]
    return out, len(reads)
