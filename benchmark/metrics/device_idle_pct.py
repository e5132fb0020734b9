"""device_idle_pct: the share of the window's time, from send to poses on
the host, in which no device operation ran, outside the profiler:
1 − busy_ms_per_iter / host_ms_per_iter, the device's busy time an LM step
(profiled requests) over the host-clock time an LM step (the requests that
ran outside the profiler and sync debug mode). Under the profiler each
CUDA graph replay's launch takes milliseconds of host time (the tracer
instruments every kernel of the graph), so the traced window's own idle
share, 1 − busy_s / window_s of the result's `device`, reads the tracer."""

from benchmark.metrics import busy_ms_per_iter, host_ms_per_iter


def read(run):
    busy, host = busy_ms_per_iter.read(run), host_ms_per_iter.read(run)
    if busy is None or not host:
        return None
    return 100.0 * (1.0 - busy / host)
