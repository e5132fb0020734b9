"""busy_ms_per_iter: the device's busy time (the union of its operations in
the profiler's trace) of the profiled requests over the LM steps they ran,
in ms. The profiler slows the host's launches, not the device's work, so
beside `host_ms_per_iter` it gives the idle share of the untraced window:
1 − busy_ms_per_iter / host_ms_per_iter."""


def read(run):
    t = run.trace
    iterations = sum(r.iterations for r in t.requests) if t else 0
    if not t or not t.device or not iterations:
        return None
    return 1e3 * t.busy_s / iterations
