"""launches_per_iter: the device operations (kernels, copies, fills) of the
profiled requests, from the profiler's trace, over the LM steps they ran."""


def read(run):
    t = run.trace
    iterations = sum(r.iterations for r in t.requests) if t else 0
    if not t or not t.device or not iterations:
        return None
    return len(t.device) / iterations
