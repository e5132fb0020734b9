"""host_ms_per_iter: the host-clock time of the window's requests that ran
outside the profiler and sync debug mode, from send to poses on the host,
over the LM steps they ran, in ms."""


def read(run):
    t = run.trace
    watched = {r.index for r in t.requests} if t else set()
    plain = [r for r in run.requests if r.index not in watched and r.reads is None]
    iterations = sum(r.iterations for r in plain)
    if not iterations:
        return None
    return 1e3 * sum(r.done - r.sent for r in plain) / iterations
