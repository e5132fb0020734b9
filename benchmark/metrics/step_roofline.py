"""step_roofline: the least time of one LM iteration, the larger of its
operations over the card's float32 peak and its bytes over the card's
memory bandwidth (`benchmark/workmodel.py`), as a share of the device's
busy time an iteration in the profiled requests. Records which bound
applies as the run's "step_roofline_bound"."""

from benchmark import workmodel


def read(run):
    t = run.trace
    peaks = workmodel.card_peaks(run.device_name)
    iterations = sum(r.iterations for r in t.requests) if t else 0
    if not t or not t.device or not iterations or peaks is None:
        return None
    least, bound = workmodel.least_time(run.work, peaks)
    run.notes["step_roofline_bound"] = bound
    return 100.0 * least / (t.busy_s / iterations)
