"""reads_per_iter: the synchronising operations (device reads, and copies
from pageable host memory) of one request of the window, counted under
torch's sync debug mode "warn", over the LM steps it ran."""


def read(run):
    t = run.trace
    if t is None or t.reads is None or not t.read_iterations:
        return None
    return t.reads / t.read_iterations
