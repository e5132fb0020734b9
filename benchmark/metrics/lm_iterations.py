"""lm_iterations: the LM steps a request ran, averaged over the window's
requests; the entry's own count (`SolverSummary.iterations`, or in
lock-step the batch's, the most any graph ran)."""


def read(run):
    iterations = [r.iterations for r in run.requests]
    return sum(iterations) / len(iterations) if iterations else None
