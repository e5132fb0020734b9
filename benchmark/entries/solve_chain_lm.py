"""Entry "solve_chain_lm": G graphs in lock-step, as the port's
`run_batched_benchmark` drives them: `classify_chain_edges` on the host,
the arrays uploaded, `nlls/tridiag.py::solve_chain_lm` over [G, n, 3] with
`se2_edge_residual` / `se2_retract`, the poses and the summary read back."""

import numpy as np
import torch

HOST_DTYPE = np.float32  # uploaded as it is
NUMERICAL_FAILURE = 4    # the port's termination code


class Entry:
    def __init__(self, cell):
        """Set-up: import the program's entry points."""
        from rust_robotics_tpu_torch.nlls import tridiag
        from rust_robotics_tpu_torch.slam import pose_graph

        self.cell = cell
        self.classify, self.solve = tridiag.classify_chain_edges, tridiag.solve_chain_lm
        self.residual, self.retract = pose_graph.se2_edge_residual, pose_graph.se2_retract

    def __call__(self, x0, span):
        """(poses [G, n, 3] on the host, the batch's LM steps, graphs
        stopped on a numerical failure)."""
        c, cfg = self.cell, self.cell.config
        with span("classify"):
            c_meas, c_info, l_ef, l_et, l_meas, l_info = self.classify(
                c.n, c.ef, c.et, c.meas, c.info)
        with span("upload"):
            dev, dt = c.device, c.dtype
            values = torch.from_numpy(x0).to(dev)
            args = (torch.as_tensor(c_meas, dtype=dt, device=dev),
                    torch.as_tensor(c_info, dtype=dt, device=dev),
                    torch.as_tensor(l_ef, dtype=torch.int64, device=dev),
                    torch.as_tensor(l_et, dtype=torch.int64, device=dev),
                    torch.as_tensor(l_meas, dtype=dt, device=dev),
                    torch.as_tensor(l_info, dtype=dt, device=dev),
                    torch.arange(c.n, device=dev) < 1)
        with span("entry"):
            tol = cfg["tolerance"]
            values, summary = self.solve(
                values, *args, residual_fn=self.residual, retract_fn=self.retract, tdim=3,
                max_iterations=cfg["max_iterations"], gradient_tolerance=tol,
                step_tolerance=tol, cost_tolerance=tol * tol)
        with span("readback"):
            host = values.cpu().numpy()
            counts = torch.stack([summary.iterations.max(),
                                  (summary.termination_code == NUMERICAL_FAILURE).sum()])
            iterations, stopped = (int(v) for v in counts.cpu())
        return host, iterations, stopped
