"""Entry "optimize_pose_graph_2d": one graph a request, host arrays into
`slam/pose_graph.py::optimize_pose_graph_2d` (it splits the edges on the
host, uploads and runs the chain LM), the poses read back."""

import numpy as np

HOST_DTYPE = np.float64  # the entry takes float64 host arrays


class Entry:
    def __init__(self, cell):
        """Set-up: import the program's entry point."""
        from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

        if cell.graphs != 1:
            raise ValueError("optimize_pose_graph_2d takes one graph a request")
        self.cell, self.solve = cell, optimize_pose_graph_2d

    def __call__(self, x0, span):
        """(poses [1, n, 3] on the host, LM steps, graphs stopped on a
        numerical failure)."""
        c, cfg = self.cell, self.cell.config
        with span("entry"):
            poses, summary = self.solve(
                x0[0], c.ef, c.et, c.meas, c.info, max_iterations=cfg["max_iterations"],
                tolerance=cfg["tolerance"], linear_solver=cfg["linear_solver"],
                device=c.device, dtype=c.dtype)
        with span("readback"):
            host = poses.cpu().numpy()[None]
        return host, summary.iterations, int(summary.termination == "numerical_failure")
