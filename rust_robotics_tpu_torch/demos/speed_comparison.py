"""Speed comparison: the reference's four headline workloads on the device.

The port of rust_robotics_tpu/demos/speed_comparison.py. Reference:
crates/rust_robotics/examples/speed_comparison.rs (:1-:139) — A* on a
walled 100×100 grid (100 runs), RRT among seven circles (500 iterations,
100 runs), EKF localization (1000 sequential steps), cubic spline course
(1000 runs); CSV `algorithm,rust_ms,runs` to stdout.

Both framings are reported — `ms_per_run` is the dependency-chained
sequential latency (one query, the device synchronised at both ends of
the timed loop, after a warm-up call), `ms_per_run_batched` divides one
batch of independent queries run as lanes by the batch size (the
deployment-relevant number for a planner or filter fleet on one card).
JAX's timings exclude its compile; on the card the RRT, EKF and spline
calls are likewise captured once, in the warm-up, as a CUDA graph that
each timed run replays (`GRAPHED`). The A* calls run eagerly, one
`wavefront_costs` call (B2, counted per launch) a run.

`REFERENCE_MS` are the reference's published numbers (README.md:397-400:
Rust and Python, one CPU core of the author's machine), not device
numbers.

Usage: python -m rust_robotics_tpu_torch.demos.speed_comparison [--runs N]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._graphs import Graphed

__all__ = ["run_speed_comparison", "REFERENCE_MS", "speed_workloads"]

# the workloads replayed as CUDA graphs on the card (their calls read
# nothing back and launch no counted kernel)
GRAPHED = ("rrt", "ekf", "cubic_spline")

# README.md:397-400 published baselines (ms; Rust, Python; single CPU core,
# the reference author's machine)
REFERENCE_MS = {
    "a_star": (4.0, 924.5),
    "rrt": (0.12, 5.7),
    "ekf": (0.19, 103.1),
    "cubic_spline": (0.92, 6.9),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, runs: int, device) -> float:
    """Marginal per-call wall ms, the device synchronised at both ends of
    the timed loop (a warm-up call first)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1000.0 / runs


def _grid_world(device, dtype):
    """speed_comparison.rs:17-40 obstacle layout via the GridMap builder."""
    from rust_robotics_tpu_torch.planning.grid import grid_from_obstacle_points

    ox, oy = [], []
    for i in range(101):
        ox += [float(i), float(i), 0.0, 100.0]
        oy += [0.0, 100.0, float(i), float(i)]
    for i in range(20, 80):
        ox.append(50.0)
        oy.append(float(i))
    return grid_from_obstacle_points(np.asarray(ox), np.asarray(oy), resolution=1.0,
                                     robot_radius=0.5, device=device, dtype=dtype)


def speed_workloads(batch: int = 32, device=None, dtype=torch.float32, generator=None,
                    rrt_draws=None):
    """The four workloads as {name: (one, many)}: `one()` runs a single
    query, `many()` `batch` independent queries as lanes. The RRT's
    uniforms are `rrt_draws` ([max_nodes − 1, 3] for `one`, [batch,
    max_nodes − 1, 3] for `many`), else drawn once from `generator`
    (seeded 0 without one)."""
    from rust_robotics_tpu_torch.core.types import GaussianBelief
    from rust_robotics_tpu_torch.filters.kalman import ekf_step, unicycle_position_model
    from rust_robotics_tpu_torch.planning.curves import calc_spline_course
    from rust_robotics_tpu_torch.planning.rrt import RRTConfig, rrt_plan
    from rust_robotics_tpu_torch.planning.wavefront import (
        extract_path, goal_raster, wavefront_costs)

    dev = resolve_device(device)
    f = dtype
    t = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev).to(f)  # noqa: E731
    out = {}

    # --- A* (100x100 walled grid, start (10,10) goal (90,90)) ------------
    grid = _grid_world(dev, f)
    free = grid.free()
    start_idx = grid.world_to_index(t([10.0, 10.0]))
    goal_idx = grid.world_to_index(t([90.0, 90.0]))
    offsets = torch.tensor([[i % 8, i // 8] for i in range(batch)], dtype=start_idx.dtype,
                           device=dev)
    starts = start_idx + offsets

    def astar(s_idx):
        costs = wavefront_costs(free, goal_raster(free.shape, goal_idx), dtype=f)
        return extract_path(costs, free, s_idx, max_len=512)[2]

    out["a_star"] = (lambda: astar(start_idx), lambda: astar(starts))

    # --- RRT (seven circles, 500 nodes) -----------------------------------
    obstacles = t([[5.0, 5.0], [3.0, 6.0], [3.0, 8.0], [3.0, 10.0], [7.0, 5.0], [9.0, 5.0],
                   [8.0, 10.0]])
    radii = t([1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0]) + 0.8
    cfg = RRTConfig(expand_dis=3.0, goal_sample_rate=0.05, max_nodes=500,
                    area_min=(-2.0, -2.0), area_max=(15.0, 15.0), goal_threshold=3.0)
    rrt_start, rrt_goal = t([0.0, 0.0]), t([6.0, 10.0])
    if rrt_draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        rrt_draws = (torch.rand((cfg.max_nodes - 1, 3), generator=generator, dtype=f,
                                device=dev),
                     torch.rand((batch, cfg.max_nodes - 1, 3), generator=generator, dtype=f,
                                device=dev))
    one_draws, many_draws = (torch.as_tensor(d, device=dev).to(f) for d in rrt_draws)

    def rrt(draws):
        return rrt_plan(None, rrt_start, rrt_goal, obstacles, radii, cfg, draws=draws)[2]

    out["rrt"] = (lambda: rrt(one_draws), lambda: rrt(many_draws))

    # --- EKF (1000 sequential steps, the reference's total-ms metric) ----
    model = unicycle_position_model()
    q = torch.diag(t([0.1, 0.1, np.deg2rad(1.0), 1.0])) ** 2
    r = torch.eye(2, dtype=f, device=dev)
    control = t([1.0, 0.1])
    steps = 1000
    ts = torch.arange(steps, device=dev).to(f)
    zs = torch.stack([0.1 * ts + 0.01 * ts, 0.005 * ts], -1)

    def ekf_chain(z):
        """z [..., steps, 2]: the means before each step [..., steps, 4]."""
        lead = z.shape[:-2]
        b = GaussianBelief(torch.zeros(lead + (4,), dtype=f, device=dev),
                           torch.eye(4, dtype=f, device=dev).expand(lead + (4, 4)))
        means = []
        for i in range(z.shape[-2]):
            means.append(b.mean)
            b = ekf_step(b, z[..., i, :], control, 0.1, q, r, model)
        return torch.stack(means, -2)

    zb = zs.expand((batch,) + zs.shape)
    out["ekf"] = (lambda: ekf_chain(zs), lambda: ekf_chain(zb))

    # --- Cubic spline course (the reference's 7-waypoint course) ---------
    wx = t([-2.5, 0.0, 2.5, 5.0, 7.5, 3.0, -1.0])
    wy = t([0.7, -6.0, 5.0, 6.5, 0.0, 5.0, -2.0])
    n_samples = 360  # static sample count (≈ length/0.1)

    def spline(x, y):
        return calc_spline_course(x, y, ds=0.1, num_points=n_samples)[0]

    xsb, ysb = wx.expand(batch, 7), wy.expand(batch, 7)
    out["cubic_spline"] = (lambda: spline(wx, wy), lambda: spline(xsb, ysb))
    return out


def run_speed_comparison(runs: int = 20, batch: int = 32, device=None, dtype=torch.float32,
                         generator=None):
    """Returns (header, rows) and prints the CSV."""
    dev = resolve_device(device)
    rows = []
    for name, (one, many) in speed_workloads(batch, dev, dtype, generator).items():
        if name in GRAPHED and dev.type == "cuda":
            with torch.cuda.device(dev):
                one, many = Graphed(one), Graphed(many)
        ms = _time_ms(one, runs, dev)
        ms_b = _time_ms(many, runs, dev) / batch
        rows.append((name, ms, runs, batch, ms_b))

    header = ("algorithm", "ms_per_run", "runs", "batch", "ms_per_run_batched",
              "reference_rust_ms", "reference_python_ms")
    out_rows = []
    print(",".join(header))
    for name, ms, n, b, ms_b in rows:
        ref_rust, ref_py = REFERENCE_MS[name]
        row = (name, f"{ms:.6f}", n, b, f"{ms_b:.6f}", ref_rust, ref_py)
        out_rows.append(row)
        print(",".join(str(c) for c in row))
    return header, out_rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run_speed_comparison(runs=args.runs, batch=args.batch, device=args.device)
