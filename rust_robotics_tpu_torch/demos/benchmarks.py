"""Deterministic benchmark registry + CSV regression gate.

The port of rust_robotics_tpu/demos/benchmarks.py. Reference: the 32
benchmark_* examples and the regression gate
(scripts/check_benchmark_gate.sh:20-33 runs 12 pinned deterministic
benchmarks, diffs their CSVs under docs/assets/ via
check_benchmark_gate.py — headers/rows exact, numerics to 1e-6,
wall-clock `*_ms/_us/_ns` columns ignored; BENCHMARKS.md:10-22. Pinned
functional metrics: path length, success rate, residual norms, collisions,
clearance, lap completion, BENCHMARKS.md:3-7). It is a functional gate,
not a speed benchmark.

`PINNED` maps the same 41 names to functions returning (header, rows);
`run_all(outdir)` writes `<outdir>/<name>.csv` (no default directory);
`check_gate(assets_dir)` compares a fresh run against the CSVs there with
`utils.bench_gate.compare_csv`.

Every bench runs on `device` (default cuda) in `dtype` (default float64,
the JAX package's x64 that wrote docs/assets/). The benches in `DRAWS`
draw where JAX's draw from a PRNG key: they take `draws=` (the values
JAX's split keys give, laid out as each docstring says) or a CPU
`torch.Generator`; without either, `DRAWS[name]` draws them from a CPU
generator seeded with JAX's key number. Draws are made on the CPU in
float64 and moved to the device, so a bench's own draws are the same on
every device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device
from rust_robotics_tpu_torch._numeric import norm2
from rust_robotics_tpu_torch.utils.bench_gate import compare_csv, write_csv

__all__ = ["PINNED", "DRAWS", "run_benchmark", "run_all", "check_gate"]

F64 = torch.float64


def _fmt(v):
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, float):
        return f"{v:.9g}"
    return str(v)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(draws, dev, f):
    """draws (a tensor, an array or a tuple of them) as `f` on `dev`."""
    if isinstance(draws, (tuple, list)):
        return type(draws)(_on(d, dev, f) for d in draws)
    return _float_on(draws, dev, f)


def _draws(name, draws, generator):
    """`draws`, else `DRAWS[name]` from `generator` (else a CPU generator
    seeded with JAX's key number)."""
    if draws is not None:
        return draws
    maker, seed = DRAWS[name]
    return maker(generator if generator is not None else torch.Generator().manual_seed(seed))


def _normals(g, shape):
    return torch.randn(shape, generator=g, dtype=F64)


def _uniforms(g, shape):
    return torch.rand(shape, generator=g, dtype=F64)


# ---------------------------------------------------------------------------
# The reference's pinned families


def bench_ekf_localization(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.ekf_localization import run_ekf_localization_demo

    out = run_ekf_localization_demo(steps=330, device=device, dtype=dtype)
    err = _np(out["estimate"])[:, :2] - _np(out["truth"])[:, :2]
    rmse = float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))
    header = ["steps", "position_rmse", "final_error"]
    rows = [[330, rmse, float(np.linalg.norm(err[-1]))]]
    return header, rows


def bench_pose_graph(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.pose_graph_bench import rmse, synthesize_chain
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    header = ["size", "iterations", "rmse"]
    rows = []
    for size in (50, 200):
        truth, initial, ef, et, meas, info = synthesize_chain(size)
        poses, summary = optimize_pose_graph_2d(initial, ef, et, meas, info, device=device,
                                                dtype=dtype)
        rows.append([size, int(summary.iterations), rmse(_np(poses), truth)])
    return header, rows


def bench_grid_planners(device=None, dtype=F64):
    from rust_robotics_tpu_torch.planning.grid import grid_from_raster
    from rust_robotics_tpu_torch.planning.wavefront import plan_grid

    free = np.ones((64, 64), bool)
    free[20:44, 20] = False
    free[20, 20:50] = False
    grid = grid_from_raster(~free, resolution=1.0, device=device, dtype=dtype)
    header = ["connectivity", "path_cost", "path_cells"]
    rows = []
    for conn in (4, 8):
        path, cost = plan_grid(grid, (2.0, 2.0), (60.0, 60.0), connectivity=conn)
        rows.append([conn, float(cost), int(_np(path.mask).sum())])
    return header, rows


def bench_dwa_navigation(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.headless import headless_navigation_loop

    m = headless_navigation_loop(device=device, dtype=dtype)
    header = ["goal_reached", "path_length", "min_clearance", "mean_estimate_error"]
    rows = [[m["goal_reached"], m["path_length"], m["min_obstacle_clearance"],
             m["mean_estimate_error"]]]
    return header, rows


_RRT_OBS = [[5.0, 5.0], [3.0, 6.0], [7.0, 4.0]]
_RRT_RAD = [1.0, 0.8, 0.8]


def _rrt_config():
    from rust_robotics_tpu_torch.planning.rrt import RRTConfig

    return RRTConfig(expand_dis=1.0, max_nodes=300, connect_radius=2.5, goal_threshold=1.0)


def bench_rrt_star(device=None, dtype=F64, draws=None, generator=None):
    """draws [2, 299, 3]: `rrt_plan`'s uniforms of PRNGKey(0) and
    PRNGKey(1) (each seed's key serves both the RRT and the RRT*)."""
    from rust_robotics_tpu_torch.planning.rrt import rrt_plan

    dev = resolve_device(device)
    draws = _on(_draws("rrt-star-benchmark", draws, generator), dev, dtype)
    header = ["seed", "star", "cost", "nodes"]
    rows = []
    for seed in (0, 1):
        for star in (False, True):
            tree, best, cost = rrt_plan(None, [0.0, 0.0], [10.0, 10.0], _RRT_OBS, _RRT_RAD,
                                        _rrt_config(), star=star, draws=draws[seed],
                                        dtype=dtype, device=dev)
            rows.append([seed, star, float(cost), int(_np(tree.active).sum())])
    return header, rows


def bench_frenet(device=None, dtype=F64):
    from rust_robotics_tpu_torch.planning.curves import Spline2D
    from rust_robotics_tpu_torch.planning.frenet import frenet_optimal_plan

    dev = resolve_device(device)
    csp = Spline2D.fit([0.0, 10.0, 20.5, 35.0, 70.5], [0.0, -6.0, 5.0, 6.5, 0.0], dtype=dtype,
                       device=dev)
    obstacles = _float_on([[20.0, 10.0], [30.0, 6.0], [35.0, 8.0]], dev, dtype)
    out = frenet_optimal_plan(csp, 0.0, 10.0 / 3.6, 2.0, 0.0, 0.0, obstacles)
    header = ["best_cost", "valid_candidates", "any_valid"]
    rows = [[float(out["cost"]), int(out["num_valid"]), bool(out["any_valid"])]]
    return header, rows


def _mppi_run(dynamics, stage, terminal, state, cfg, draws):
    """`len(draws)` receding-horizon MPPI steps from `state`; step k plans
    on draws[k]. Returns the final state and the last diagnostics."""
    from rust_robotics_tpu_torch.control.mppi import mppi_plan, shift_nominal

    u = torch.zeros((cfg.horizon, 2), dtype=state.dtype, device=state.device)
    diag = None
    for k in range(draws.shape[0]):
        u, first, diag = mppi_plan(None, dynamics, stage, terminal, state, u, cfg,
                                   draws=draws[k])
        state = dynamics(state, first, cfg.dt)
        u = shift_nominal(u)
    return state, diag


def bench_mppi(device=None, dtype=F64, draws=None, generator=None):
    """draws [40, 256, 25, 2]: the standard normals of the 40 subkeys
    split off PRNGKey(0), one a step."""
    from rust_robotics_tpu_torch.control.mppi import (
        MPPIConfig, double_integrator_dynamics, make_goal_costs)

    dev = resolve_device(device)
    draws = _on(_draws("mppi-benchmark", draws, generator), dev, dtype)
    cfg = MPPIConfig(horizon=25, num_samples=256)
    goal = _float_on([5.0, 5.0], dev, dtype)
    stage, terminal = make_goal_costs(goal)
    state, diag = _mppi_run(double_integrator_dynamics, stage, terminal,
                            torch.zeros(4, dtype=dtype, device=dev), cfg, draws)
    header = ["final_distance", "final_speed", "best_cost"]
    rows = [[float(norm2(state[:2] - 5.0)), float(norm2(state[2:])), float(diag.best_cost)]]
    return header, rows


def _value_grid_scene(dev, f):
    """bench_mppi_value's 48² grid behind a wall: (free [48, 48] host
    bool, the goal, its cell, res, origin)."""
    res, origin, w, h = 0.25, (-2.0, -4.0), 48, 48
    goal = (6.0, 0.0)
    free = np.ones((w, h), bool)
    wall_x = int((2.5 - origin[0]) / res)
    wall_top = int((2.0 - origin[1]) / res)
    free[wall_x:wall_x + 2, :wall_top] = False
    goal_idx = (int((goal[0] - origin[0]) / res), int((goal[1] - origin[1]) / res))
    return free, _float_on(goal, dev, f), goal_idx, res, origin


def _value_grid(free, goal_idx, res, origin, dev, f):
    """The wavefront terminal-value grid of the scene (one B2 launch on
    the card)."""
    from rust_robotics_tpu_torch.control.mppi_value import TerminalValueGrid
    from rust_robotics_tpu_torch.planning.wavefront import goal_raster, wavefront_costs

    free_t = torch.as_tensor(free, device=dev)
    goals = goal_raster(free.shape, torch.as_tensor(goal_idx, device=dev))
    vals = wavefront_costs(free_t, goals, dtype=f) * res
    return TerminalValueGrid(_float_on(origin, dev, f), _float_on(res, dev, f), vals)


def bench_mppi_value(device=None, dtype=F64, draws=None, generator=None):
    """Value-guided vs vanilla MPPI behind a wall (mppi.rs:362 terminal
    value grids + :1114 terminal_value_cost): the wavefront-derived value
    grid steers around the obstacle, the quadratic terminal does not.

    draws [70, 512, 25, 2]: the standard normals of the 70 subkeys split
    off PRNGKey(7), one a step (both runs use the same key)."""
    from rust_robotics_tpu_torch.control.mppi import (
        MPPIConfig, double_integrator_dynamics, make_goal_costs)
    from rust_robotics_tpu_torch.control.mppi_value import make_value_terminal_cost

    dev, f = resolve_device(device), dtype
    draws = _on(_draws("mppi-value-benchmark", draws, generator), dev, f)
    free, goal, goal_idx, res, origin = _value_grid_scene(dev, f)
    vgrid = _value_grid(free, goal_idx, res, origin, dev, f)
    obstacle_pts = np.argwhere(~free) * res + np.asarray(origin) + res / 2
    stage, quad_terminal = make_goal_costs(goal, obstacles=_float_on(obstacle_pts, dev, f),
                                           obstacle_radius=0.4, obstacle_weight=500.0)
    cfg = MPPIConfig(horizon=25, num_samples=512, noise_sigma=(0.8, 0.8))

    def run(terminal):
        state, _ = _mppi_run(double_integrator_dynamics, stage, terminal,
                             torch.zeros(4, dtype=f, device=dev), cfg, draws)
        return float(norm2(state[:2] - goal))

    d_value = run(make_value_terminal_cost(vgrid, weight=30.0))
    d_vanilla = run(quad_terminal)
    header = ["variant", "final_distance", "beats_vanilla"]
    rows = [["value_guided", d_value, int(d_value < d_vanilla)],
            ["vanilla_quadratic", d_vanilla, 0]]
    return header, rows


def bench_controller_arena(device=None, dtype=F64):
    from rust_robotics_tpu_torch.control.arena import run_controller_arena

    _, (header, rows) = run_controller_arena(steps=500, dtype=dtype, device=device)
    return header, rows


def bench_icp(device=None, dtype=F64, draws=None, generator=None):
    """draws [120, 2]: `jax.random.uniform(PRNGKey(3), (120, 2))`, the
    reference cloud before its scale by 10."""
    from rust_robotics_tpu_torch.slam.icp import icp_matching

    dev = resolve_device(device)
    pts = _on(_draws("icp-benchmark", draws, generator), dev, dtype) * 10.0
    c, s = math.cos(0.3), math.sin(0.3)
    rot = _float_on([[c, -s], [s, c]], dev, dtype)
    cur = pts @ rot.T + _float_on([1.0, -0.5], dev, dtype)
    res = icp_matching(pts, cur, device=dev)
    header = ["iterations", "final_error_mean", "inlier_ratio_5cm", "converged"]
    rows = [[int(res.iterations), float(res.final_error_mean), float(res.inlier_ratio_5cm),
             bool(res.converged)]]
    return header, rows


def bench_particle_filter(device=None, dtype=F64, draws=None, generator=None):
    """draws (init [512, 4] normals of PRNGKey(1); predict [60, 512, 2]
    normals and resample [60, 1] uniforms: step k splits its k1 of
    split(key, 3) into the predict and resample keys, as `pf_step` does)."""
    from rust_robotics_tpu_torch.filters.particle import (
        ParticleBelief, inverse_cdf, pf_estimate, pf_predict, pf_update_ranges,
        resample_if_needed, systematic_positions)
    from rust_robotics_tpu_torch.models.motion import unicycle_propagate

    dev, f = resolve_device(device), dtype
    init, pred, unif = _on(_draws("particle-filter-benchmark", draws, generator), dev, f)
    landmarks = _float_on([[10.0, 0.0], [10.0, 10.0], [0.0, 15.0], [-5.0, 20.0]], dev, f)
    n_p = init.shape[0]
    belief = ParticleBelief(init * 0.1, torch.full((n_p,), 1.0 / n_p, dtype=f, device=dev))
    truth = torch.zeros(4, dtype=f, device=dev)
    u = _float_on([1.0, 0.1], dev, f)
    noise_std = _float_on([0.1, 0.05], dev, f)
    wiggle = _float_on(np.arange(4.0), dev, f)
    errs = []
    for k in range(60):
        truth = unicycle_propagate(truth, u, 0.1)
        ranges = norm2(landmarks - truth[:2]) + 0.05 * torch.sin(wiggle + 0.3 * k)
        # pf_step with the step's draws: predict, weight, maybe-resample
        belief = pf_predict(belief, u, 0.1, noise_std, noise=pred[k])
        belief = pf_update_ranges(belief, ranges, landmarks, 0.2)
        belief = resample_if_needed(
            belief, None,
            method=lambda _, w, uk=unif[k]: inverse_cdf(w, systematic_positions(uk, n_p)))
        errs.append(float(norm2(pf_estimate(belief).mean[:2] - truth[:2])))
    header = ["steps", "final_error", "mean_error"]
    rows = [[60, errs[-1], float(np.mean(errs))]]
    return header, rows


def bench_coverage(device=None, dtype=F64):
    from rust_robotics_tpu_torch.planning.coverage import (
        coverage_metrics, spiral_stc_plan, wavefront_cpp)

    blocked = np.zeros((12, 12), bool)
    blocked[5:7, 3:9] = True
    path, _ = wavefront_cpp(blocked, (0, 0), (11, 11), device=device, dtype=dtype)
    m = coverage_metrics(path, blocked)
    stc = spiral_stc_plan(np.ones((8, 8), bool), (0, 0))
    header = ["wavefront_coverage_ratio", "wavefront_revisits", "stc_mega_cells", "stc_edges"]
    rows = [[m["coverage_ratio"], m["revisits"], len({tuple(r) for r in stc["route"]}),
             len(stc["edges"])]]
    return header, rows


def bench_stl_cbs(device=None, dtype=F64):
    from rust_robotics_tpu_torch.planning.stl import first_conflict, stl_cbs_plan

    free = np.ones((9, 3), bool)
    out = stl_cbs_plan(free, [(0, 1), (8, 1)], [(8, 1), (0, 1)], t_max=20, device=device,
                       dtype=dtype)
    header = ["total_cost", "conflicts_resolved", "min_separation", "conflict_free"]
    rows = [[out["total_cost"], out["conflicts_resolved"],
             out["min_pairwise_separation_robustness"], first_conflict(out["paths"]) is None]]
    return header, rows


def bench_mission_recovery(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.headless import headless_mission_recovery

    m = headless_mission_recovery(device=device, dtype=dtype)
    header = ["mission_done", "recovery_count", "final_distance"]
    rows = [[m["mission_done"], m["recovery_count"], m["final_distance"]]]
    return header, rows


def bench_slam_node(device=None, dtype=F64):
    from rust_robotics_tpu_torch.slam.slam_node import run_slam_node_loop

    out = run_slam_node_loop(steps=30, device=device, dtype=dtype)
    d = out["diagnostics"]
    accepted = int(np.sum(_np(d.reason_xy) == 0))
    header = ["final_pose_error", "final_odom_error", "accepted_scans", "mean_alpha_xy",
              "submap_points"]
    rows = [[float(d.pose_error[-1]), float(d.odom_error[-1]), accepted,
             float(np.mean(_np(d.alpha_xy))), int(d.submap_points[-1])]]
    return header, rows


def bench_arm_rrt_star(device=None, dtype=F64, draws=None, generator=None):
    """draws (rand [190, 7] uniforms in [−π, π), bias [190] uniforms):
    iteration i's two subkeys of PRNGKey(0)'s chain, key, k1, k2 =
    split(key, 3)."""
    from rust_robotics_tpu_torch.control.arm import rrt_star_arm_plan

    dev, f = resolve_device(device), dtype
    rand, bias = _on(_draws("arm-rrt-star-benchmark", draws, generator), dev, f)
    out = rrt_star_arm_plan(
        None, torch.zeros(7, dtype=f, device=dev), torch.full((7,), 0.6, dtype=f, device=dev),
        torch.full((7,), 0.5, dtype=f, device=dev),
        _float_on([[1.2, 0.6, 0.3], [0.8, -0.8, 0.5]], dev, f), _float_on([0.25, 0.25], dev, f),
        max_nodes=192, step_size=0.5, rewire_radius=1.2, edge_checks=6, path_len=32,
        draws=(rand, bias))
    header = ["found", "cost", "waypoints"]
    rows = [[bool(out["found"]), float(out["cost"]), int(_np(out["mask"]).sum())]]
    return header, rows


def _sampling_problems():
    from rust_robotics_tpu_torch.experiments.point_cloud_sampling import CloudCase

    return {
        "point_cloud_sampling": [
            CloudCase("plane_baseline", (24,), base_point_count=96)],
        "occlusion_corruption": [
            CloudCase("ring_sector", (24,), kind="ring", base_point_count=96,
                      corruption="sector_drop", sector_start=0.4, sector_end=1.8,
                      drop_probability=0.9)],
    }


def bench_sampling_quality(device=None, dtype=F64, draws=None, generator=None):
    """draws {(family name, bucket): CellDraws} of the two cells (JAX's
    splits of key 0 folded with each family's CRC32 and the bucket, as
    tests/test_torch_experiments.py builds them)."""
    from rust_robotics_tpu_torch.experiments.point_cloud_sampling import (
        run_point_cloud_sampling_quality)

    dev = resolve_device(device)
    draws = {cell: type(d)(*(None if x is None else x.to(dev) for x in d))
             for cell, d in _draws("sampling-quality-benchmark", draws, generator).items()}
    reports = run_point_cloud_sampling_quality(
        0, problems=_sampling_problems(), scenarios_per_bucket=4, max_iter=256, draws=draws,
        dtype=dtype, device=dev)
    header = ["variant", "agreement_vs_reference", "coverage_ratio", "winner_case0"]
    rows = [[name, rep["agreement_vs_reference"], rep["average_coverage_ratio"],
             rep["observations"][0].winner()]
            for name, rep in sorted(reports.items())]
    return header, rows


# ---------------------------------------------------------------------------
# Round-2 breadth: the remaining reference benchmark_* families
# (benchmark_localizers.rs, benchmark_admm_*.rs, benchmark_cbf_safety_filter.rs,
#  benchmark_conformal_*.rs, benchmark_factor_graph_scaling.rs,
#  benchmark_hierarchical_mapf_*.rs, benchmark_meta_control.rs,
#  benchmark_pusher_slider*.rs, benchmark_racing_*.rs,
#  benchmark_rigid_body_backends.rs, benchmark_traversal_risk_sweep.rs,
#  benchmark_branchout_closed_loop.rs, benchmark_adap_rpf_metrics.rs)


def bench_localizers(device=None, dtype=F64, draws=None, generator=None):
    """draws: `headless_localizers`' (init [512, 4], predict [120, 512, 2],
    resample [120, 1]) of JAX's keys 0 and 1."""
    from rust_robotics_tpu_torch.demos.headless_family import headless_localizers

    draws = _draws("localizers-benchmark", draws, generator)
    out = headless_localizers(steps=120, device=device, dtype=dtype, draws=draws)
    header = ["filter", "position_rmse"]
    rows = [[n, out[f"{n}_rmse"]] for n in ("ekf", "ukf", "ckf", "pf")]
    return header, rows


def bench_admm_formation(device=None, dtype=F64):
    from rust_robotics_tpu_torch.control.admm import ADMMConfig, solve_formation_consensus

    dev = resolve_device(device)
    offsets = _float_on([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], dev, dtype)
    positions = _float_on([[5.8, 2.1], [4.1, 2.0], [5.1, 2.9], [4.9, 1.2]], dev, dtype)
    center, targets, res = solve_formation_consensus(positions, offsets,
                                                     cfg=ADMMConfig(iterations=200))
    header = ["agents", "center_x", "center_y", "primal_residual", "max_offset_error"]
    err = float(torch.max(norm2((targets - center) - offsets)))
    rows = [[4, float(center[0]), float(center[1]), float(res.primal_residual), err]]
    return header, rows


def bench_admm_graph_consensus(device=None, dtype=F64):
    from rust_robotics_tpu_torch._numeric import linspace
    from rust_robotics_tpu_torch.control.admm import ADMMConfig, solve_consensus

    dev = resolve_device(device)
    header = ["agents", "consensus_x", "consensus_y", "primal_residual", "mean_error"]
    rows = []
    for n in (3, 8):
        t = torch.stack([linspace(4.0, n, dtype=dtype, device=dev),
                         torch.sin(linspace(3.0, n, dtype=dtype, device=dev))], dim=-1)
        res = solve_consensus(t, cfg=ADMMConfig(iterations=300))
        rows.append([n, float(res.z[0]), float(res.z[1]), float(res.primal_residual),
                     float(torch.mean(norm2(t - res.z)))])
    return header, rows


def bench_cbf_safety_filter(device=None, dtype=F64):
    from rust_robotics_tpu_torch.control.cbf import CBFConfig, cbf_filter_single_integrator

    dev, f = resolve_device(device), dtype
    cfg = CBFConfig(alpha=2.0)
    obstacles = _float_on([[2.0, 0.0]], dev, f)
    radii = _float_on([1.0], dev, f)
    u_des = _float_on([1.5, 0.0], dev, f)
    pos = torch.zeros(2, dtype=f, device=dev)
    dt = 0.05
    min_h = np.inf
    for _ in range(150):
        u = cbf_filter_single_integrator(pos, u_des, obstacles, radii, cfg)
        pos = pos + dt * u
        min_h = min(min_h, float(torch.sum((pos - obstacles[0]) ** 2) - radii[0] ** 2))
    far = cbf_filter_single_integrator(_float_on([-50.0, 0.0], dev, f), u_des, obstacles, radii,
                                       cfg)
    header = ["steps", "min_barrier_value", "barrier_maintained", "inactive_far_error"]
    rows = [[150, min_h, min_h > -0.05, float(norm2(far - u_des))]]
    return header, rows


def bench_conformal_coverage(device=None, dtype=F64):
    from rust_robotics_tpu_torch.planning.conformal import (
        calibration_errors_from_trajectories, conformal_radius_at, empirical_quantile)

    t = np.arange(12, dtype=float)
    pred = np.stack([t, 0.5 * np.sin(0.3 * t)], -1)[None]
    obs = pred + 0.3 * np.stack([np.sin(1.1 * t), np.cos(0.7 * t)], -1)[None]
    errs = calibration_errors_from_trajectories(pred, obs, device=device, dtype=dtype)
    header = ["horizon", "q50", "q90", "radius_90"]
    rows = []
    for k in (2, 6, 11):
        s = errs[k]
        rows.append([k, float(empirical_quantile(s, 0.5)), float(empirical_quantile(s, 0.9)),
                     float(conformal_radius_at(errs, k, 0.9, obstacle_radius=0.5))])
    return header, rows


def bench_conformal_sipp(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.headless_family import headless_conformal_sipp

    out = headless_conformal_sipp(device=device, dtype=dtype)
    header = ["arrival", "min_confidence", "trajectory_violation_bound"]
    rows = [[out["arrival"], out["min_confidence"], out["trajectory_violation_bound"]]]
    return header, rows


def bench_factor_graph_scaling(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.pose_graph_bench import rmse, synthesize_chain
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    header = ["size", "solver", "iterations", "rmse"]
    rows = []
    for size, solver in ((100, "dense"), (100, "pcg"), (400, "dense")):
        truth, initial, ef, et, meas, info = synthesize_chain(size)
        poses, summary = optimize_pose_graph_2d(initial, ef, et, meas, info,
                                                linear_solver=solver, device=device,
                                                dtype=dtype)
        rows.append([size, solver, int(summary.iterations), rmse(_np(poses), truth)])
    return header, rows


def bench_hierarchical_mapf(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.headless_family import (
        headless_hierarchical_mapf_replanning)
    from rust_robotics_tpu_torch.planning.stl import hierarchical_mapf_plan

    out = headless_hierarchical_mapf_replanning(device=device, dtype=dtype)
    header = ["scenario", "makespan", "success", "region_conflicts"]
    rows = [["base", out["base_makespan"], out["base_success"], out["region_conflicts"]],
            ["narrowed_door", out["replan_makespan"], out["replan_success"],
             out["region_conflicts"]]]
    # scale row (benchmark_hierarchical_mapf_scale.rs): 6 agents on 32x32
    free = np.ones((32, 32), bool)
    free[16, 4:28] = False
    starts = [(2, 2), (2, 29), (29, 2), (4, 16), (29, 16), (16, 2)]
    goals = [(29, 29), (29, 2), (2, 29), (28, 16), (4, 15), (16, 29)]
    big = hierarchical_mapf_plan(free, starts, goals, t_max=96, region_size=8, device=device,
                                 dtype=dtype)
    arr = _np(big["arrivals"])
    rows.append(["six_agents_32x32", int(arr.max()), bool(np.all(arr >= 0)),
                 int(big["region_conflicts"])])
    return header, rows


def _meta_course(dev, f):
    from rust_robotics_tpu_torch._numeric import linspace

    xs = linspace(40.0, 401, dtype=f, device=dev)
    return torch.stack([xs, 2.0 * torch.sin(xs / 8.0)], dim=-1), torch.ones(401, dtype=f,
                                                                            device=dev)


def bench_meta_control(device=None, dtype=F64):
    from rust_robotics_tpu_torch.control.meta import meta_control_step
    from rust_robotics_tpu_torch.control.trackers import (
        bicycle_kinematics, pure_pursuit_control, stanley_control)

    dev, f = resolve_device(device), dtype
    pts, mask = _meta_course(dev, f)
    state = _float_on([0.0, -1.0, 0.2, 1.0], dev, f)
    use = torch.zeros((), dtype=torch.bool, device=dev)
    ema = torch.zeros((), dtype=f, device=dev)
    switches = 0
    prev = False
    for _ in range(200):
        accel, steer, use, ema = meta_control_step(
            state, pts, mask, 3.0, use, ema,
            lambda s: pure_pursuit_control(s, pts, mask, 3.0),
            lambda s: stanley_control(s, pts, mask, 3.0))
        cur = bool(use)
        switches += int(cur != prev)
        prev = cur
        state = bicycle_kinematics(state, accel, steer, 0.1, 2.9)
    d = norm2(pts[:, :2] - state[:2])
    header = ["steps", "progress_x", "final_cross_track", "switches"]
    rows = [[200, float(state[0]), float(torch.min(d)), switches]]
    return header, rows


def bench_pusher_slider(device=None, dtype=F64, draws=None, generator=None):
    """draws [40, 4, 64, 12, 3]: step i's four faces' standard normals,
    split(split(PRNGKey(0), 40)[i], 4)."""
    from rust_robotics_tpu_torch.control.pusher_slider import (
        PusherMppiConfig, PusherSliderParams, simulate_push, two_contact_twist)

    dev, f = resolve_device(device), dtype
    draws = _on(_draws("pusher-slider-benchmark", draws, generator), dev, f)
    p = PusherSliderParams(half_extent=0.5, char_len=0.35, pusher_friction=0.3)
    rep = simulate_push(None, p, start=[0.0, 0.0, 0.0], goal=[1.2, 0.6, 0.0], steps=40,
                        cfg=PusherMppiConfig(horizon=12, num_samples=64), goal_tol=0.12,
                        draws=draws, dtype=f, device=dev)
    header = ["variant", "final_position_error", "faces_used", "finite"]
    rows = [["single_contact_mppi", float(rep["final_position_error"]),
             len(set(_np(rep["faces"]).tolist())),
             bool(np.all(np.isfinite(rep["trajectory"])))]]
    # two-contact couple on opposite faces: spin-dominant twist
    twist, modes, valid = two_contact_twist(p, faces=(0, 2), contacts=(0.0, 0.0),
                                            push_speeds=(0.05, 0.05), tangent_speeds=(0.5, 0.5),
                                            dtype=f, device=dev)
    rows.append(["two_contact_couple", float(norm2(twist[:2])), 2,
                 bool(valid) and abs(float(twist[2])) > 0.1])
    return header, rows


def bench_racing_motor(device=None, dtype=F64):
    from rust_robotics_tpu_torch.control.racing import (
        MotorQuadParams, hover_state, motor_quad_step)

    dev, f = resolve_device(device), dtype
    p = MotorQuadParams()
    s = hover_state(0.0, 0.0, 1.5, p, dtype=f, device=dev)
    hover_cmd = torch.full((4,), p.gravity / 4.0, dtype=f, device=dev)  # unit mass
    for _ in range(100):
        s = motor_quad_step(p, s, hover_cmd, 0.01)
    header = ["steps", "hover_drift", "final_vertical_speed", "finite"]
    rows = [[100, float(norm2(s[:3] - _float_on([0.0, 0.0, 1.5], dev, f))),
             float(torch.abs(s[5])), bool(torch.all(torch.isfinite(s)))]]
    return header, rows


def bench_racing_powertrain(device=None, dtype=F64, draws=None, generator=None):
    """draws: `headless_mppi_racing_gate_progress`'s [90, 128, 15, 4]
    normals, the subkeys of its PRNGKey(0)."""
    from rust_robotics_tpu_torch.demos.headless_family import headless_mppi_racing_gate_progress

    draws = _draws("racing-powertrain-benchmark", draws, generator)
    out = headless_mppi_racing_gate_progress(device=device, dtype=dtype, draws=draws)
    header = ["gates_passed", "lap_fraction", "saturation_fraction", "final_soc"]
    rows = [[out["gates_passed"], out["lap_fraction"], out["saturation_fraction"],
             out["final_soc"]]]
    return header, rows


def bench_rigid_body_backends(device=None, dtype=F64, draws=None, generator=None):
    """draws: the integer that seeds the RRT backend's NumPy generator
    (JAX: `jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)`)."""
    from rust_robotics_tpu_torch.planning.rigid_body import (
        RigidBodyConfig, aabb_obstacle, rigid_body_lattice_plan, rigid_body_rrt_plan)

    dev = resolve_device(device)
    seed = int(_draws("rigid-body-backends-benchmark", draws, generator))
    cfg = RigidBodyConfig(position_step=0.5, heading_count=8)
    obstacles = (aabb_obstacle(3.5, 6.5, 0.0, 6.0, dtype=dtype, device=dev),)
    header = ["backend", "path_length", "min_separation_margin"]
    lat = rigid_body_lattice_plan((1.0, 1.0, 0.0), (9.0, 1.0, 0.0), obstacles, cfg)
    rows = [["lattice", lat["path_length"], lat["min_separation_margin"]]]
    rrt = rigid_body_rrt_plan(seed, (1.0, 1.0, 0.0), (9.0, 1.0, 0.0), obstacles, cfg,
                              max_nodes=600)
    rows.append(["rrt", rrt["path_length"], rrt["min_separation_margin"]])
    return header, rows


def bench_traversal_risk_sweep(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.headless_family import _ridge_elevation
    from rust_robotics_tpu_torch.planning.risk_graph import (
        sweep_risk_weights, terrain_risk_from_elevation)

    dev = resolve_device(device)
    risk = terrain_risk_from_elevation(_ridge_elevation(), blocking_step_height=1.0,
                                       device=dev, dtype=dtype)
    out = sweep_risk_weights(risk, (0, 4), (14, 4),
                             risk_weights=_float_on([0.0, 2.0, 8.0], dev, dtype))
    header = ["risk_weight", "cost", "path_cells"]
    rows = [[float(o["risk_weight"]), float(o["cost"]), int(_np(o["path_mask"]).sum())]
            for o in out]
    return header, rows


def bench_branchout_closed_loop(device=None, dtype=F64):
    from rust_robotics_tpu_torch.demos.headless_family import (
        headless_branchout_multimodal_driving)

    out = headless_branchout_multimodal_driving(device=device, dtype=dtype)
    header = ["route_completion", "no_collision_rate", "min_clearance", "modes_used"]
    rows = [[out["route_completion"], out["no_collision_rate"], out["min_clearance"],
             out["modes_used"]]]
    return header, rows


def bench_adap_rpf_metrics(device=None, dtype=F64, draws=None, generator=None):
    """draws: `headless_adap_rpf_mppi`'s [24, 360, 16, 2] normals of the
    24 subkeys of its PRNGKey(5), shared by both runs."""
    from rust_robotics_tpu_torch.demos.headless_family import headless_adap_rpf_mppi

    draws = _draws("adap-rpf-metrics-benchmark", draws, generator)
    out = headless_adap_rpf_mppi(steps=24, device=device, dtype=dtype, draws=draws)
    header = ["sampler", "mean_occlusion", "mean_proximity", "final_distance"]
    rows = [["fixed_back_point", out["fixed_mean_occlusion"], out["fixed_mean_proximity"],
             out["fixed_final_distance"]],
            ["adaptive_rpf", out["adaptive_mean_occlusion"], out["adaptive_mean_proximity"],
             out["adaptive_final_distance"]]]
    return header, rows


def bench_safe_decode(device=None, dtype=F64):
    from rust_robotics_tpu_torch.planning.stl import StlRectangle, safe_decode_nav

    free = np.ones((12, 12), bool)
    hazard = StlRectangle(3.0, 8.0, 3.0, 8.0)
    out = safe_decode_nav(free, (0, 0), (11, 11), t_max=30, avoid_regions=((hazard, (0, 29)),),
                          device=device, dtype=dtype)
    header = ["overrides", "greedy_avoid_robustness", "shielded_avoid_robustness",
              "robustness_gain"]
    rows = [[int(out["overrides"]), float(out["greedy_avoid_robustness"]),
             float(out["shielded_avoid_robustness"]), float(out["robustness_gain"])]]
    return header, rows


def _square_gates(radius=3.0, height=1.5, aperture=1.2):
    from rust_robotics_tpu_torch.control.racing import GatePlane

    def gate(center, normal):
        return GatePlane(center, normal, half_width=aperture, half_height=aperture)

    return [
        gate((radius, 0.0, height), (0.0, 1.0, 0.0)),
        gate((0.0, radius, height), (-1.0, 0.0, 0.0)),
        gate((-radius, 0.0, height), (0.0, -1.0, 0.0)),
        gate((0.0, -radius, height), (1.0, 0.0, 0.0)),
    ]


def _race(draws, params, device, dtype, steps=60, gates=None, **kw):
    """One gate race (K 128, H 14) on `draws` [steps, 128, 14, 4]."""
    from rust_robotics_tpu_torch.control.racing import simulate_gate_race

    return simulate_gate_race(None, gates or _square_gates(), params, start=(3.0, -3.0, 1.5),
                              steps=steps, num_samples=128, horizon=14, draws=draws[:steps],
                              dtype=dtype, device=device, **kw)


def _race_draws(steps):
    return lambda g: _normals(g, (steps, 128, 14, 4))


def bench_racing_mppi_3d(device=None, dtype=F64, draws=None, generator=None):
    """benchmark_racing_mppi_3d.rs analog: gate lap racing with ideal
    actuators at two aperture settings.

    draws [60, 128, 14, 4]: the normals of PRNGKey(11)'s 60 step keys
    (both apertures race on the same key)."""
    from rust_robotics_tpu_torch.control.racing import MotorQuadParams, PowertrainParams

    dev = resolve_device(device)
    draws = _on(_draws("racing-mppi-3d-benchmark", draws, generator), dev, dtype)
    header = ["scenario", "gates", "gates_passed", "lap_fraction", "mean_speed", "max_speed",
              "path_length"]
    rows = []
    for scen, aperture in (("open", 1.6), ("tight", 1.0)):
        out = _race(draws, PowertrainParams.ideal(MotorQuadParams()), dev, dtype,
                    gates=_square_gates(aperture=aperture))
        traj = out["trajectory"]
        plen = float(np.sum(np.linalg.norm(np.diff(traj[:, :3], axis=0), axis=1)))
        rows.append([scen, 4, out["gates_passed"], out["lap_fraction"], out["mean_speed"],
                     out["max_speed"], plen])
    return header, rows


def bench_racing_quadrotor(device=None, dtype=F64, draws=None, generator=None):
    """benchmark_racing_quadrotor.rs analog: motor-level quad race with
    attitude metrics (tilt from the body-z / world-z angle).

    draws [60, 128, 14, 4]: the normals of PRNGKey(13)'s step keys."""
    from rust_robotics_tpu_torch.control.racing import MotorQuadParams, PowertrainParams

    dev = resolve_device(device)
    draws = _on(_draws("racing-quadrotor-benchmark", draws, generator), dev, dtype)
    out = _race(draws, PowertrainParams.ideal(MotorQuadParams()), dev, dtype)
    traj = out["trajectory"]
    q = traj[:, 6:10]  # [w, x, y, z]
    # body-z in world = rotate (0,0,1): z-component = 1 - 2(x² + y²)
    cos_tilt = np.clip(1.0 - 2.0 * (q[:, 1] ** 2 + q[:, 2] ** 2), -1, 1)
    tilt = np.degrees(np.arccos(cos_tilt))
    rates = np.linalg.norm(traj[:, 10:13], axis=1)
    header = ["gates", "gates_passed", "lap_fraction", "mean_speed", "mean_tilt_deg",
              "max_tilt_deg", "mean_body_rate"]
    rows = [[4, out["gates_passed"], out["lap_fraction"], out["mean_speed"],
             float(tilt.mean()), float(tilt.max()), float(rates.mean())]]
    return header, rows


def bench_racing_powertrain_aware(device=None, dtype=F64, draws=None, generator=None):
    """benchmark_racing_powertrain_aware.rs analog: planning through the
    real powertrain vs planning with ideal actuators (both EXECUTE through
    the real powertrain).

    draws [60, 128, 14, 4]: the normals of PRNGKey(17)'s step keys (both
    scenarios race on the same key)."""
    from rust_robotics_tpu_torch.control.racing import PowertrainParams

    dev = resolve_device(device)
    draws = _on(_draws("racing-powertrain-aware-benchmark", draws, generator), dev, dtype)
    params = PowertrainParams(sag_coeff=0.35, discharge_rate=0.12)
    header = ["scenario", "aware", "gates_passed", "lap_fraction", "mean_speed",
              "saturation_fraction", "min_soc", "final_soc"]
    rows = []
    for scen, aware in (("unaware", False), ("aware", True)):
        out = _race(draws, params, dev, dtype, aware=aware)
        rows.append([scen, int(aware), out["gates_passed"], out["lap_fraction"],
                     out["mean_speed"], out["saturation_fraction"], out["min_soc"],
                     out["final_soc"]])
    return header, rows


def bench_racing_powertrain_budget(device=None, dtype=F64, draws=None, generator=None):
    """benchmark_racing_powertrain_budget.rs analog: ChargeBudget sweep —
    penalizing load below the reserve preserves state of charge.

    draws [60, 128, 14, 4]: the normals of PRNGKey(19)'s step keys (every
    weight races on the same key)."""
    from rust_robotics_tpu_torch.control.racing import PowertrainParams

    dev = resolve_device(device)
    draws = _on(_draws("racing-powertrain-budget-benchmark", draws, generator), dev, dtype)
    params = PowertrainParams(sag_coeff=0.2, discharge_rate=0.25)
    header = ["charge_weight", "gates_passed", "lap_fraction", "mean_speed", "min_soc",
              "final_soc"]
    rows = []
    for weight in (0.0, 2.0, 8.0):
        out = _race(draws, params, dev, dtype, charge_weight=weight, charge_reserve=0.9)
        rows.append([weight, out["gates_passed"], out["lap_fraction"], out["mean_speed"],
                     out["min_soc"], out["final_soc"]])
    return header, rows


def bench_racing_powertrain_endurance(device=None, dtype=F64, draws=None, generator=None):
    """benchmark_racing_powertrain_endurance.rs analog: long race under
    fatigue (relaxation build-up) with and without recovery dynamics.

    draws [80, 128, 14, 4]: the normals of PRNGKey(23)'s 80 step keys
    (both scenarios race on the same key)."""
    from rust_robotics_tpu_torch.control.racing import PowertrainParams

    dev = resolve_device(device)
    draws = _on(_draws("racing-powertrain-endurance-benchmark", draws, generator), dev, dtype)
    header = ["scenario", "recovery", "gates_passed", "lap_fraction", "mean_speed",
              "saturation_fraction", "min_soc", "final_soc"]
    rows = []
    for scen, recover in (("no_recovery", 0.0), ("recovery", 0.8)):
        params = PowertrainParams(sag_coeff=0.25, discharge_rate=0.1, relax_build=0.5,
                                  relax_recover=recover, relax_coeff=0.3)
        out = _race(draws, params, dev, dtype, steps=80, aware=True)
        rows.append([scen, int(recover > 0), out["gates_passed"], out["lap_fraction"],
                     out["mean_speed"], out["saturation_fraction"], out["min_soc"],
                     out["final_soc"]])
    return header, rows


def bench_racing_powertrain_recovery(device=None, dtype=F64):
    """benchmark_racing_powertrain_recovery.rs analog: open-loop
    square-wave load profile; terminal voltage with vs without relaxation
    recovery (no MPPI — pure battery dynamics trace)."""
    from rust_robotics_tpu_torch.control.racing import (
        MotorQuadParams, PowertrainParams, _voltage_scale, hover_state, powertrain_init,
        powertrain_step)

    dev, f = resolve_device(device), dtype
    base = MotorQuadParams()
    common = dict(sag_coeff=0.25, discharge_rate=0.15, relax_build=0.6, relax_coeff=0.25)
    p_no = PowertrainParams(base, **common, relax_recover=0.0)
    p_re = PowertrainParams(base, **common, relax_recover=1.2)
    dt = 0.1
    hover = base.gravity / 4.0
    header = ["step", "time", "load_fraction", "soc", "voltage_no_recovery", "voltage_recovery",
              "relaxation_recovery"]
    rows = []
    s_no = powertrain_init(hover_state(0.0, 0.0, 1.5, base, dtype=f, device=dev), p_no)
    s_re = powertrain_init(hover_state(0.0, 0.0, 1.5, base, dtype=f, device=dev), p_re)
    for i in range(40):
        burst = (i // 10) % 2 == 0  # 1 s on / 1 s off square wave
        cmd = torch.full((4,), (1.8 if burst else 0.6) * hover, dtype=f, device=dev)
        s_no = powertrain_step(p_no, s_no, cmd, dt)
        s_re = powertrain_step(p_re, s_re, cmd, dt)
        load = torch.clamp(torch.sum(s_re[14:18]) / (4.0 * base.max_rotor_thrust), 0.0, 1.0)
        v_no = float(_voltage_scale(p_no, s_no[18], load, s_no[19]))
        v_re = float(_voltage_scale(p_re, s_re[18], load, s_re[19]))
        rows.append([i, (i + 1) * dt, float(load), float(s_re[18]), v_no, v_re, float(s_re[19])])
    return header, rows


def bench_admm_horizon_consensus(device=None, dtype=F64):
    """benchmark_admm_horizon_consensus.rs analog: receding-horizon
    formation consensus tracking an L-corner goal with per-agent noise;
    stiff (no smoothing) vs smooth executed center paths + metrics."""
    from rust_robotics_tpu_torch.control.admm import ADMMConfig, solve_horizon_consensus

    dev = resolve_device(device)
    cycles, horizon, dx, corner, amp = 34, 10, 0.18, 18, 0.25

    def goal(step):
        if step <= corner:
            return np.array([step * dx, 0.0])
        return np.array([corner * dx, (step - corner) * dx])

    def run(smooth_weight):
        center = goal(0)
        path = [center]
        for c in range(cycles):
            goals = np.stack([goal(c + t) for t in range(horizon)])
            trajs = []
            for a in range(4):
                noise = np.stack([
                    [amp * np.sin(2.1 * a + 0.7 * (c + t)),
                     amp * np.cos(1.3 * a + 0.9 * (c + t))]
                    for t in range(horizon)])
                trajs.append(goals + noise)
            z, _ = solve_horizon_consensus(_float_on(np.stack(trajs), dev, dtype),
                                           _float_on(center, dev, dtype),
                                           smooth_weight=smooth_weight,
                                           cfg=ADMMConfig(iterations=120))
            center = _np(z[1])  # execute the first step
            path.append(center)
        path = np.stack(path)
        accel = np.diff(path, 2, axis=0)
        rms_accel = float(np.sqrt(np.mean(np.sum(accel ** 2, -1))))
        track = float(np.mean([np.linalg.norm(path[c] - goal(c)) for c in range(len(path))]))
        return path, rms_accel, track

    stiff_path, stiff_acc, stiff_track = run(0.0)
    smooth_path, smooth_acc, smooth_track = run(40.0)
    header = ["cycle", "goal_x", "goal_y", "stiff_x", "stiff_y", "smooth_x", "smooth_y"]
    rows = []
    for c in range(cycles + 1):
        g = goal(c)
        rows.append([c, g[0], g[1], stiff_path[c, 0], stiff_path[c, 1], smooth_path[c, 0],
                     smooth_path[c, 1]])
    rows.append(["metrics", stiff_acc, stiff_track, smooth_acc, smooth_track,
                 stiff_acc / max(smooth_acc, 1e-12), 0.0])
    return header, rows


PINNED = {
    "ekf-localization-benchmark": bench_ekf_localization,
    "admm-horizon-consensus-benchmark": bench_admm_horizon_consensus,
    "racing-mppi-3d-benchmark": bench_racing_mppi_3d,
    "racing-quadrotor-benchmark": bench_racing_quadrotor,
    "racing-powertrain-aware-benchmark": bench_racing_powertrain_aware,
    "racing-powertrain-budget-benchmark": bench_racing_powertrain_budget,
    "racing-powertrain-endurance-benchmark": bench_racing_powertrain_endurance,
    "racing-powertrain-recovery-benchmark": bench_racing_powertrain_recovery,
    "pose-graph-benchmark": bench_pose_graph,
    "grid-planner-benchmark": bench_grid_planners,
    "dwa-navigation-benchmark": bench_dwa_navigation,
    "rrt-star-benchmark": bench_rrt_star,
    "frenet-benchmark": bench_frenet,
    "mppi-benchmark": bench_mppi,
    "mppi-value-benchmark": bench_mppi_value,
    "controller-arena-benchmark": bench_controller_arena,
    "icp-benchmark": bench_icp,
    "particle-filter-benchmark": bench_particle_filter,
    "coverage-benchmark": bench_coverage,
    "stl-cbs-benchmark": bench_stl_cbs,
    "mission-recovery-benchmark": bench_mission_recovery,
    "slam-node-benchmark": bench_slam_node,
    "arm-rrt-star-benchmark": bench_arm_rrt_star,
    "sampling-quality-benchmark": bench_sampling_quality,
    "localizers-benchmark": bench_localizers,
    "admm-formation-benchmark": bench_admm_formation,
    "admm-graph-consensus-benchmark": bench_admm_graph_consensus,
    "cbf-safety-filter-benchmark": bench_cbf_safety_filter,
    "conformal-coverage-benchmark": bench_conformal_coverage,
    "conformal-sipp-benchmark": bench_conformal_sipp,
    "factor-graph-scaling-benchmark": bench_factor_graph_scaling,
    "hierarchical-mapf-benchmark": bench_hierarchical_mapf,
    "meta-control-benchmark": bench_meta_control,
    "pusher-slider-benchmark": bench_pusher_slider,
    "racing-motor-benchmark": bench_racing_motor,
    "racing-powertrain-benchmark": bench_racing_powertrain,
    "rigid-body-backends-benchmark": bench_rigid_body_backends,
    "traversal-risk-sweep-benchmark": bench_traversal_risk_sweep,
    "branchout-closed-loop-benchmark": bench_branchout_closed_loop,
    "adap-rpf-metrics-benchmark": bench_adap_rpf_metrics,
    "safe-decode-benchmark": bench_safe_decode,
}


# ---------------------------------------------------------------------------
# The benches' own draws: {name: (maker(generator) -> draws, JAX's key number)}


def _sampling_draws(g):
    """The two cells' `CellDraws` from the CPU generator `g`, the Poisson
    sampler's first points among each cloud's valid ones."""
    from rust_robotics_tpu_torch.experiments import point_cloud_sampling as pcs

    out = {}
    for cases in _sampling_problems().values():
        for case in cases:
            for bucket in case.buckets:
                d = pcs.draw_cell(g, case, 4, 256, F64, "cpu")
                _, valid = pcs._generate_cell_clouds(case, bucket, d)
                lanes = len(pcs._POISSON_FACTORS)
                first = torch.multinomial(valid.double().repeat_interleave(lanes, 0), 1,
                                          generator=g)
                out[case.family_name, bucket] = d._replace(poisson_first=first.reshape(4, lanes))
    return out


def _headless_draws(shapes):
    """Draws laid out as a headless demo's: normals, then uniforms where
    the shape is marked "u"."""
    def make(g):
        return tuple(_uniforms(g, s[1]) if s[0] == "u" else _normals(g, s[1]) for s in shapes)
    return make


DRAWS = {
    "rrt-star-benchmark": (lambda g: _uniforms(g, (2, 299, 3)), 0),
    "mppi-benchmark": (lambda g: _normals(g, (40, 256, 25, 2)), 0),
    "mppi-value-benchmark": (lambda g: _normals(g, (70, 512, 25, 2)), 7),
    "icp-benchmark": (lambda g: _uniforms(g, (120, 2)), 3),
    "particle-filter-benchmark": (_headless_draws(
        [("n", (512, 4)), ("n", (60, 512, 2)), ("u", (60, 1))]), 0),
    "arm-rrt-star-benchmark": (
        lambda g: (-math.pi + 2.0 * math.pi * _uniforms(g, (190, 7)), _uniforms(g, (190,))), 0),
    "sampling-quality-benchmark": (_sampling_draws, 0),
    "localizers-benchmark": (_headless_draws(
        [("n", (512, 4)), ("n", (120, 512, 2)), ("u", (120, 1))]), 0),
    "pusher-slider-benchmark": (lambda g: _normals(g, (40, 4, 64, 12, 3)), 0),
    "racing-powertrain-benchmark": (lambda g: _normals(g, (90, 128, 15, 4)), 0),
    "rigid-body-backends-benchmark": (
        lambda g: int(torch.randint(0, 2**31 - 1, (), generator=g)), 0),
    "adap-rpf-metrics-benchmark": (lambda g: _normals(g, (24, 360, 16, 2)), 5),
    "racing-mppi-3d-benchmark": (_race_draws(60), 11),
    "racing-quadrotor-benchmark": (_race_draws(60), 13),
    "racing-powertrain-aware-benchmark": (_race_draws(60), 17),
    "racing-powertrain-budget-benchmark": (_race_draws(60), 19),
    "racing-powertrain-endurance-benchmark": (_race_draws(80), 23),
}


def run_benchmark(name, device=None, draws=None, generator=None):
    """(header, rows) of one pinned bench in f64, every value formatted as
    the CSV holds it. `draws` and `generator` go to the benches of `DRAWS`."""
    kw = {"device": resolve_device(device)}
    if name in DRAWS:
        kw.update(draws=draws, generator=generator)
    elif draws is not None or generator is not None:
        raise ValueError(f"{name} draws nothing")
    header, rows = PINNED[name](**kw)
    rows = [[_fmt(v) for v in r] for r in rows]
    return header, rows


def run_all(outdir, device=None):
    """Write every pinned bench's CSV into `outdir` (no default)."""
    os.makedirs(outdir, exist_ok=True)
    paths = {}
    for name in sorted(PINNED):
        header, rows = run_benchmark(name, device=device)
        p = os.path.join(outdir, f"{name}.csv")
        write_csv(p, header, rows)
        paths[name] = p
    return paths


def csv_text(header, rows):
    """The CSV text `check_gate` compares."""
    return ",".join(header) + "\n" + "\n".join(",".join(r) for r in rows) + "\n"


def check_gate(assets_dir, names=None, device=None, draws=None):
    """Re-run every pinned benchmark (or `names`) and diff against the
    CSVs in `assets_dir` (check_benchmark_gate.py contract). `draws`:
    {name: draws} for benches of `DRAWS`. Returns (ok, failures)."""
    failures = []
    draws = draws or {}
    for name in sorted(names or PINNED):
        base = os.path.join(assets_dir, f"{name}.csv")
        if not os.path.exists(base):
            failures.append((name, "missing baseline"))
            continue
        header, rows = run_benchmark(name, device=device, draws=draws.get(name))
        with open(base) as fh:
            problems = compare_csv(fh.read(), csv_text(header, rows))
        if problems:
            failures.append((name, problems))
    return len(failures) == 0, failures
