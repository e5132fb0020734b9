"""Deterministic pose-graph benchmark problems and their runners on the port.

The problem generators are the port's own copy (numpy only) of
rust_robotics_tpu/demos/pose_graph_bench.py, itself the reference's
benchmark problem (crates/rust_robotics/examples/
benchmark_large_pose_graph.rs:19-56): a sinusoidal ground-truth chain,
deterministic sinusoid perturbations of the initial guess, odometry edges
(information 100·I) and loop edges every 100 poses (20·I); RMSE gate
< 5e-3 (:97); LM at most 25 iterations, tolerance 1e-8 (:66-75). Plus the
100×100 grid of `synthesize_grid`, a graph with no odometry chain, and the
SE(3) chain of `synthesize_se3_chain` on a 30-unit workspace (host f64
through the port's `core/lie_np.py`).

The runners time the port's solvers as the JAX package's runners time its
own: one untimed call on the same shapes first, then the timed call, ended
by a host read of the result (`.cpu()`), on the host clock.
- `run_large_benchmark`: `run_large_benchmark(device_resident=True)`,
  chain_direct (the 10k chain; the 100k chain takes the nested solve);
- `run_batched_benchmark`: `run_batched_benchmark`, B distinct graphs in
  lock-step through `solve_chain_lm` (the serving row: 256 × 200);
- `run_grid_benchmark`: `run_grid_benchmark`, banded_direct on the grid.
Each takes `runs` timed calls after the warm one and reports the best, as
bench.py keeps the faster of two.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core import lie_np


def relative(a, b):
    """benchmark_large_pose_graph.rs:11-16 (yaw left unwrapped, as in the
    reference), over leading axes ([..., 3] inputs)."""
    a = np.asarray(a)
    b = np.asarray(b)
    s, c = np.sin(a[..., 2]), np.cos(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy, b[..., 2] - a[..., 2]], axis=-1)


def synthesize_chain(size: int, loop_stride: int = 100):
    """Returns (truth [N,3], initial [N,3], edges_from, edges_to,
    measurements [E,3], information [E,3,3]); a loop closure every
    `loop_stride` poses (the reference's 100, benchmark_large_pose_graph.rs:47-51)."""
    i = np.arange(size, dtype=np.float64)
    x = i * 0.05
    truth = np.stack([x, 2.0 * np.sin(x * 0.015), 0.03 * np.cos(x * 0.015)], axis=-1)
    initial = truth + np.stack([0.02 * np.sin(i * 0.013), 0.03 * np.cos(i * 0.021),
                                0.005 * np.sin(i * 0.017)], axis=-1)
    initial[0] = truth[0]
    ef_c = np.arange(size - 1, dtype=np.int32)
    et_c = ef_c + 1
    meas_c = relative(truth[:-1], truth[1:])
    ef_l = np.arange(0, max(size - loop_stride, 0), loop_stride, dtype=np.int32)
    et_l = ef_l + loop_stride
    meas_l = relative(truth[ef_l], truth[et_l])
    info = np.concatenate([
        np.broadcast_to(np.eye(3) * 100.0, (len(ef_c), 3, 3)),
        np.broadcast_to(np.eye(3) * 20.0, (len(ef_l), 3, 3)),
    ]).copy()
    return (truth, initial, np.concatenate([ef_c, ef_l]), np.concatenate([et_c, et_l]),
            np.concatenate([meas_c, meas_l]), info)


def rmse(poses, truth):
    """benchmark_large_pose_graph.rs:77-89: sqrt(mean over poses of summed
    squared (x, y, yaw) errors)."""
    d = np.asarray(poses) - truth
    return float(np.sqrt(np.mean(np.sum(d**2, axis=-1))))


def synthesize_se3_chain(size: int, loop_stride: int = 100):
    """The SE(3) analogue of `synthesize_chain` on a 30-unit workspace:
    sinusoidal SE(3) truth, exact relative measurements (odometry and a
    closure every `loop_stride` poses), a deterministic perturbation of the
    initial guess; host f64 throughout.

    Returns (truth_tangents [N,6], truth_mats [N,4,4], initial_tangents,
    ef, et, measurement_tangents [E,6], information [E,6,6])."""
    i = np.arange(size, dtype=np.float64)
    truth_t = np.stack([15 * np.sin(0.002 * i), 10 * np.sin(0.004 * i), 2 * np.sin(0.003 * i),
                        0.3 * np.sin(0.0017 * i), 0.3 * np.cos(0.0023 * i),
                        0.4 * np.sin(0.0011 * i)], -1)
    tm = lie_np.se3_exp(truth_t)
    inv = lie_np.se3_inverse(tm)
    mc = lie_np.se3_log(inv[:-1] @ tm[1:])
    ef_c = np.arange(size - 1, dtype=np.int32)
    et_c = ef_c + 1
    lf = np.arange(0, max(size - loop_stride, 0), loop_stride, dtype=np.int32)
    lt = lf + loop_stride
    ml = lie_np.se3_log(inv[lf] @ tm[lt])
    meas = np.concatenate([mc, ml])
    info = np.concatenate([
        np.broadcast_to(np.eye(6) * 100.0, (len(ef_c), 6, 6)),
        np.broadcast_to(np.eye(6) * 20.0, (len(lf), 6, 6)),
    ]).copy()
    initial_t = truth_t + np.stack(
        [0.02 * np.sin(i * 0.013), 0.03 * np.cos(i * 0.021), 0.005 * np.sin(i * 0.017),
         0.004 * np.cos(i * 0.019), 0.004 * np.sin(i * 0.023), 0.003 * np.cos(i * 0.029)], -1)
    initial_t[0] = truth_t[0]
    return (truth_t, tm, initial_t, np.concatenate([ef_c, lf]), np.concatenate([et_c, lt]),
            meas, info)


def se3_position_rmse(tangents, truth_mats):
    """Position RMSE of tangent-stored SE(3) poses against truth matrices."""
    if isinstance(tangents, torch.Tensor):
        tangents = tangents.detach().cpu().numpy()
    pos = lie_np.se3_exp(np.asarray(tangents, np.float64))[:, :3, 3]
    d = pos - truth_mats[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, -1))))


def synthesize_grid(width: int, height: int, diag_closures: int = 0):
    """Poses on a W×H grid (row-major) with 4-neighbour relative-pose edges
    (exact measurements and the deterministic perturbation of
    benchmark_large_pose_graph.rs:19-56) plus `diag_closures` long-range
    closures: a graph with no odometry chain. Returns (truth [N,3],
    initial [N,3], ef, et, meas [E,3], info [E,3,3])."""
    n = width * height
    ii = np.arange(n, dtype=np.float64)
    gx = (ii % width) * 0.5
    gy = (ii // width) * 0.5
    truth = np.stack([gx + 0.2 * np.sin(0.07 * gy), gy + 0.2 * np.cos(0.05 * gx),
                      0.3 * np.sin(0.011 * ii)], axis=-1)
    initial = truth + np.stack([0.02 * np.sin(ii * 0.013), 0.03 * np.cos(ii * 0.021),
                                0.005 * np.sin(ii * 0.017)], axis=-1)
    initial[0] = truth[0]

    ef, et, meas, info = [], [], [], []

    def add_edge(a, b, w):
        ef.append(a)
        et.append(b)
        meas.append(relative(truth[a], truth[b]))
        info.append(np.eye(3) * w)

    for r in range(height):
        for c_ in range(width):
            i = r * width + c_
            if c_ + 1 < width:
                add_edge(i, i + 1, 100.0)
            if r + 1 < height:
                add_edge(i, i + width, 100.0)
    for k in range(diag_closures):
        a = (k * 37) % (n // 2)
        b = n - 1 - ((k * 61) % (n // 2))
        if a != b:
            add_edge(a, b, 20.0)
    return (truth, initial, np.array(ef, np.int32), np.array(et, np.int32), np.stack(meas),
            np.stack(info))


def _best_of(call, runs):
    """One untimed call, then `runs` timed calls; returns (best seconds,
    the last call's result). `call` must end in a host read."""
    out = call()
    best = np.inf
    for _ in range(runs):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _optimize(truth, initial, ef, et, meas, info, linear_solver, max_iterations, tolerance,
              device, dtype, runs):
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    def call():
        poses, summary = optimize_pose_graph_2d(
            initial, ef, et, meas, info, max_iterations=max_iterations, tolerance=tolerance,
            linear_solver=linear_solver, device=device, dtype=dtype)
        return poses.cpu().numpy(), summary

    seconds, (poses, summary) = _best_of(call, runs)
    return seconds, rmse(poses, truth), summary


def run_large_benchmark(size=10000, max_iterations=25, tolerance=1e-8, device=None,
                        dtype=torch.float32, runs=1):
    """The chain benchmark on chain_direct (the JAX package's
    `run_large_benchmark(device_resident=True)`): host arrays in, poses back
    on the host. Returns (seconds, rmse, SolverSummary)."""
    return _optimize(*synthesize_chain(size), "chain_direct", max_iterations, tolerance,
                     resolve_device(device), dtype, runs)


def run_grid_benchmark(width=100, height=100, diag_closures=50, max_iterations=25,
                       tolerance=1e-8, device=None, dtype=torch.float32, runs=1):
    """The W×H grid with long closures on banded_direct. Returns (seconds,
    rmse, SolverSummary)."""
    return _optimize(*synthesize_grid(width, height, diag_closures), "banded_direct",
                     max_iterations, tolerance, resolve_device(device), dtype, runs)


def batched_problem(size, batch, device=None, dtype=torch.float32):
    """B distinct `size`-pose graphs: the chain of `synthesize_chain` with
    phase-shifted deterministic wobbles on the initial guess (as the JAX
    package's `run_batched_benchmark`). Returns (truth, init_b [B, n, 3],
    args): args are `solve_chain_lm`'s positional arguments after values0,
    on `device`."""
    from rust_robotics_tpu_torch.nlls.tridiag import classify_chain_edges

    device = resolve_device(device)
    truth, initial, ef, et, meas, info = synthesize_chain(size)
    c_meas, c_info, l_ef, l_et, l_meas, l_info = classify_chain_edges(size, ef, et, meas, info)
    wobbles = np.stack([0.01 * np.sin(np.arange(size * 3) * 0.01 + k).reshape(size, 3)
                        * [1.0, 1.0, 0.1] for k in range(batch)])
    init_b = torch.as_tensor(initial, dtype=dtype)[None] + torch.as_tensor(wobbles, dtype=dtype)
    init_b[:, 0] = torch.as_tensor(truth[0], dtype=dtype)
    fixed = torch.zeros(size, dtype=torch.bool)
    fixed[0] = True

    def tensor(x, dt=dtype):
        return None if x is None else torch.as_tensor(x, dtype=dt, device=device)

    args = (tensor(c_meas), tensor(c_info), tensor(l_ef, torch.int64), tensor(l_et, torch.int64),
            tensor(l_meas), tensor(l_info), fixed.to(device))
    return truth, init_b.to(device), args


def run_batched_benchmark(size=10000, batch=8, max_iterations=25, tolerance=1e-8, device=None,
                          dtype=torch.float32, runs=1):
    """B distinct graphs solved in lock-step by one batched `solve_chain_lm`
    (the JAX package vmaps its solver). Returns (seconds, worst rmse,
    graphs/s, values [B, n, 3] on the device, ChainSummary)."""
    from rust_robotics_tpu_torch.nlls.tridiag import solve_chain_lm
    from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

    truth, init_b, args = batched_problem(size, batch, device, dtype)

    def call():
        out = solve_chain_lm(init_b, *args, residual_fn=se2_edge_residual,
                             retract_fn=se2_retract, tdim=3, max_iterations=max_iterations,
                             gradient_tolerance=tolerance, step_tolerance=tolerance,
                             cost_tolerance=tolerance * tolerance)
        float(out[0][0, 0, 0])
        return out

    seconds, (out, summ) = _best_of(call, runs)
    host = out.cpu().numpy()
    worst = max(rmse(host[k], truth) for k in range(batch))
    return seconds, worst, batch / seconds, out, summ


def run_batched_compaction_benchmark(size=200, batch=256, chunk_iters=6, max_rounds=8,
                                     tolerance=1e-6, wobble_spread=True, device=None,
                                     dtype=torch.float32):
    """Batched small-graph serving without paying the slowest graph's
    iteration count everywhere (the JAX package's
    `run_batched_compaction_benchmark`): the batched chain LM runs in rounds
    of `chunk_iters` iterations; after each round the graphs whose
    termination code is non-zero (converged, or failed) leave, and the rest
    are packed into the next power-of-two bucket, padded with graph 0. Each
    round restarts the LM's damping.

    wobble_spread=True scales the B initial perturbations from 0.25× to 2×
    across the batch, so that graphs converge in different rounds. The
    default tolerance is 1e-6: below it, f32 graphs never report
    convergence and nothing leaves the batch.

    Returns (seconds, worst rmse, graphs/s, rounds_profile) with
    rounds_profile = [(bucket size, active graphs)] per round; one untimed
    sweep runs first, as in the JAX package, and the timed sweep ends in a
    host read."""
    from rust_robotics_tpu_torch.nlls.tridiag import classify_chain_edges, solve_chain_lm
    from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

    device = resolve_device(device)
    truth, initial, ef, et, meas, info = synthesize_chain(size)
    c_meas, c_info, l_ef, l_et, l_meas, l_info = classify_chain_edges(size, ef, et, meas, info)
    scale = (np.linspace(0.25, 2.0, batch)[:, None, None] if wobble_spread
             else np.ones((batch, 1, 1)))
    wobbles = scale * np.stack([0.01 * np.sin(np.arange(size * 3) * 0.01 + k).reshape(size, 3)
                                * [1.0, 1.0, 0.1] for k in range(batch)])
    init_b = np.asarray(initial)[None] + wobbles
    init_b[:, 0] = truth[0]
    init_b = torch.as_tensor(init_b, dtype=dtype, device=device)
    fixed = torch.zeros(size, dtype=torch.bool, device=device)
    fixed[0] = True

    def tensor(x, dt=dtype):
        return None if x is None else torch.as_tensor(x, dtype=dt, device=device)

    args = (tensor(c_meas), tensor(c_info), tensor(l_ef, torch.int64), tensor(l_et, torch.int64),
            tensor(l_meas), tensor(l_info), fixed)

    def sweep():
        values = init_b.clone()
        active = torch.arange(batch, device=device)
        n_active = batch
        profile = []
        for _ in range(max_rounds):
            if n_active == 0:
                break
            bucket = 1 << (n_active - 1).bit_length()
            idx = torch.cat([active, active.new_zeros(bucket - n_active)])
            out, summ = solve_chain_lm(
                values[idx], *args, residual_fn=se2_edge_residual, retract_fn=se2_retract,
                tdim=3, max_iterations=chunk_iters, gradient_tolerance=tolerance,
                step_tolerance=tolerance, cost_tolerance=tolerance * tolerance)
            values[active] = out[:n_active]
            profile.append((bucket, n_active))
            active = active[summ.termination_code[:n_active] == 0]  # 0 = max_iterations
            n_active = active.numel()
        return values, profile

    sweep()  # untimed, as the JAX package's warm-up sweep
    t0 = time.perf_counter()
    values, profile = sweep()
    host = values.cpu().numpy()
    seconds = time.perf_counter() - t0
    worst = max(rmse(host[k], truth) for k in range(batch))
    return seconds, worst, batch / seconds, profile
