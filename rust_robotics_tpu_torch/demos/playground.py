"""Interactive playground generator.

The port of rust_robotics_tpu/demos/playground.py. The reference ships an
egui/eframe app compiled to native + wasm32 with five interactive tabs —
GridPlanners, Localization, Slam, AdmmFormation, ControllerArena
(crates/rust_robotics_playground/src/app.rs:10-16) — and URL-query state
sharing (src/share.rs), deployed next to the gallery
(.github/workflows/pages.yml).

This module is the dependency-light analog: it PRECOMPUTES parameter
sweeps for the same five tab families on the device and writes one
`data.json` plus a vanilla-JS `index.html` (this package's own copy of
`playground_page.html`) whose sliders/selects snap to the precomputed
grid, render on a <canvas>, and mirror their state into the URL query
string (shareable links, restored on load — the share.rs behavior).

Determinism: all sweeps are seeded/noise-free closed-form sims (the
reference gallery's own convention), so the artifact is reproducible; the
default is float64, as the reference artifact's. The grid tab makes 12
`wavefront_costs` calls (B2 each); the arena tab runs each controller's
three target speeds as lanes of one rollout, each lane bitwise its solo
run; on the card an ADMM run's horizon solves replay one CUDA graph.
`main` writes only into the directory it is given.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device
from rust_robotics_tpu_torch._graphs import Graphed


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Tab 1: GridPlanners — wavefront plans over maps x connectivity x inflation
# ---------------------------------------------------------------------------

def _maps(size=48):
    maps = {}
    # rooms: two walls with doors
    g = np.ones((size, size), bool)
    g[:, 18] = False
    g[10:14, 18] = True
    g[:, 34] = False
    g[38:42, 34] = True
    maps["rooms"] = g
    # bars: staggered horizontal bars
    g = np.ones((size, size), bool)
    for k, row in enumerate(range(8, size - 4, 8)):
        if k % 2 == 0:
            g[row, 0:size - 12] = False
        else:
            g[row, 12:size] = False
    maps["bars"] = g
    # blobs: deterministic pseudo-random circular obstacles
    g = np.ones((size, size), bool)
    rng = np.random.default_rng(7)
    for _ in range(10):
        cx, cy, r = rng.integers(6, size - 6), rng.integers(6, size - 6), \
            rng.integers(2, 5)
        yy, xx = np.mgrid[0:size, 0:size]
        g &= ((xx - cx) ** 2 + (yy - cy) ** 2) > r * r
    g[1, 1] = g[size - 2, size - 2] = True
    maps["blobs"] = g
    return maps


def _inflate(free, radius):
    if radius <= 0:
        return free
    from scipy.ndimage import binary_erosion

    return binary_erosion(free, iterations=radius, border_value=True)


def _grid_planners_tab(device=None, dtype=torch.float64):
    from rust_robotics_tpu_torch.planning.wavefront import extract_path, wavefront_costs

    dev = resolve_device(device)
    size = 48
    start = (1, 1)
    goal = (size - 2, size - 2)
    maps = _maps(size)
    runs = {}
    for mname, free0 in maps.items():
        for conn in (4, 8):
            for infl in (0, 1):
                free = _inflate(free0, infl)
                free[start] = free[goal] = True
                goals = np.zeros_like(free)
                goals[goal] = True
                free_t = torch.tensor(free, device=dev)
                costs = wavefront_costs(free_t, torch.tensor(goals, device=dev),
                                        connectivity=conn, dtype=dtype)
                idx, mask, cost = extract_path(costs, free_t, torch.tensor(start, device=dev),
                                               max_len=10 * size, connectivity=conn)
                path = _np(idx)[_np(mask)].tolist()
                runs[f"{mname}|{conn}|{infl}"] = {
                    "path": path,
                    "cost": round(float(cost), 3),
                    "reached": bool(len(path) > 0 and tuple(path[-1]) == goal),
                }
    return {
        "size": size,
        "start": list(start),
        "goal": list(goal),
        "maps": {k: [''.join('1' if c else '0' for c in row) for row in v]
                 for k, v in maps.items()},
        "params": {"map": list(maps), "connectivity": ["4", "8"], "inflation": ["0", "1"]},
        "runs": runs,
    }


# ---------------------------------------------------------------------------
# Tab 2: Localization — EKF under a noise-scale sweep
# ---------------------------------------------------------------------------

def _localization_tab(steps=240, device=None, dtype=torch.float64):
    """The 12 (measurement sigma, Q scale) runs as lanes of one EKF loop;
    the estimates and covariances are read once, at the end."""
    from rust_robotics_tpu_torch.core.types import GaussianBelief
    from rust_robotics_tpu_torch.filters.kalman import ekf_step
    from rust_robotics_tpu_torch.models.motion import unicycle_propagate

    dev = resolve_device(device)
    f = dtype
    dt = 0.1
    meas_sigmas = [0.1, 0.3, 0.6, 1.0]
    q_scales = [0.5, 1.0, 2.0]
    combos = [(ms, qs) for ms in meas_sigmas for qs in q_scales]
    ks = np.arange(steps)
    controls = torch.tensor(np.stack([np.ones(steps), 0.25 * np.sin(0.05 * ks)], -1),
                            device=dev).to(f)
    x = torch.zeros(4, dtype=f, device=dev)
    states = [x]
    for k in range(steps):
        x = unicycle_propagate(x, controls[k], dt)
        states.append(x)
    truth = _np(torch.stack(states))
    n = len(combos)
    ms = _float_on([c[0] for c in combos], dev, f)
    qs = _float_on([c[1] for c in combos], dev, f)
    q = torch.diag(_float_on([0.1, 0.1, 0.017, 0.3], dev, f)) ** 2 * qs[:, None, None]
    r = torch.eye(2, dtype=f, device=dev) * (ms ** 2)[:, None, None]
    # deterministic sinusoid "noise" (the reference gallery convention,
    # render_gif_ekf_localization.rs:21-24), made on the host
    noise = torch.tensor(np.stack([np.sin(1.3 * ks), np.cos(0.9 * ks)], -1),
                         device=dev).to(f)
    zs = torch.tensor(truth[1:, :2], device=dev)[None] + ms[:, None, None] * noise
    bel = GaussianBelief(torch.zeros((n, 4), dtype=f, device=dev),
                         torch.eye(4, dtype=f, device=dev).expand(n, 4, 4))
    means, covs = [], []
    for k in range(steps):
        bel = ekf_step(bel, zs[:, k], controls[k], dt, q, r)
        means.append(bel.mean[:, :2])
        if k % 12 == 0:
            covs.append(bel.cov[:, :2, :2])
    est_all = np.concatenate([np.zeros((n, 1, 2)), _np(torch.stack(means, 1))], 1)
    cov_all = _np(torch.stack(covs, 1))
    z_all = _np(zs)
    runs = {}
    for lane, (m_s, q_s) in enumerate(combos):
        est = est_all[lane]
        ell, meas = [], []
        for j, k in enumerate(range(0, steps, 12)):
            meas.append([round(float(z_all[lane, k, 0]), 3), round(float(z_all[lane, k, 1]), 3)])
            evals, evecs = np.linalg.eigh(cov_all[lane, j])
            ang = float(np.arctan2(evecs[1, 1], evecs[0, 1]))
            ell.append([round(est[k + 1][0], 3),
                        round(est[k + 1][1], 3),
                        round(2 * np.sqrt(max(evals[1], 0)), 3),
                        round(2 * np.sqrt(max(evals[0], 0)), 3),
                        round(ang, 3)])
        err = np.linalg.norm(est[1:] - truth[1:, :2], axis=1)
        runs[f"{m_s}|{q_s}"] = {
            "est": np.round(est[::4], 3).tolist(),
            "meas": meas,
            "ellipses": ell,
            "rmse": round(float(np.sqrt(np.mean(err ** 2))), 4),
        }
    return {
        "truth": np.round(truth[::4, :2], 3).tolist(),
        "params": {"meas_sigma": [str(v) for v in meas_sigmas],
                   "q_scale": [str(v) for v in q_scales]},
        "runs": runs,
    }


# ---------------------------------------------------------------------------
# Tab 3: Slam — pose-graph optimization under odometry-noise sweep
# ---------------------------------------------------------------------------

def _slam_tab(n=72, device=None, dtype=torch.float64):
    from rust_robotics_tpu_torch.demos.pose_graph_bench import relative
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    dev = resolve_device(device)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    noise_levels = [0.01, 0.04, 0.08]
    runs = {}
    for noise in noise_levels:
        for closures in (0, 1):
            drift = np.stack([
                noise * 40 * np.sin(0.11 * np.arange(n)),
                noise * 40 * np.cos(0.07 * np.arange(n)),
                noise * 6 * np.sin(0.05 * np.arange(n))], -1)
            initial = truth + drift
            initial[0] = truth[0]
            ef = list(range(n - 1))
            et = list(range(1, n))
            meas = [relative(truth[a], truth[b]) for a, b in zip(ef, et)]
            info = [np.eye(3) * 100.0] * (n - 1)
            if closures:
                for a, b in ((0, n // 2), (n // 4, 3 * n // 4), (0, n - 1)):
                    ef.append(a)
                    et.append(b)
                    meas.append(relative(truth[a], truth[b]))
                    info.append(np.eye(3) * 20.0)
            poses, summ = optimize_pose_graph_2d(
                initial, np.asarray(ef, np.int32), np.asarray(et, np.int32), np.stack(meas),
                np.stack(info), max_iterations=25, tolerance=1e-9, linear_solver="direct",
                device=dev, dtype=dtype)
            poses = _np(poses)
            err = np.linalg.norm(poses[:, :2] - truth[:, :2], axis=1)
            runs[f"{noise}|{closures}"] = {
                "initial": np.round(initial[:, :2], 3).tolist(),
                "optimized": np.round(poses[:, :2], 3).tolist(),
                "rmse": round(float(np.sqrt(np.mean(err ** 2))), 5),
                "iterations": int(summ.iterations),
            }
    return {
        "truth": np.round(truth[:, :2], 3).tolist(),
        "params": {"odom_noise": [str(v) for v in noise_levels], "closures": ["0", "1"]},
        "runs": runs,
    }


# ---------------------------------------------------------------------------
# Tab 4: AdmmFormation — horizon consensus under rho/lambda sweep
# ---------------------------------------------------------------------------

def _admm_tab(device=None, dtype=torch.float64):
    from rust_robotics_tpu_torch.control.admm import ADMMConfig, solve_horizon_consensus

    dev = resolve_device(device)
    rhos = [0.3, 1.0, 4.0]
    lams = [0.0, 10.0, 40.0]
    cycles, horizon = 26, 10

    def goal(step):
        if step <= 14:
            return np.array([step * 0.25, 0.0])
        return np.array([14 * 0.25, (step - 14) * 0.25])

    runs = {}
    for rho in rhos:
        for lam in lams:
            def solve(trajs, anchor, rho=rho, lam=lam):
                return solve_horizon_consensus(trajs, anchor, smooth_weight=lam,
                                               cfg=ADMMConfig(rho=rho, iterations=120))

            center = goal(0)
            path = [center]
            res_hist = []
            for c in range(cycles):
                goals = np.stack([goal(c + t) for t in range(horizon)])
                trajs = [goals + 0.22 * np.stack(
                    [[np.sin(2.1 * a + 0.7 * (c + t)), np.cos(1.3 * a + 0.9 * (c + t))]
                     for t in range(horizon)]) for a in range(4)]
                args = (torch.tensor(np.stack(trajs), device=dev).to(dtype),
                        torch.tensor(center, device=dev).to(dtype))
                if dev.type == "cuda" and c == 0:
                    # the run's 26 solves replay one graph of the solve
                    solve = Graphed(solve, *args)
                z, res = solve(*args)
                center = _np(z[1])
                path.append(center)
                res_hist.append(round(float(res.primal_residual), 6))
            path = np.stack(path)
            accel = np.diff(path, 2, axis=0)
            runs[f"{rho}|{lam}"] = {
                "center": np.round(path, 4).tolist(),
                "rms_accel": round(float(np.sqrt(np.mean(np.sum(accel ** 2, -1)))), 5),
                "primal_residual_last": res_hist[-1],
            }
    return {
        "goalpath": np.round(np.stack([goal(c) for c in range(cycles + 1)]), 4).tolist(),
        "params": {"rho": [str(v) for v in rhos], "smooth_weight": [str(v) for v in lams]},
        "runs": runs,
    }


# ---------------------------------------------------------------------------
# Tab 5: ControllerArena — tracker comparison under target-speed sweep
# ---------------------------------------------------------------------------

ARENA_SPEEDS = (2.0, 3.0, 4.5)
ARENA_CONTROLLERS = ("pure_pursuit", "stanley", "lqr_steer")


def arena_rollouts(name, speeds=ARENA_SPEEDS, steps=500, device=None, dtype=torch.float64):
    """One controller's rollouts on the arena course, a lane per target
    speed: the states [steps, len(speeds), 4] after each step, on the
    device, nothing read back. A lane is bitwise its solo run."""
    from rust_robotics_tpu_torch.control.trackers import (
        LQRSteerConfig, bicycle_kinematics, lqr_steer_control, pure_pursuit_control,
        stanley_control)

    dev = resolve_device(device)
    xs = np.linspace(0.0, 60.0, 601)
    ys = 3.0 * np.sin(xs / 8.0)
    pts = torch.tensor(np.stack([xs, ys], -1), device=dev).to(dtype)
    mask = torch.ones(601, dtype=dtype, device=dev)
    lanes = len(speeds)
    state = _float_on([0.0, -1.0, 0.2, 0.0], dev, dtype).expand(lanes, 4)
    v = _float_on(speeds, dev, dtype)
    dt = 0.1
    cfg = LQRSteerConfig(wheelbase=2.9)
    pe = pth = torch.zeros(lanes, dtype=dtype, device=dev)
    traj = []
    for _ in range(steps):
        if name == "pure_pursuit":
            accel, steer, _ = pure_pursuit_control(state, pts, mask, v)
        elif name == "stanley":
            accel, steer, _ = stanley_control(state, pts, mask, v)
        else:
            accel, steer, (pe, pth) = lqr_steer_control(state, pts, mask, v, pe, pth, cfg)
        state = bicycle_kinematics(state, accel, steer, dt, 2.9)
        traj.append(state)
    return torch.stack(traj)


def _arena_tab(steps=500, device=None, dtype=torch.float64):
    xs = np.linspace(0.0, 60.0, 601)
    ys = 3.0 * np.sin(xs / 8.0)
    runs = {}
    trajs = {name: _np(arena_rollouts(name, steps=steps, device=device, dtype=dtype))
             for name in ARENA_CONTROLLERS}
    for lane, v in enumerate(ARENA_SPEEDS):
        for name in ARENA_CONTROLLERS:
            traj = trajs[name][:, lane]
            d = np.sqrt(((traj[:, 0:1] - xs[None]) ** 2
                         + (traj[:, 1:2] - ys[None]) ** 2)).min(axis=1)
            settle = steps // 5
            runs[f"{name}|{v}"] = {
                "traj": np.round(traj[::4, :2], 3).tolist(),
                "cross_track_rmse": round(float(np.sqrt(np.mean(d[settle:] ** 2))), 4),
                "progress": round(float(traj[-1, 0]), 2),
            }
    return {
        "course": np.round(np.stack([xs, ys], -1)[::6], 3).tolist(),
        "params": {"controller": list(ARENA_CONTROLLERS),
                   "target_speed": [str(v) for v in ARENA_SPEEDS]},
        "runs": runs,
    }


def build_playground_data(device=None, dtype=torch.float64):
    """All five tab sweeps (app.rs:10-16 tab list), on `device` (default
    cuda) in `dtype`."""
    kw = dict(device=device, dtype=dtype)
    return {
        "grid_planners": _grid_planners_tab(**kw),
        "localization": _localization_tab(**kw),
        "slam": _slam_tab(**kw),
        "admm_formation": _admm_tab(**kw),
        "controller_arena": _arena_tab(**kw),
    }


def main(outdir, device=None, dtype=torch.float64):
    """Write `data.json` and `index.html` into `outdir` (made if missing);
    returns `outdir`."""
    data = build_playground_data(device, dtype)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "data.json"), "w") as f:
        json.dump(data, f, separators=(",", ":"))
    with open(os.path.join(os.path.dirname(__file__), "playground_page.html")) as f:
        page = f.read()
    with open(os.path.join(outdir, "index.html"), "w") as f:
        f.write(page)
    return outdir


if __name__ == "__main__":
    import sys

    main(*sys.argv[1:2])
