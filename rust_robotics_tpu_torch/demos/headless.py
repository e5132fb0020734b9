"""Headless demos — the CI-runnable closed-loop sims of the reference's
examples layer (SURVEY.md §2.11).

The port of rust_robotics_tpu/demos/headless.py:
- headless_navigation_loop.rs (§3.1): DWA plan → step → EKF estimate,
  goal-reached check;
- examples/headless_mission_recovery.rs: waypoint mission FSM with stuck
  detection and rotate/backoff recovery budgets;
- headless_euroc_vio.rs (§3.3): EuRoC-layout fixture → preintegration →
  BA → IMU refinement → SE(3) fusion with pose-error reporting.

Each demo is deterministic (sinusoid pseudo-noise, fixed seeds) and returns
a metrics dict. The two closed loops read the device a fixed number of
times a step, as the reference's loops do: the navigation loop its
goal-reached flag, the estimate error and the position (three reads), the
mission loop the position (one read), which the state machine consumes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import tempfile

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.control.mission import make_waypoint_mission
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.data.euroc import EurocDataset, quat_to_rot
from rust_robotics_tpu_torch.data.fixtures import reference_fixture_root
from rust_robotics_tpu_torch.filters.kalman import ekf_step
from rust_robotics_tpu_torch.planning.dwa import DWAConfig, dwa_step, goal_reached
from rust_robotics_tpu_torch.slam.vio import (
    nav_to_se3,
    pose_error,
    pose_error_se3,
    run_vio_pipeline,
)

__all__ = [
    "headless_navigation_loop",
    "headless_mission_recovery",
    "headless_euroc_vio",
]

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def headless_navigation_loop(steps: int = 240, device=None, dtype=torch.float32):
    """DWA + EKF closed loop (headless_navigation_loop.rs:11-63) on `device`
    (default cuda) in `dtype`."""
    device = resolve_device(device)
    f = dtype
    cfg = DWAConfig()
    goal = torch.tensor([8.0, 8.0], dtype=f, device=device)
    obstacles_np = np.array([[2.0, 2.5], [4.0, 4.5], [6.0, 5.0], [5.0, 7.0]], _NP[f])
    obstacles = torch.tensor(obstacles_np, device=device)
    state = torch.zeros(5, dtype=f, device=device)  # x, y, yaw, v, omega
    belief = GaussianBelief(torch.zeros(4, dtype=f, device=device),
                            torch.eye(4, dtype=f, device=device))
    q = torch.diag(torch.tensor([0.1, 0.1, 0.017, 1.0], dtype=f, device=device)) ** 2
    r = torch.diag(torch.tensor([0.5, 0.5], dtype=f, device=device)) ** 2
    # deterministic sinusoid pseudo-noise (gallery convention), sin(0.7 k)
    # and cos(1.1 k) of the arguments rounded to `dtype`, made on the device
    ks = torch.arange(steps, dtype=torch.float64, device=device)
    noise = 0.05 * torch.stack([torch.sin((0.7 * ks).to(f)), torch.cos((1.1 * ks).to(f))], -1)

    path = [state[:2].cpu().numpy()]
    reached = False
    est_err = []
    for k in range(steps):
        if bool(goal_reached(state, goal, cfg)):
            reached = True
            break
        control, state, _, _ = dwa_step(state, goal, obstacles, cfg)
        z = state[:2] + noise[k]
        belief = ekf_step(belief, z, control, cfg.dt, q, r)
        est_err.append(float(_norm(belief.mean[:2] - state[:2])))
        path.append(state[:2].cpu().numpy())
    path = np.stack(path)
    d = np.linalg.norm(path[:, None, :] - obstacles_np[None], axis=-1)
    return {
        "goal_reached": reached,
        "steps_used": len(path) - 1,
        "path_length": float(np.linalg.norm(np.diff(path, axis=0), axis=1).sum()),
        "min_obstacle_clearance": float(d.min()),
        "final_estimate_error": est_err[-1] if est_err else float("nan"),
        "mean_estimate_error": float(np.mean(est_err)) if est_err else float("nan"),
    }


def headless_mission_recovery(max_steps: int = 400, device=None, dtype=torch.float32):
    """Waypoint mission with a blocking obstacle: the FSM detects the
    stall, runs a rotate/backoff recovery, then completes
    (headless_mission_recovery.rs:1-30), on `device` (default cuda) in
    `dtype`."""
    device = resolve_device(device)
    f = dtype
    waypoints = [np.array([4.0, 0.0]), np.array([8.0, 4.0])]
    waypoints_t = torch.tensor(np.stack(waypoints), dtype=f, device=device)
    # a cul-de-sac in front of the first leg traps greedy progress
    obstacles = torch.tensor([[2.0, 0.0], [2.0, 0.6], [2.0, -0.6], [2.4, 1.0], [2.4, -1.0]],
                             dtype=f, device=device)
    cfg = DWAConfig()
    sm = make_waypoint_mission(waypoints, goal_tolerance=0.6, stuck_window=12,
                               stuck_min_progress=0.05, recovery_steps=10)
    bb = {"position": np.zeros(2), "wp_index": 0, "recovery_count": 0}
    state = torch.zeros(5, dtype=f, device=device)
    for _ in range(max_steps):
        sm.step(bb)
        if sm.state == "done":
            break
        if sm.state == "recover":
            # rotate in place + back off (waypoint_navigator recovery)
            yaw = state[2]
            state = torch.stack([state[0] + -0.1 * torch.cos(yaw), state[1] + -0.1 * torch.sin(yaw),
                                 yaw + 0.4, state[3], state[4]])
        else:
            _, state, _, _ = dwa_step(state, waypoints_t[bb["wp_index"]], obstacles, cfg)
        bb["position"] = state[:2].cpu().numpy()
    return {
        "mission_done": sm.state == "done",
        "recovery_count": bb.get("recovery_count", 0),
        "final_wp_index": bb["wp_index"],
        "final_distance": float(np.linalg.norm(bb["position"] - waypoints[-1])),
    }


def headless_euroc_vio(tmpdir=None, device=None, dtype=torch.float32):
    """Fixture EuRoC replay through the full VIO pipeline
    (headless_euroc_vio.rs:22-58) on `device` (default cuda) in `dtype`.
    Prefers the reference's own checked-in euroc_mini fixture (with the
    example's landmark perturbation and 5e-2 terminal SE(3) acceptance
    gate); falls back to the synthetic generator, tests/fixture_gen.py
    loaded by path, when the reference checkout is absent. The landmark
    noise of the fallback comes from the pipeline's seeded generator."""
    device = resolve_device(device)
    ref_root = tmpdir is None and reference_fixture_root("euroc_mini")
    if ref_root:
        ds = EurocDataset.load(ref_root)
        tracks = ds.load_feature_tracks()
        tracks = dataclasses.replace(
            tracks, landmarks=tracks.landmarks + np.array([0.02, -0.01, 0.04]))
        res = run_vio_pipeline(ds, tracks, device=device, dtype=dtype)
        gt = ds.ground_truth
        wfb = np.eye(4)
        wfb[:3, :3] = quat_to_rot(gt.quaternions[-1])
        wfb[:3, 3] = gt.positions[-1]
        t_bs = np.asarray(ds.cam.t_bs)
        fused = res.fused_poses.double().cpu().numpy()
        terminal = float(pose_error_se3(fused[-1] @ t_bs, wfb @ t_bs))
        err_fused = pose_error(fused, gt.positions)
        err_dead = pose_error(nav_to_se3(res.dead_reckoned).double(), gt.positions)
        return {
            "source": "reference_fixture",
            "keyframes": int(fused.shape[0]),
            "imu_samples": int(ds.imu.timestamps.shape[0]),
            "feature_observations": int(tracks.obs_pixels.shape[0]),
            "terminal_se3_error": terminal,
            "acceptance": bool(terminal <= 5.0e-2),
            "fused_position_rmse": float(err_fused),
            "dead_reckoned_rmse": float(err_dead),
            "fusion_improves": bool(err_fused <= err_dead + 1e-9),
        }

    # the synthetic fixture generator lives beside the tests (the
    # reference checks its euroc_mini fixture into tests/fixtures)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "fixture_gen", os.path.join(here, "tests", "fixture_gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    root = tmpdir or tempfile.mkdtemp(prefix="euroc_mini_")
    truth, _, _ = mod.make_euroc_fixture(root)
    ds = EurocDataset.load(root)
    tracks = ds.load_feature_tracks()
    res = run_vio_pipeline(ds, tracks, max_keyframes=10, point_init_noise=0.05,
                           device=device, dtype=dtype)
    k = res.fused_poses.shape[0]
    gt_pos = truth["pos"][truth["cam_idx"][:k]]
    err_fused = pose_error(res.fused_poses.double(), gt_pos)
    err_dead = pose_error(nav_to_se3(res.dead_reckoned).double(), gt_pos)
    return {
        "keyframes": k,
        "fused_position_rmse": float(err_fused),
        "dead_reckoned_rmse": float(err_dead),
        "fusion_improves": bool(err_fused <= err_dead + 1e-9),
    }
