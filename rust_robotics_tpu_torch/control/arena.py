"""Controller arena: deterministic tracker comparison.

The port of rust_robotics_tpu/control/arena.py. Reference:
crates/rust_robotics_control/src/controller_arena.rs (542 LoC) —
`run_controller_arena` (control/src/lib.rs:103-107): run PurePursuit,
Stanley, and LQR-steer on the same deterministic course and report
comparable metrics (cross-track RMSE, progress, goal reached).

Each controller rolls out as a loop of device steps that reads nothing
until its end; the vehicle freezes once it is within 2 m of the goal. The
arena emits a gate-conformant CSV whose wall-clock column is suffixed `_ms`
so the regression gate ignores it (BENCHMARKS.md:10-22). Each rollout's
`elapsed_ms` is read with the device synchronised at both ends (the JAX
package's clock reads do not wait for its device).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import filled, linspace, norm2, true_div
from rust_robotics_tpu_torch.control.trackers import (
    LQRSteerConfig,
    bicycle_kinematics,
    lqr_steer_control,
    pure_pursuit_control,
    stanley_control,
)


def _course(dtype=torch.float32, device=None):
    xs = linspace(60.0, 601, dtype=dtype, device=device)
    ys = 3.0 * torch.sin(true_div(xs, 8.0))
    return torch.stack([xs, ys], dim=-1), torch.ones(601, dtype=dtype, device=device)


def _metrics(traj, pts):
    traj = np.asarray(traj)
    p = np.asarray(pts)
    d = np.sqrt(
        ((traj[:, 0:1] - p[None, :, 0]) ** 2)
        + ((traj[:, 1:2] - p[None, :, 1]) ** 2)
    ).min(axis=1)
    settle = len(traj) // 5
    return {
        "cross_track_rmse": float(np.sqrt(np.mean(d[settle:] ** 2))),
        "max_cross_track": float(d[settle:].max()),
        "progress": float(traj[-1, 0]),
        "goal_reached": bool(np.linalg.norm(traj[-1, :2] - p[-1]) < 2.5),
    }


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_controller_arena(steps: int = 600, dt: float = 0.1, target_speed: float = 3.0,
                         dtype=torch.float32, device=None):
    """Returns ({controller: metrics}, (header, rows)) for the CSV gate, on
    `device` (default cuda) in `dtype`."""
    device = resolve_device(device)
    pts, mask = _course(dtype, device)
    state0 = filled((0.0, -1.0, 0.2, 0.0), dtype, device)
    goal = pts[-1]
    results = {}

    def freeze(state, new_state):
        done = norm2(state[:2] - goal) < 2.0
        return torch.where(done, state, new_state)

    def rollout(control_fn, carry):
        state, traj = state0, []
        for _ in range(steps):
            accel, steer, carry_next = control_fn(state, carry)
            state = freeze(state, bicycle_kinematics(state, accel, steer, dt, 2.9))
            carry = carry_next
            traj.append(state)
        return torch.stack(traj)

    cfg = LQRSteerConfig(wheelbase=2.9)
    zero = torch.zeros((), dtype=dtype, device=device)
    laws = (
        ("pure_pursuit", lambda s, c: (*pure_pursuit_control(s, pts, mask, target_speed)[:2], c),
         None),
        ("stanley", lambda s, c: (*stanley_control(s, pts, mask, target_speed)[:2], c), None),
        ("lqr_steer", lambda s, c: lqr_steer_control(s, pts, mask, target_speed, *c, cfg),
         (zero, zero)),
    )
    elapsed = {}
    for name, law, carry in laws:
        _sync(device)
        t0 = time.perf_counter()
        traj = rollout(law, carry)
        _sync(device)
        elapsed[name] = (time.perf_counter() - t0) * 1e3
        results[name] = _metrics(traj.cpu().numpy(), pts.cpu().numpy())

    header = [
        "controller", "cross_track_rmse", "max_cross_track", "progress",
        "goal_reached", "elapsed_ms",
    ]
    rows = []
    for name, _, _ in laws:
        m = results[name]
        rows.append([name, m["cross_track_rmse"], m["max_cross_track"], m["progress"],
                     str(m["goal_reached"]).lower(), elapsed[name]])
    return results, (header, rows)
