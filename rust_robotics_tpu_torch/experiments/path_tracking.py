"""Path-tracking accuracy experiment suite.

The port of rust_robotics_tpu/experiments/path_tracking.py. Reference:
crates/rust_robotics_control/src/experiments/path_tracking_accuracy/ —
controller variants (PurePursuit / Stanley / LQR-steer) driven over seeded
course scenarios, reporting cross-track RMSE, max deviation, progress, and
goal completion per (variant × seed × scenario) cell through the shared
experiments harness (core experiments.rs), with deltas annotated against a
reference variant.

Each controller's closed loop runs every (course, seed) cell as a lane of
one fleet, each lane on its own course (the trackers take leading batch
dims and a path per vehicle), a loop of device steps that reads nothing
until its metrics; a lane equals its solo run bit for bit. A seed's start
offset is its two uniforms in [−1, 1) (`draws=` [S, 2], JAX's
`jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)`), else drawn from
a `torch.Generator` seeded by the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device
from rust_robotics_tpu_torch._numeric import linspace, norm2, true_div
from rust_robotics_tpu_torch.control.trackers import (
    LQRSteerConfig,
    bicycle_kinematics,
    lqr_steer_control,
    pure_pursuit_control,
    stanley_control,
)
from rust_robotics_tpu_torch.utils.experiments import (
    ExperimentSamplingPlan,
    VariantDescriptor,
    annotate_against_reference,
    run_experiment,
)

__all__ = ["run_path_tracking_accuracy", "COURSES", "CONTROLLERS"]


def _course(kind: str, n=601, dtype=torch.float32, device=None):
    xs = linspace(60.0, n, dtype=dtype, device=device)
    if kind == "sine":
        ys = 3.0 * torch.sin(true_div(xs, 8.0))
    elif kind == "chicane":
        ys = 2.0 * torch.tanh(torch.sin(true_div(xs, 10.0)) * 1.5)
    else:  # gentle arc
        ys = 0.01 * xs ** 2 * 0.5
    return torch.stack([xs, ys], dim=-1), torch.ones(n, dtype=dtype, device=device)


COURSES = ("sine", "chicane", "arc")
CONTROLLERS = (
    VariantDescriptor("pure_pursuit", "geometric lookahead"),
    VariantDescriptor("stanley", "front-axle cross-track law"),
    VariantDescriptor("lqr_steer", "lateral-error LQR"),
)


def _rollout(offsets, pts, mask, controller: str, steps: int = 500, dt: float = 0.1,
             target_speed: float = 3.0, wheelbase: float = 2.9):
    """The closed loop of each lane of offsets [S, 2] (uniforms in [−1, 1))
    on the course pts ([N, 2], or [S, N, 2] a course per lane) + mask.
    Returns {metric: [S] tensor}."""
    s = offsets.shape[0]
    state = torch.stack([torch.zeros_like(offsets[:, 0]), offsets[:, 0] * 1.5,
                         offsets[:, 1] * 0.3, torch.ones_like(offsets[:, 0])], -1)
    cfg = LQRSteerConfig(wheelbase=wheelbase)
    max_steer = 0.6  # the reference controllers clamp at max_steer
    errs = (torch.zeros(s, dtype=pts.dtype, device=pts.device),) * 2
    goal = pts[..., -1, :]
    traj = []
    for _ in range(steps):
        if controller == "pure_pursuit":
            accel, steer, _ = pure_pursuit_control(state, pts, mask, target_speed)
        elif controller == "stanley":
            accel, steer, _ = stanley_control(state, pts, mask, target_speed)
        else:
            accel, steer, errs = lqr_steer_control(state, pts, mask, target_speed, *errs, cfg)
        steer = torch.clamp(steer, -max_steer, max_steer)
        new = bicycle_kinematics(state, accel, steer, dt, wheelbase)
        done = norm2(state[:, :2] - goal) < 2.0
        state = torch.where(done[:, None], state, new)
        traj.append(state)
    traj = torch.stack(traj, 1)  # [S, steps, 4]
    lanes_pts = pts if pts.dim() == 3 else pts[None]
    d = torch.amin(norm2(traj[:, :, None, :2] - lanes_pts[:, None]), dim=-1)
    settle = steps // 5
    tail = d[:, settle:]
    return {
        "cross_track_rmse": torch.sqrt(torch.mean(tail ** 2, dim=-1)),
        "max_cross_track": torch.amax(tail, dim=-1),
        "progress": traj[:, -1, 0],
        "goal_reached": norm2(traj[:, -1, :2] - goal) < 2.5,
    }


def run_path_tracking_accuracy(seeds=(0, 1, 2), reference="pure_pursuit", steps: int = 500,
                               draws=None, dtype=torch.float32, device=None):
    """The suite: controllers × courses × seeds through the experiments
    harness; summaries + deltas vs the reference variant. `draws`: [S, 2]
    start-offset uniforms in [−1, 1), one row a seed. Returns the list of
    ExperimentVariantReport."""
    device = resolve_device(device)
    if draws is None:
        draws = torch.stack([
            torch.rand(2, generator=torch.Generator().manual_seed(int(s)), dtype=torch.float64)
            for s in seeds]) * 2.0 - 1.0
    # lanes: every (course, seed) cell, course-major
    n = len(seeds)
    offsets = _float_on(draws, device, dtype).repeat(len(COURSES), 1)
    paths = [_course(course, dtype=dtype, device=device) for course in COURSES]
    pts = torch.stack([p for p, _ in paths]).repeat_interleave(n, 0)
    mask = torch.stack([m for _, m in paths]).repeat_interleave(n, 0)
    cells = {}
    for variant in CONTROLLERS:
        out = _rollout(offsets, pts, mask, variant.name, steps)
        # one read a controller; every metric a float, goal_reached 0.0 or 1.0
        host = torch.stack([v.to(dtype) for v in out.values()], -1).cpu().numpy()
        cells[variant.name] = [dict(zip(out, map(float, row))) for row in host]
    lane = {(c, s): i * n + j for i, c in enumerate(COURSES) for j, s in enumerate(seeds)}

    def run_fn(variant, seed, scenario):
        return cells[variant.name][lane[scenario, seed]]

    plan = ExperimentSamplingPlan(seeds=tuple(seeds), scenarios=COURSES)
    reducers = {
        "mean_cross_track_rmse": lambda obs: float(np.mean([o["cross_track_rmse"] for o in obs])),
        "worst_max_cross_track": lambda obs: float(np.max([o["max_cross_track"] for o in obs])),
        "goal_rate": lambda obs: float(np.mean([o["goal_reached"] for o in obs])),
    }
    reports = run_experiment(CONTROLLERS, plan, run_fn, reducers)
    return annotate_against_reference(reports, reference)
