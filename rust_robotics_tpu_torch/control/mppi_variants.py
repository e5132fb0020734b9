"""MPPI variants: person following + racing.

The port of rust_robotics_tpu/control/mppi_variants.py. Reference:
crates/rust_robotics_control/src/ — person_following_mppi.rs (track a
moving target at a standoff distance), racing_mppi_*.rs (track-progress
rewards, boundary penalties).

Both variants are cost configurations of the shared MPPI engine
(control/mppi.py); their costs are elementwise over the samples.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import norm2, true_div
from rust_robotics_tpu_torch.control._small import rsum
from rust_robotics_tpu_torch.control.mppi import (  # noqa: F401 (re-export)
    MPPIConfig,
    double_integrator_dynamics,
    mppi_plan,
    shift_nominal,
)


def make_person_following_costs(target_traj, standoff=1.5, control_weight=0.05,
                                speed_weight=0.1):
    """Follow a moving target at a standoff distance
    (person_following_mppi.rs): the stage cost penalizes deviation from the
    standoff ring around the target's predicted path `target_traj` [H, 2]."""

    def stage(x, u):
        d = norm2(x[..., None, :2] - target_traj)
        ring_err = (torch.amin(d, dim=-1) - standoff) ** 2
        return (ring_err + control_weight * rsum(u ** 2, -1)
                + speed_weight * rsum(x[..., 2:4] ** 2, -1))

    def terminal(x):
        d = norm2(x[..., :2] - target_traj[-1])
        return 5.0 * (d - standoff) ** 2

    return stage, terminal


def make_racing_costs(centerline, half_width=1.0, progress_weight=2.0, boundary_weight=200.0,
                      control_weight=0.01):
    """Track racing costs (racing_mppi_*.rs): reward arc-length progress
    along the centerline [M, 2], penalize leaving the track corridor.
    Progress is the index of the nearest centerline sample (the first on
    ties)."""
    m = centerline.shape[0]

    def nearest(x):
        d = norm2(x[..., None, :2] - centerline)
        return torch.argmin(d, dim=-1), torch.amin(d, dim=-1)

    def progress(weight, i):
        return true_div(weight * i.to(centerline.dtype), m)

    def stage(x, u):
        i, dist = nearest(x)
        off = torch.clamp(dist - half_width, min=0.0)
        return (progress(-progress_weight, i) + boundary_weight * off ** 2
                + control_weight * rsum(u ** 2, -1))

    def terminal(x):
        i, dist = nearest(x)
        return (progress(-10.0 * progress_weight, i)
                + boundary_weight * torch.clamp(dist - half_width, min=0.0) ** 2)

    return stage, terminal


def lap_progress(xs, centerline):
    """Diagnostics: the fraction of centerline indices passed (racing
    report fields in control/src/lib.rs:117-160)."""
    d = norm2(xs[:, None, :2] - centerline)
    return true_div(torch.amax(torch.argmin(d, dim=-1)).to(centerline.dtype), centerline.shape[0])
