"""Bipedal walking planner: LIPM footstep modification.

The port of rust_robotics_tpu/planning/bipedal.py. Reference:
crates/rust_robotics_planning/src/bipedal_planner.rs — for each designated
footstep, integrate the linear inverted pendulum about the current
modified foot placement (ẍ = g/z_c (x − p*), Euler at dt = t_sup/time_split
:194-219), accumulate the reference placements with alternating lateral
sign and per-step rotation (:151-160), and choose the modified placement
from the analytic LIPM transition (:170-186).

The footstep loop and the Euler steps run in order over leading batch
dims of footsteps [..., N, 3] (a batch of gaits). JAX jits the planner, so
XLA contracts each Euler update's multiply-add into one rounding; the
port does the same (`mul_add`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.control._small import as_float
from rust_robotics_tpu_torch.planning.rrt import mul_add

__all__ = ["BipedalConfig", "bipedal_plan"]


@dataclasses.dataclass(frozen=True)
class BipedalConfig:
    """BipedalPlannerConfig (bipedal_planner.rs defaults)."""

    t_sup: float = 0.8
    z_c: float = 0.8
    a: float = 10.0
    b: float = 1.0
    time_split: int = 100
    trajectory_stride: int = 1
    gravity: float = 9.8


def _rotate(theta, x, y):
    c, s = torch.cos(theta), torch.sin(theta)
    return c * x - s * y, s * x + c * y


def bipedal_plan(footsteps, cfg: BipedalConfig = BipedalConfig(), dtype=None, device=None):
    """Returns dict(reference_footsteps [..., N+1, 3], modified_footsteps
    [..., N+1, 3], com_trajectory [..., N·time_split/stride, 2]) —
    BipedalPlan. footsteps: [..., N, 3] designated (x, y, theta)
    body-relative steps."""
    steps = as_float(footsteps, dtype, device)
    f, dev = steps.dtype, steps.device
    n = steps.shape[-2]
    batch = steps.shape[:-2]
    dt = torch.full(batch, cfg.t_sup / cfg.time_split, dtype=f, device=dev)
    tc = math.sqrt(cfg.z_c / cfg.gravity)
    c = math.cosh(cfg.t_sup / tc)
    s = math.sinh(cfg.t_sup / tc)
    dd = cfg.a * (c - 1.0) ** 2 + cfg.b * (s / tc) ** 2
    w2 = cfg.gravity / cfg.z_c
    zero = torch.zeros(batch, dtype=f, device=dev)
    x, xd, y, yd = zero, zero, torch.full(batch, 0.01, dtype=f, device=dev), zero
    px, py, ps_x, ps_y = zero, zero, zero, zero
    refs, mods, coms = [], [], []
    for i in range(n):
        cur = steps[..., i, :]
        nxt = steps[..., i + 1, :] if i + 1 < n else torch.zeros_like(cur)
        sign = 1.0 if (i + 1) % 2 == 0 else -1.0
        for k in range(cfg.time_split):
            xdd = w2 * (x - ps_x)
            ydd = w2 * (y - ps_y)
            x = mul_add(xd, dt, x)
            xd = mul_add(xdd, dt, xd)
            y = mul_add(yd, dt, y)
            yd = mul_add(ydd, dt, yd)
            if k % cfg.trajectory_stride == 0:
                coms.append(torch.stack([x, y], -1))
        dx, dy = _rotate(cur[..., 2], cur[..., 0], -sign * cur[..., 1])
        px, py = px + dx, py + dy
        x_ref, y_ref = _rotate(nxt[..., 2], true_div(nxt[..., 0], 2.0), true_div(sign * nxt[..., 1],
                                                                                  2.0))
        vx_ref, vy_ref = _rotate(nxt[..., 2], (1.0 + c) / (tc * s) * x_ref,
                                 (c - 1.0) / (tc * s) * y_ref)
        xd_t, yd_t = px + x_ref, py + y_ref
        ps_x = (-cfg.a * (c - 1.0) / dd * (xd_t - c * x - tc * s * xd)
                - cfg.b * s / (tc * dd) * (vx_ref - s / tc * x - c * xd))
        ps_y = (-cfg.a * (c - 1.0) / dd * (yd_t - c * y - tc * s * yd)
                - cfg.b * s / (tc * dd) * (vy_ref - s / tc * y - c * yd))
        refs.append(torch.stack([px, py, cur[..., 2]], -1))
        mods.append(torch.stack([ps_x, ps_y, cur[..., 2]], -1))
    z3 = torch.zeros(batch + (1, 3), dtype=f, device=dev)
    return {"reference_footsteps": torch.cat([z3, torch.stack(refs, -2)], -2),
            "modified_footsteps": torch.cat([z3, torch.stack(mods, -2)], -2),
            "com_trajectory": torch.stack(coms, -2)}
