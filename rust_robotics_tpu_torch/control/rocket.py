"""Rocket landing by successive convexification (SCvx).

The port of rust_robotics_tpu/control/rocket.py. Reference:
crates/rust_robotics_control/src/rocket_landing.rs: plan a fuel-optimal
powered descent by repeatedly linearizing the dynamics around the current
trajectory and solving the convex subproblem with trust regions.

The convex subproblem (quadratic objective, linear dynamics, thrust
bounds) is solved by projected gradient on the control sequence, the
dynamics eliminated by a differentiable rollout (the double integrator
stepped in JAX's order of adds) and the gradient taken by
`torch.func.grad`, for a fixed number of steps with no read.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.func import grad

from rust_robotics_tpu_torch._numeric import norm2, true_div
from rust_robotics_tpu_torch.control._small import as_float, rsum


@dataclasses.dataclass(frozen=True)
class RocketConfig:
    horizon: int = 40
    dt: float = 0.25
    gravity: float = 9.81
    mass: float = 10.0
    max_thrust: float = 250.0
    min_thrust: float = 0.0
    fuel_weight: float = 0.002
    terminal_weight: float = 200.0
    outer_iterations: int = 5
    inner_iterations: int = 150
    lr: float = 0.02


def rocket_dynamics(state, thrust, cfg: RocketConfig):
    """state [..., 4] = [x, y, vx, vy]; thrust [..., 2] (world-frame force)."""
    ax = true_div(thrust[..., 0], cfg.mass)
    ay = true_div(thrust[..., 1], cfg.mass) - cfg.gravity
    return torch.stack([
        state[..., 0] + state[..., 2] * cfg.dt,
        state[..., 1] + state[..., 3] * cfg.dt,
        state[..., 2] + ax * cfg.dt,
        state[..., 3] + ay * cfg.dt,
    ], dim=-1)


def plan_landing(x0, target_xy, cfg: RocketConfig = RocketConfig(), dtype=None, device=None):
    """Returns (states [H+1, 4], thrusts [H, 2], final cost): a soft landing
    at the target with near-zero velocity, fuel-weighted. x0 and target on
    `device` (default cuda; x0's own when a tensor), in `dtype`."""
    x0 = as_float(x0, dtype, device)
    target_xy = as_float(target_xy, x0.dtype, x0.device)

    def rollout(us):
        """`rocket_dynamics` one step after another, as JAX's `lax.scan`
        adds: each velocity is the one before plus its increment, each
        position the one before plus the velocity before times dt, one
        rounding per add in both dtypes (a one-op `cumsum` adds in another
        order: a parallel scan on CUDA, f64 accumulation of f32 on the CPU)."""
        acc = torch.stack([true_div(us[:, 0], cfg.mass),
                           true_div(us[:, 1], cfg.mass) - cfg.gravity], -1)
        vel = [x0[2:]]
        for dv in (acc * cfg.dt).unbind(0):
            vel.append(vel[-1] + dv)
        vel = torch.stack(vel)
        pos = [x0[:2]]
        for dp in (vel[:-1] * cfg.dt).unbind(0):
            pos.append(pos[-1] + dp)
        return torch.cat([torch.stack(pos), vel], -1)

    def objective(us):
        xs = rollout(us)
        fuel = cfg.fuel_weight * torch.sum(torch.sqrt(rsum(us * us)))
        terminal = cfg.terminal_weight * (rsum((xs[-1, :2] - target_xy) ** 2)
                                          + rsum(xs[-1, 2:] ** 2))
        # keep the altitude non-negative along the way (soft)
        ground = 50.0 * torch.sum(torch.clamp(-xs[:, 1], min=0.0) ** 2)
        return fuel + terminal + ground

    grad_fn = grad(objective)

    def project(us):
        mag = norm2(us)[:, None]
        return us * (torch.clamp(mag, cfg.min_thrust, cfg.max_thrust) / torch.clamp(mag, min=1e-9))

    # successive refinement: re-run PGD from the projected solution (the
    # dynamics are control-affine, so the convexification converges after
    # the first pass; the loop keeps the reference's SCvx structure)
    us = torch.zeros((cfg.horizon, 2), dtype=x0.dtype, device=x0.device)
    us[:, 1] = cfg.mass * cfg.gravity
    for _ in range(cfg.outer_iterations):
        for k in range(cfg.inner_iterations):
            us = project(us - cfg.lr / math.sqrt(1.0 + k) * grad_fn(us))
    return rollout(us), us, objective(us)
