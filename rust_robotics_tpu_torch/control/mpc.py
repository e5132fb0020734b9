"""Iterative linear MPC for path tracking (+ speed profile).

The port of rust_robotics_tpu/control/mpc.py. Reference:
crates/rust_robotics_control/src/mpc.rs (PythonRobotics-faithful): bicycle
model linearization (get_linear_model_matrix), speed profile along the
course (:300), iterative linear MPC — linearize around the predicted
trajectory, solve the constrained QP, repeat (:810) — with a
projected-gradient QP inner solver. Constants :17-49 (T=5,
Q=diag[1,1,.5,.5], R=diag[.01,.01], Rd=diag[.01,1], MAX_STEER=45°,
MAX_ACCEL=1, DT=0.2, WB=2.5).

The condensed QP objective is a linear rollout differentiated by
`torch.func.grad`; the inner solver is projected gradient for a fixed
number of steps. Leading batch dims are vehicles in lock-step: each
vehicle's objective is its own sum (their total is what `grad` takes, and
no lane's gradient touches another's), the products are `_small`'s
explicit sums (no matmul, so TF32 cannot touch them), so a vehicle equals
its solo run bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.func import grad

from rust_robotics_tpu_torch._numeric import filled, true_div
from rust_robotics_tpu_torch.control._small import at, mv, rsum
from rust_robotics_tpu_torch.core.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """mpc.rs:17-49."""

    horizon: int = 5
    dt: float = 0.2
    wheelbase: float = 2.5
    q: tuple = (1.0, 1.0, 0.5, 0.5)
    qf: tuple = (1.0, 1.0, 0.5, 0.5)
    r: tuple = (0.01, 0.01)
    rd: tuple = (0.01, 1.0)
    max_steer: float = 0.7853981633974483
    max_dsteer: float = 0.5235987755982988
    max_speed: float = 55.0 / 3.6
    min_speed: float = -20.0 / 3.6
    max_accel: float = 1.0
    outer_iterations: int = 3
    qp_iterations: int = 120
    qp_lr: float = 0.5


def bicycle_model(state, u, dt, wheelbase):
    """state [..., 4] = [x, y, v, yaw] (mpc.rs state order); u [accel, steer]."""
    x, y, v, yaw = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    a, d = u[..., 0], u[..., 1]
    return torch.stack([
        x + v * torch.cos(yaw) * dt,
        y + v * torch.sin(yaw) * dt,
        v + a * dt,
        yaw + true_div(v, wheelbase) * torch.tan(d) * dt,
    ], dim=-1)


def linear_model_matrices(v, phi, delta, cfg: MPCConfig):
    """A [..., 4, 4], B [..., 4, 2], C [..., 4] of the linearized bicycle
    (mpc.rs get_linear_model_matrix)."""
    dt, wb = cfg.dt, cfg.wheelbase
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    cphi, sphi, cdel = torch.cos(phi), torch.sin(phi), torch.cos(delta)
    a = torch.stack([
        torch.stack([one, zero, dt * cphi, -dt * v * sphi], -1),
        torch.stack([zero, one, dt * sphi, dt * v * cphi], -1),
        torch.stack([zero, zero, one, zero], -1),
        torch.stack([zero, zero, true_div(dt * torch.tan(delta), wb), one], -1),
    ], -2)
    b = torch.stack([
        torch.stack([zero, zero], -1),
        torch.stack([zero, zero], -1),
        torch.stack([zero + dt, zero], -1),
        torch.stack([zero, dt * v / (wb * cdel ** 2)], -1),
    ], -2)
    c = torch.stack([
        dt * v * sphi * phi,
        -dt * v * cphi * phi,
        zero,
        -dt * v * delta / (wb * cdel ** 2),
    ], -1)
    return a, b, c


def _quad(err, w):
    """Σ_t Σ_i w_i err[..., t, i]² — the diagonal weight's einsum."""
    return rsum(rsum(err * err * w, -1), -1)


def mpc_control(x0, xref, u_init, cfg: MPCConfig = MPCConfig()):
    """Iterative linear MPC step (mpc.rs:810): returns (u [..., T, 2],
    predicted states [..., T+1, 4], None).

    x0 [..., 4]; xref [..., T+1, 4] reference states along the course;
    u_init [..., T, 2].
    """
    f, dev = x0.dtype, x0.device
    q, qf, r, rd = (filled(w, f, dev) for w in (cfg.q, cfg.qf, cfg.r, cfg.rd))
    lo = filled([-cfg.max_accel, -cfg.max_steer], f, dev)
    hi = filled([cfg.max_accel, cfg.max_steer], f, dev)
    horizon = u_init.shape[-2]

    def rollout_nonlinear(u):
        xs = [x0]
        for t in range(horizon):
            xs.append(bicycle_model(xs[-1], u[..., t, :], cfg.dt, cfg.wheelbase))
        return torch.stack(xs, dim=-2)

    u = u_init
    for _ in range(cfg.outer_iterations):
        xbar = rollout_nonlinear(u)
        a, b, c = linear_model_matrices(xbar[..., :-1, 2], xbar[..., :-1, 3], u[..., 1], cfg)

        def objective(uu):
            xs = [x0]
            for t in range(horizon):
                xs.append(mv(a[..., t, :, :], xs[-1]) + mv(b[..., t, :, :], uu[..., t, :])
                          + c[..., t, :])
            err = torch.stack(xs, dim=-2) - xref
            err = torch.cat([err[..., :3], normalize_angle(err[..., 3:])], dim=-1)
            du = uu[..., 1:, :] - uu[..., :-1, :]
            cost = (_quad(err[..., :-1, :], q) + _quad(err[..., -1:, :], qf) + _quad(uu, r)
                    + _quad(du, rd))
            return cost.sum(), cost

        grad_fn = grad(objective, has_aux=True)
        for k in range(cfg.qp_iterations):
            g, _ = grad_fn(u)
            lr = cfg.qp_lr / math.sqrt(1.0 + k)
            u = torch.minimum(torch.maximum(u - lr * g, lo), hi)
    return u, rollout_nonlinear(u), None


def calc_speed_profile(cyaw, target_speed):
    """Speed profile along the course (mpc.rs:300): the target speed,
    slowing to 0 at the end."""
    profile = torch.full_like(cyaw, target_speed)
    profile[..., -1] = 0.0
    return profile


def nearest_index(state, cx, cy, start, search: int = 10):
    """Windowed nearest course point (mpc.rs calc_nearest_index,
    N_IND_SEARCH=10)."""
    n = cx.shape[0]
    idxs = torch.clamp(torch.arange(search, device=cx.device) + start, 0, n - 1)
    d = (cx[idxs] - state[0]) ** 2 + (cy[idxs] - state[1]) ** 2
    return at(idxs, torch.argmin(d))


def calc_ref_trajectory(state, cx, cy, cyaw, sp, ind, cfg: MPCConfig):
    """Reference window for the horizon (mpc.rs calc_ref_trajectory):
    advance along the course by the predicted travel."""
    n = cx.shape[0]
    travel = torch.abs(state[2]) * cfg.dt
    steps = torch.round(travel * torch.arange(cfg.horizon + 1, dtype=cx.dtype, device=cx.device)
                        ).to(torch.int64)
    idx = torch.clamp(steps + ind, 0, n - 1)
    return torch.stack([cx[idx], cy[idx], sp[idx], cyaw[idx]], dim=-1)
