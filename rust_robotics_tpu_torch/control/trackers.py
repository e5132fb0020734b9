"""Tier-1 path-tracking controllers: PID, Pure Pursuit, Stanley, LQR steer,
rear-wheel feedback, move-to-pose.

The port of rust_robotics_tpu/control/trackers.py. Reference:
crates/rust_robotics_control/src/ — pid_controller.rs (kp/ki/kd/dt +
anti-windup + output clamp), pure_pursuit.rs (rear-axle geometry :26-46,
Lf = k·v + Lfc, δ = atan2(2 L sin α / Lf, 1) :131-148), stanley_controller.rs
(front-axle cross-track, δ = θe + atan2(k·e, v)), lqr_steer_control.rs
(4-state error model + DARE iteration), rear_wheel_feedback.rs,
move_to_pose.rs (ρ/α/β polar controller, gains 9/15/−3).

Every controller is a function over tensors with leading batch dims (a
fleet of vehicles); a path [N, 2] + mask may be shared by the fleet or
given per vehicle. Index searches are masked first-index argmins; the
products are `_small`'s explicit sums, so a lane equals its solo run bit
for bit. The LQR's DARE iterates every lane until its own flag is set and
freezes it there, as JAX's `while_loop` under `vmap` does, and reads the
flags once every `_small.READ_EVERY` iterations.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import norm2, true_div
from rust_robotics_tpu_torch.control._small import (
    inv_small,
    masked_fixpoint,
    mm,
    mt,
    mv,
    rsum,
    take,
    take_rows,
)
from rust_robotics_tpu_torch.core.angles import normalize_angle

BIG = 1e18


def _over(a, value):
    """a / value for a Python number or a tensor."""
    return true_div(a, value) if isinstance(value, (int, float)) else a / value


# ---------------------------------------------------------------------------
# Vehicle kinematics (pure_pursuit.rs:26-46)
# ---------------------------------------------------------------------------

def bicycle_kinematics(state, accel, steer, dt, wheelbase):
    """state [..., 4] = [x, y, yaw, v]; bicycle update (:41-47)."""
    x, y, yaw, v = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    x = x + v * torch.cos(yaw) * dt
    y = y + v * torch.sin(yaw) * dt
    yaw = yaw + _over(v, wheelbase) * torch.tan(steer) * dt
    v = v + accel * dt
    return torch.stack([x, y, yaw, v], dim=-1)


def rear_axle(state, wheelbase):
    """Rear-axle position (:27-28)."""
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    half = wheelbase / 2.0
    return torch.stack([x - half * torch.cos(yaw), y - half * torch.sin(yaw)], dim=-1)


def _masked_nearest(query_xy, points, mask):
    """Index of the nearest valid path point (the first on ties)."""
    d2 = rsum((points - query_xy[..., None, :]) ** 2, -1)
    d2 = torch.where(mask > 0, d2, torch.full_like(d2, BIG))
    return torch.argmin(d2, dim=-1)


def path_yaws(points, mask):
    """Per-point tangent yaw (stanley_controller.rs:137-151): forward
    difference, the last point repeating the one before."""
    diffs = points[..., 1:, :] - points[..., :-1, :]
    yaw = torch.atan2(diffs[..., 1], diffs[..., 0])
    return torch.cat([yaw, yaw[..., -1:]], dim=-1)


# ---------------------------------------------------------------------------
# PID (pid_controller.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PIDConfig:
    kp: float = 1.0
    ki: float = 0.0
    kd: float = 0.0
    dt: float = 0.1
    max_integral: float = 10.0
    max_output: float = 10.0


def pid_reset(shape=(), dtype=torch.float32, device=None):
    """(integral, prev_error) state on `device` (default cuda)."""
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def pid_step(state, error, cfg: PIDConfig):
    """One PID update with anti-windup + output clamp (pid_controller.rs)."""
    integral, prev = state
    integral = torch.clamp(integral + error * cfg.dt, -cfg.max_integral, cfg.max_integral)
    deriv = true_div(error - prev, cfg.dt)
    out = cfg.kp * error + cfg.ki * integral + cfg.kd * deriv
    out = torch.clamp(out, -cfg.max_output, cfg.max_output)
    return (integral, error), out


# ---------------------------------------------------------------------------
# Pure Pursuit (pure_pursuit.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PurePursuitConfig:
    look_ahead_gain: float = 0.1
    look_ahead_distance: float = 2.0
    wheelbase: float = 2.9
    kp: float = 1.0
    goal_threshold: float = 2.0


def pure_pursuit_control(state, points, mask, target_speed,
                         cfg: PurePursuitConfig = PurePursuitConfig()):
    """(accel, steer, target_idx): δ = atan2(2 L sin α / Lf, 1)
    (pure_pursuit.rs:131-148); accel = kp (v_target − v) (:195)."""
    rear = rear_axle(state, cfg.wheelbase)
    lf = cfg.look_ahead_gain * state[..., 3] + cfg.look_ahead_distance
    # target: the first valid point at distance >= Lf from the nearest on
    near = _masked_nearest(rear, points, mask)
    d = norm2(points - rear[..., None, :])
    n = points.shape[-2]
    ahead = torch.arange(n, device=points.device) >= near[..., None]
    candidate = (d >= lf[..., None]) & ahead & (mask > 0)
    idx = torch.argmax(candidate.to(torch.uint8), dim=-1)
    any_c = torch.any(candidate, dim=-1)
    last_valid = n - 1 - torch.argmax(torch.flip(mask > 0, dims=(-1,)).to(torch.uint8), dim=-1)
    target = torch.where(any_c, idx, last_valid)
    tp = take_rows(points, target)
    alpha = torch.atan2(tp[..., 1] - rear[..., 1], tp[..., 0] - rear[..., 0]) - state[..., 2]
    steer = torch.atan2(2.0 * cfg.wheelbase * torch.sin(alpha) / lf, torch.ones_like(lf))
    accel = cfg.kp * (target_speed - state[..., 3])
    return accel, steer, target


# ---------------------------------------------------------------------------
# Stanley (stanley_controller.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StanleyConfig:
    k: float = 0.5
    wheelbase: float = 2.9
    kp: float = 1.0
    goal_threshold: float = 3.0


def stanley_control(state, points, mask, target_speed, cfg: StanleyConfig = StanleyConfig()):
    """Front-axle cross-track law δ = θe + atan2(k·e, v)."""
    x, y, yaw, v = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    fx = x + cfg.wheelbase * torch.cos(yaw)
    fy = y + cfg.wheelbase * torch.sin(yaw)
    front = torch.stack([fx, fy], dim=-1)
    idx = _masked_nearest(front, points, mask)
    tp = take_rows(points, idx)
    pyaw = take(path_yaws(points, mask), idx)
    # signed cross-track error: the front-axle offset projected on the
    # path normal (+90° from the heading)
    dx, dy = fx - tp[..., 0], fy - tp[..., 1]
    e = dx * torch.cos(yaw + math.pi / 2) + dy * torch.sin(yaw + math.pi / 2)
    theta_e = normalize_angle(pyaw - yaw)
    steer = theta_e + torch.atan2(cfg.k * -e, v)
    accel = cfg.kp * (target_speed - v)
    return accel, steer, idx


# ---------------------------------------------------------------------------
# LQR steer (lqr_steer_control.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LQRSteerConfig:
    wheelbase: float = 0.5
    max_steer: float = 0.7853981633974483
    kp: float = 1.0
    q_diag: tuple = (1.0, 1.0, 1.0, 1.0)
    r: float = 1.0
    dt: float = 0.1
    goal_threshold: float = 0.3
    dare_iterations: int = 150
    dare_tolerance: float = 0.01


def solve_dare(a, b, q, r, iterations=150, tol=0.01):
    """Discrete algebraic Riccati by fixed-point iteration (the reference's
    solve_dare loop), over leading batch dims."""
    at, bt = mt(a), mt(b)

    def step(x):
        atx = mm(at, x)
        gain = mm(mm(mm(mm(mm(atx, b), inv_small(r + mm(mm(bt, x), b))), bt), x), a)
        return mm(atx, a) - gain + q

    return masked_fixpoint(step, q.expand(torch.broadcast_shapes(a.shape, q.shape)), iterations,
                           tol)


def path_curvatures(points, mask):
    """Finite-difference curvature per path point (`jnp.gradient` twice:
    central differences inside, one-sided at the ends)."""

    def gradient(f):
        inner = (f[..., 2:, :] - f[..., :-2, :]) * 0.5
        return torch.cat([f[..., 1:2, :] - f[..., :1, :], inner, f[..., -1:, :] - f[..., -2:-1, :]],
                         dim=-2)

    d1 = gradient(points)
    d2 = gradient(d1)
    num = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    den = torch.clamp((d1[..., 0] ** 2 + d1[..., 1] ** 2) ** 1.5, min=1e-9)
    return num / den


def _path_errors(state, points, mask):
    """(idx, e, θe, κ) at the nearest path point to the rear axle
    position: e the lateral offset in the path frame (left positive)."""
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    idx = _masked_nearest(torch.stack([x, y], dim=-1), points, mask)
    tp = take_rows(points, idx)
    pyaw = take(path_yaws(points, mask), idx)
    k = take(path_curvatures(points, mask), idx)
    dx, dy = x - tp[..., 0], y - tp[..., 1]
    e = -torch.sin(pyaw) * dx + torch.cos(pyaw) * dy
    return idx, e, normalize_angle(yaw - pyaw), k


def lqr_steer_control(state, points, mask, target_speed, prev_error, prev_theta_error,
                      cfg: LQRSteerConfig = LQRSteerConfig()):
    """LQR on the 4-state lateral error model [e, ė, θe, θ̇e]
    (lqr_steer_control.rs): feedback + curvature feedforward. Returns
    (accel, steer, (e, θe)); the errors are threaded as controller state.
    Leading batch dims are vehicles, each with its own DARE."""
    v = state[..., 3]
    _, e, theta_e, k = _path_errors(state, points, mask)
    dt = cfg.dt
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    a = torch.stack([
        torch.stack([one, zero + dt, zero, zero], -1),
        torch.stack([zero, zero, v, zero], -1),
        torch.stack([zero, zero, one, zero + dt], -1),
        torch.stack([zero, zero, zero, zero], -1),
    ], -2)
    b = torch.stack([zero, zero, zero, true_div(v, cfg.wheelbase)], -1)[..., None]
    q = torch.diag_embed(torch.stack([zero + qi for qi in cfg.q_diag], -1))
    r = (zero + cfg.r)[..., None, None]
    p = solve_dare(a, b, q, r, cfg.dare_iterations, cfg.dare_tolerance)
    bt = mt(b)
    k_gain = mm(mm(mm(inv_small(r + mm(mm(bt, p), b)), bt), p), a)  # [..., 1, 4]
    xvec = torch.stack([e, true_div(e - prev_error, dt), theta_e,
                        true_div(theta_e - prev_theta_error, dt)], dim=-1)
    ff = torch.atan2(cfg.wheelbase * k, torch.ones_like(k))
    fb = normalize_angle(-mv(k_gain, xvec)[..., 0])
    steer = torch.clamp(ff + fb, -cfg.max_steer, cfg.max_steer)
    accel = cfg.kp * (target_speed - v)
    return accel, steer, (e, theta_e)


# ---------------------------------------------------------------------------
# Rear-wheel feedback (rear_wheel_feedback.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RearWheelFeedbackConfig:
    kth: float = 1.0
    ke: float = 0.5
    wheelbase: float = 2.9
    kp: float = 1.0
    goal_threshold: float = 0.5
    max_steer: float = 0.7853981633974483


def rear_wheel_feedback_control(state, points, mask, target_speed,
                                cfg: RearWheelFeedbackConfig = RearWheelFeedbackConfig()):
    """ω = v·κ·cos(θe)/(1−κe) − kth·|v|·θe − ke·v·sin(θe)·e/θe;
    δ = atan(L·ω/v)."""
    v = state[..., 3]
    idx, e, theta_e, k = _path_errors(state, points, mask)
    tiny = torch.abs(theta_e) < 1e-9
    safe_th = torch.where(tiny, torch.ones_like(theta_e), theta_e)
    # v·e is the limit of v·sin(θe)·e/θe
    sin_term = torch.where(tiny, v * e, v * torch.sin(safe_th) * e / safe_th)
    omega = (v * k * torch.cos(theta_e) / torch.clamp(1.0 - k * e, min=1e-9)
             - cfg.kth * torch.abs(v) * theta_e
             - cfg.ke * sin_term)
    steer = torch.clamp(torch.atan2(cfg.wheelbase * omega, torch.clamp(torch.abs(v), min=1e-9)),
                        -cfg.max_steer, cfg.max_steer)
    accel = cfg.kp * (target_speed - v)
    return accel, steer, idx


# ---------------------------------------------------------------------------
# Move to pose (move_to_pose.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoveToPoseConfig:
    kp_rho: float = 9.0
    kp_alpha: float = 15.0
    kp_beta: float = -3.0
    dt: float = 0.01
    goal_tolerance: float = 0.001
    yaw_tolerance: float = 0.05
    max_steps: int = 10_000


def move_to_pose_control(pose, goal_pose, cfg: MoveToPoseConfig = MoveToPoseConfig()):
    """Polar ρ/α/β law (move_to_pose.rs; gains 9/15/−3): returns (v, ω)."""
    dx = goal_pose[..., 0] - pose[..., 0]
    dy = goal_pose[..., 1] - pose[..., 1]
    rho = norm2(torch.stack([dx, dy], dim=-1))
    alpha = normalize_angle(torch.atan2(dy, dx) - pose[..., 2])
    beta = normalize_angle(goal_pose[..., 2] - pose[..., 2] - alpha)
    v = cfg.kp_rho * rho
    w = cfg.kp_alpha * alpha + cfg.kp_beta * beta
    # drive backwards when the target is behind (PythonRobotics variant)
    return torch.where(torch.abs(alpha) > math.pi / 2, -v, v), w
