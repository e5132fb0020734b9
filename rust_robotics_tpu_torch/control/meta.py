"""Meta control: performance-gated controller switching + LQR speed+steer.

The port of rust_robotics_tpu/control/meta.py. Reference
(crates/rust_robotics_control/src/): meta_control.rs (484: mode selection
between trackers based on running error statistics),
lqr_speed_steer_control.rs (938: joint 5-state LQR over lateral error AND
speed error).

Both candidate controllers evaluate every step; the selector is a
hysteresis latch on an exponentially-averaged cross-track error. Every
function takes leading batch dims (a fleet of vehicles; the path [N, 2] +
mask shared or given per vehicle). The LQR builds each vehicle's [5, 5]
model, iterates its own DARE (`trackers.solve_dare`, flags read every
`_small.READ_EVERY` iterations) and solves its gain by `_small.solve_small`,
so a lane equals its solo run bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import norm2, true_div
from rust_robotics_tpu_torch.control._small import mm, mt, mv, solve_small, take, take_rows
from rust_robotics_tpu_torch.control.trackers import _masked_nearest, _path_errors, solve_dare
from rust_robotics_tpu_torch.core.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class MetaControlConfig:
    error_alpha: float = 0.1       # EMA smoothing of |cross-track|
    switch_high: float = 0.8       # primary→fallback threshold
    switch_low: float = 0.3        # fallback→primary threshold


def meta_select(use_fallback, ema_error, abs_error, cfg: MetaControlConfig = MetaControlConfig()):
    """Update the EMA and the hysteresis latch; returns (use_fallback', ema')."""
    ema = (1.0 - cfg.error_alpha) * ema_error + cfg.error_alpha * abs_error
    nxt = torch.where(ema > cfg.switch_high, True,
                      torch.where(ema < cfg.switch_low, False, use_fallback))
    return nxt, ema


def meta_control_step(state, points, mask, target_speed, use_fallback, ema_error, primary_fn,
                      fallback_fn, cfg: MetaControlConfig = MetaControlConfig()):
    """Evaluate both controllers, select by latch, update statistics.
    primary_fn/fallback_fn: state -> (accel, steer, aux). Returns
    (accel, steer, use_fallback', ema')."""
    a1, s1, _ = primary_fn(state)
    a2, s2, _ = fallback_fn(state)
    accel = torch.where(use_fallback, a2, a1)
    steer = torch.where(use_fallback, s2, s1)
    idx = _masked_nearest(state[..., :2], points, mask)
    err = norm2(state[..., :2] - take_rows(points, idx))
    nxt, ema = meta_select(use_fallback, ema_error, err, cfg)
    return accel, steer, nxt, ema


# ---------------------------------------------------------------------------
# LQR speed + steer (lqr_speed_steer_control.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LQRSpeedSteerConfig:
    wheelbase: float = 0.5
    max_steer: float = 0.7853981633974483
    q_diag: tuple = (1.0, 1.0, 1.0, 1.0, 0.5)
    r_diag: tuple = (1.0, 1.0)
    dt: float = 0.1
    dare_iterations: int = 150
    dare_tolerance: float = 0.01


def lqr_speed_steer_control(state, points, mask, speed_profile, prev_error, prev_theta_error,
                            cfg: LQRSpeedSteerConfig = LQRSpeedSteerConfig()):
    """Joint 5-state LQR [e, ė, θe, θ̇e, v_err] → [δ, a]
    (lqr_speed_steer_control.rs): the 4-state lateral model of
    lqr_steer_control plus a speed-error channel driven by acceleration.
    Returns (accel, steer, (e, θe)); each vehicle of the leading dims has
    its own model and DARE."""
    v = state[..., 3]
    idx, e, theta_e, k = _path_errors(state, points, mask)
    v_err = v - take(speed_profile, idx)

    dt = cfg.dt
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    z5 = [zero] * 5
    a = torch.stack([
        torch.stack([one, zero + dt, zero, zero, zero], -1),
        torch.stack([zero, zero, v, zero, zero], -1),
        torch.stack([zero, zero, one, zero + dt, zero], -1),
        torch.stack(z5, -1),
        torch.stack([zero, zero, zero, zero, one], -1),
    ], -2)
    b = torch.stack([
        torch.stack([zero, zero], -1),
        torch.stack([zero, zero], -1),
        torch.stack([zero, zero], -1),
        torch.stack([true_div(v, cfg.wheelbase), zero], -1),
        torch.stack([zero, zero + dt], -1),
    ], -2)
    q = torch.diag_embed(torch.stack([zero + qi for qi in cfg.q_diag], -1))
    r = torch.diag_embed(torch.stack([zero + ri for ri in cfg.r_diag], -1))
    p = solve_dare(a, b, q, r, cfg.dare_iterations, cfg.dare_tolerance)
    bt = mt(b)
    btp = mm(bt, p)
    k_gain = solve_small(r + mm(btp, b), mm(btp, a))  # [..., 2, 5]
    xvec = torch.stack([e, true_div(e - prev_error, dt), theta_e,
                        true_div(theta_e - prev_theta_error, dt), v_err], dim=-1)
    u = -mv(k_gain, xvec)
    ff = torch.atan2(cfg.wheelbase * k, torch.ones_like(k))
    steer = torch.clamp(ff + normalize_angle(u[..., 0]), -cfg.max_steer, cfg.max_steer)
    accel = u[..., 1]
    return accel, steer, (e, theta_e)
