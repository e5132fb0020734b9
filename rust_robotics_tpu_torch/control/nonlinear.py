"""Classic nonlinear controllers: sliding mode, feedback linearization,
backstepping.

The port of rust_robotics_tpu/control/nonlinear.py. Reference
(crates/rust_robotics_control/src/): sliding_mode_control.rs (s = ė + λe
surface, u = −k·sat(s/φ) with boundary layer), feedback_linearization.rs
(unicycle point-offset linearization), backstepping_control.rs (kinematic
backstepping for pose tracking).

Elementwise functions over leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.core.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class SlidingModeConfig:
    lam: float = 2.0
    gain: float = 5.0
    boundary: float = 0.1  # boundary-layer width φ (chattering reduction)


def sliding_mode_control(error, error_dot, cfg: SlidingModeConfig = SlidingModeConfig()):
    """u = −k·sat(s/φ), s = ė + λe (sliding_mode_control.rs)."""
    s = error_dot + cfg.lam * error
    sat = torch.clamp(true_div(s, cfg.boundary), -1.0, 1.0)
    return -cfg.gain * sat, s


@dataclasses.dataclass(frozen=True)
class FeedbackLinConfig:
    offset: float = 0.2  # look-ahead point offset b
    kp: float = 2.0


def feedback_linearization_control(pose, target_xy, target_vel_xy,
                                   cfg: FeedbackLinConfig = FeedbackLinConfig()):
    """Unicycle point-offset feedback linearization
    (feedback_linearization.rs): control the point b ahead of the axle;
    [v; ω] = T(θ)⁻¹ u with u = ṗ_des + kp (p_des − p)."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    b = cfg.offset
    c, s = torch.cos(th), torch.sin(th)
    px = x + b * c
    py = y + b * s
    ux = target_vel_xy[..., 0] + cfg.kp * (target_xy[..., 0] - px)
    uy = target_vel_xy[..., 1] + cfg.kp * (target_xy[..., 1] - py)
    v = c * ux + s * uy
    w = true_div(-s * ux + c * uy, b)
    return v, w


@dataclasses.dataclass(frozen=True)
class BacksteppingConfig:
    k1: float = 2.0  # x-error gain
    k2: float = 8.0  # y-error gain
    k3: float = 3.0  # heading gain


def backstepping_control(pose, ref_pose, ref_v, ref_w,
                         cfg: BacksteppingConfig = BacksteppingConfig()):
    """Kinematic backstepping tracking law (backstepping_control.rs), the
    classic (Kanayama) v = v_r cos e_θ + k1 e_x;
    ω = ω_r + v_r (k2 e_y + k3 sin e_θ)."""
    th = pose[..., 2]
    dx = ref_pose[..., 0] - pose[..., 0]
    dy = ref_pose[..., 1] - pose[..., 1]
    c, s = torch.cos(th), torch.sin(th)
    ex = c * dx + s * dy
    ey = -s * dx + c * dy
    eth = normalize_angle(ref_pose[..., 2] - th)
    v = ref_v * torch.cos(eth) + cfg.k1 * ex
    w = ref_w + ref_v * (cfg.k2 * ey + cfg.k3 * torch.sin(eth))
    return v, w
