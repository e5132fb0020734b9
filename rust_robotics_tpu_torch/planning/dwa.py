"""Dynamic Window Approach local planner.

The port of rust_robotics_tpu/planning/dwa.py. Reference:
crates/rust_robotics_planning/src/dwa.rs — DWAConfig defaults (:88-108),
dynamic window = velocity box ∩ acceleration box (:356-377), trajectory
rollout with yaw-first integration (:379-400), costs: goal heading
|wrap(target_angle − yaw_f)| (:402-414), speed (max_speed − v_f)
(:416-422), obstacle 1/min_dist with collision → ∞ (:424-460); total =
Σ gains·costs, best (v, ω) wins (try_step :507).

The (v, ω) window is sampled on a fixed n_v × n_w lattice, and every
sample's rollout and obstacle distances are evaluated at once. Leading
batch dims (a fleet of robots) run in lock-step: nothing sums across
samples or robots, and the minima over states and obstacles are
order-free, so a lane equals its solo run bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import linspace
from rust_robotics_tpu_torch.core.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class DWAConfig:
    """dwa.rs:88-108 defaults; resolutions replaced by static sample counts."""

    max_speed: float = 1.0
    min_speed: float = -0.5
    max_yaw_rate: float = 0.6981317007977318  # 40°
    max_accel: float = 0.2
    max_delta_yaw_rate: float = 0.6981317007977318
    v_samples: int = 11
    w_samples: int = 41
    dt: float = 0.1
    predict_time: float = 3.0
    to_goal_cost_gain: float = 0.15
    speed_cost_gain: float = 1.0
    obstacle_cost_gain: float = 1.0
    robot_radius: float = 1.0
    goal_threshold: float = 1.0

    @property
    def horizon(self) -> int:
        return int(self.predict_time / self.dt) + 1


def dwa_motion(state, v, w, dt):
    """state [..., 5] = [x, y, yaw, v, ω]; yaw-first integration
    (dwa.rs:340-354, PythonRobotics order)."""
    yaw = state[..., 2] + w * dt
    x = state[..., 0] + v * torch.cos(yaw) * dt
    y = state[..., 1] + v * torch.sin(yaw) * dt
    return torch.stack([x, y, yaw, v + 0 * x, w + 0 * x], dim=-1)


def dynamic_window(state, cfg: DWAConfig):
    """(v_min, v_max, w_min, w_max) (dwa.rs:356-377)."""
    v, w = state[..., 3], state[..., 4]
    v_min = torch.clamp(v - cfg.max_accel * cfg.dt, min=cfg.min_speed)
    v_max = torch.clamp(v + cfg.max_accel * cfg.dt, max=cfg.max_speed)
    w_min = torch.clamp(w - cfg.max_delta_yaw_rate * cfg.dt, min=-cfg.max_yaw_rate)
    w_max = torch.clamp(w + cfg.max_delta_yaw_rate * cfg.dt, max=cfg.max_yaw_rate)
    return v_min, v_max, w_min, w_max


def rollout(state, v, w, cfg: DWAConfig):
    """Predict trajectories for control samples v, w [...]: returns states
    [..., H+1, 5] including the initial state (dwa.rs:379-400)."""
    states = [state]
    for _ in range(cfg.horizon):
        states.append(dwa_motion(states[-1], v, w, cfg.dt))
    return torch.stack(states, dim=-2)


def _gather_last(x, idx):
    """x[..., idx, ...]: the sample idx [...] of each lane, x [..., K, *tail]."""
    tail = x.shape[idx.ndim + 1:]
    index = idx.reshape(*idx.shape, 1, *([1] * len(tail))).expand(*idx.shape, 1, *tail)
    return torch.gather(x, idx.ndim, index).squeeze(idx.ndim)


def dwa_step(state, goal, obstacles, cfg: DWAConfig = DWAConfig(), obstacle_mask=None):
    """One DWA planning step (dwa.rs try_step :507).

    state [..., 5]; goal [..., 2]; obstacles [..., M, 2] (+ optional mask
    [..., M]). Returns (best_control [..., 2], next_state [..., 5],
    best_trajectory [..., H+1, 5], best_cost [...]). The argmin over the
    n_v·n_w samples takes the first of equal costs, as `jnp.argmin` does
    (the first sample when every one collides).
    """
    v_min, v_max, w_min, w_max = dynamic_window(state, cfg)
    f, dev = state.dtype, state.device
    vs = v_min[..., None] + (v_max - v_min)[..., None] * linspace(
        1.0, cfg.v_samples, dtype=f, device=dev)
    ws = w_min[..., None] + (w_max - w_min)[..., None] * linspace(
        1.0, cfg.w_samples, dtype=f, device=dev)
    batch = state.shape[:-1]
    k = cfg.v_samples * cfg.w_samples
    vv = vs[..., :, None].expand(*batch, cfg.v_samples, cfg.w_samples).reshape(*batch, k)
    ww = ws[..., None, :].expand(*batch, cfg.v_samples, cfg.w_samples).reshape(*batch, k)

    trajs = rollout(state[..., None, :].expand(*batch, k, 5), vv, ww, cfg)  # [..., K, H+1, 5]
    final = trajs[..., -1, :]

    # goal-heading cost (dwa.rs:402-414)
    target_angle = torch.atan2(goal[..., None, 1] - final[..., 1],
                               goal[..., None, 0] - final[..., 0])
    goal_cost = torch.abs(normalize_angle(target_angle - final[..., 2]))

    speed_cost = cfg.max_speed - final[..., 3]

    # obstacle cost (dwa.rs:424-460): min distance over (traj states × obs).
    # sqrt is monotone and correctly rounded, so the min of the squared
    # distances, then one sqrt, is bitwise the min of the distances.
    dx = trajs[..., :, None, 0] - obstacles[..., None, None, :, 0]
    dy = trajs[..., :, None, 1] - obstacles[..., None, None, :, 1]
    d2 = dx * dx + dy * dy  # [..., K, H+1, M]
    del dx, dy
    if obstacle_mask is not None:
        d2 = torch.where(obstacle_mask[..., None, None, :], d2, torch.inf)
    min_dist = torch.sqrt(torch.amin(d2, dim=(-2, -1)))
    del d2
    collided = min_dist <= cfg.robot_radius
    obstacle_cost = torch.where(collided, torch.inf, 1.0 / min_dist)

    total = (
        cfg.to_goal_cost_gain * goal_cost
        + cfg.speed_cost_gain * speed_cost
        + cfg.obstacle_cost_gain * obstacle_cost
    )
    best = torch.argmin(total, dim=-1)
    v_best, w_best = _gather_last(vv, best), _gather_last(ww, best)
    best_control = torch.stack([v_best, w_best], dim=-1)
    next_state = dwa_motion(state, v_best, w_best, cfg.dt)
    return best_control, next_state, _gather_last(trajs, best), _gather_last(total, best)


def goal_reached(state, goal, cfg: DWAConfig = DWAConfig()):
    """|state[:2] − goal| ≤ goal_threshold, per robot over leading dims."""
    d = state[..., :2] - goal
    return torch.sqrt(torch.sum(d * d, dim=-1)) <= cfg.goal_threshold
