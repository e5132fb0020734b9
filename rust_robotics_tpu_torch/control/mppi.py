"""Model Predictive Path Integral (MPPI) control.

The port of rust_robotics_tpu/control/mppi.py. Reference:
crates/rust_robotics_control/src/mppi.rs — the double-integrator MPPI core
(:892-1010): sample K noisy control sequences around the nominal, roll out
the dynamics, weight exponentially by path cost with temperature λ, update
the nominal with the weighted noise average; sampling diagnostics (:857:
ESS, best/mean cost). The racing / person-following / pusher-slider
variants specialize dynamics + cost.

Rollouts run all K samples at once, one horizon step at a time.
`dynamics` and `cost` are user callables over leading dims. Leading batch
dims of `state` and `u_nominal` are independent planners (a fleet) in
lock-step: the sums over samples are pairwise halves of whole slices
(`_small.rsum`), the sum over the horizon is accumulated step by step, and
the minimum is order-free, so a robot equals its solo plan bit for bit.
The noise is `draws=` (the standard normals JAX's key gives) or drawn from
a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from rust_robotics_tpu_torch._numeric import filled, norm2, true_div
from rust_robotics_tpu_torch.control._small import rsum


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 30
    num_samples: int = 256
    temperature: float = 1.0  # λ
    noise_sigma: tuple = (0.5, 0.5)
    control_min: tuple = (-2.0, -2.0)
    control_max: tuple = (2.0, 2.0)
    dt: float = 0.1


@dataclasses.dataclass(frozen=True)
class MPPIDiagnostics:
    """MppiSamplingDiagnostics2D analog (mppi.rs:857)."""

    best_cost: Any
    mean_cost: Any
    effective_sample_size: Any


def mppi_plan(generator, dynamics: Callable, stage_cost: Callable, terminal_cost: Callable, state,
              u_nominal, cfg: MPPIConfig = MPPIConfig(), draws=None):
    """One MPPI update.

    dynamics(state [..., n], u [..., m], dt) -> state'
    stage_cost(state [..., n], u [..., m]) -> cost [...]
    terminal_cost(state [..., n]) -> cost [...]
    state [B..., n]; u_nominal [B..., H, m]; draws [B..., K, H, m]
    standard normals (else drawn from `generator`, a `torch.Generator` on
    the state's device, or None).

    Returns (u_new [B..., H, m], first_control [B..., m], diagnostics).
    """
    h, m = u_nominal.shape[-2:]
    k = cfg.num_samples
    f, dev = state.dtype, state.device
    batch = state.shape[:-1]
    sigma = filled(cfg.noise_sigma, f, dev)
    lo, hi = filled(cfg.control_min, f, dev), filled(cfg.control_max, f, dev)
    if draws is None:
        draws = torch.randn(batch + (k, h, m), generator=generator, dtype=f, device=dev)
    noise = draws * sigma
    u_nom = u_nominal[..., None, :, :]
    controls = torch.minimum(torch.maximum(u_nom + noise, lo), hi)
    clipped_noise = controls - u_nom

    states = state[..., None, :].expand(batch + (k, state.shape[-1]))
    total = None
    for t in range(h):
        states = dynamics(states, controls[..., t, :], cfg.dt)
        c = stage_cost(states, controls[..., t, :])
        total = c if total is None else total + c
    total = total + terminal_cost(states)  # [B..., K]

    beta = torch.amin(total, dim=-1)
    w = torch.exp(-true_div(total - beta[..., None], cfg.temperature))
    w_sum = rsum(w, -1)
    w = w / w_sum[..., None]
    u_new = u_nominal + rsum(w[..., None, None] * clipped_noise, -3)
    u_new = torch.minimum(torch.maximum(u_new, lo), hi)
    diag = MPPIDiagnostics(best_cost=beta, mean_cost=true_div(rsum(total, -1), k),
                           effective_sample_size=1.0 / rsum(w * w, -1))
    return u_new, u_new[..., 0, :], diag


def shift_nominal(u, fill=None):
    """Receding-horizon shift: drop the executed control, repeat the last."""
    tail = u[..., -1:, :] if fill is None else torch.broadcast_to(fill, u[..., -1:, :].shape)
    return torch.cat([u[..., 1:, :], tail], dim=-2)


# ---------------------------------------------------------------------------
# Double-integrator demo problem (mppi.rs:892-1010)
# ---------------------------------------------------------------------------

def double_integrator_dynamics(state, u, dt):
    """[x, y, vx, vy]; u = accel [ax, ay]."""
    x = state[..., 0] + state[..., 2] * dt
    y = state[..., 1] + state[..., 3] * dt
    vx = state[..., 2] + u[..., 0] * dt
    vy = state[..., 3] + u[..., 1] * dt
    return torch.stack([x, y, vx, vy], dim=-1)


def make_goal_costs(goal, obstacles=None, obstacle_radius=0.5, control_weight=0.01,
                    obstacle_weight=100.0):
    """Goal-seeking stage/terminal costs with optional circular obstacles
    (goal [2] and obstacles [M, 2] tensors)."""

    def stage(state, u):
        c = rsum((state[..., :2] - goal) ** 2, -1)
        c = c + control_weight * rsum(u ** 2, -1)
        if obstacles is not None:
            d = norm2(state[..., None, :2] - obstacles)
            c = c + obstacle_weight * rsum(torch.clamp(obstacle_radius - d, min=0.0) ** 2, -1)
        return c

    def terminal(state):
        return 10.0 * rsum((state[..., :2] - goal) ** 2, -1) + rsum(state[..., 2:] ** 2, -1)

    return stage, terminal
