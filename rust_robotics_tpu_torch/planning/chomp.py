"""CHOMP: covariant gradient trajectory optimization.

The port of rust_robotics_tpu/planning/chomp.py. Reference:
crates/rust_robotics_planning/src/chomp.rs — a waypoint trajectory
initialized as a straight line with a tiny sine bump (:143), gradient
descent with a backtracking line search each iteration (8 halvings, accept
on non-increase :90-:110), the smoothness gradient −2·(x_{i−1} − 2x_i +
x_{i+1})/dt² (:155), the obstacle gradient within the influence band
(:160), cost = Σ‖second-diff‖²/dt² + Σ½·penetration² (:175-:195);
endpoints pinned.

The trajectory updates as one [..., N, 2] tensor an iteration (leading
dims are independent problems); the line search tries every halving and
keeps the first that does not raise the cost. A problem stops at its own
convergence flag and stays there, as JAX's `while_loop` does; the flags
are read once every READ_EVERY iterations.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._numeric import linspace, norm2, true_div
from rust_robotics_tpu_torch.control._small import as_float
from rust_robotics_tpu_torch.planning.rrt import mul_add

__all__ = ["ChompConfig", "chomp_optimize"]

INFLUENCE_DISTANCE = 2.0
ROBOT_RADIUS = 0.8
READ_EVERY = 8


@dataclasses.dataclass(frozen=True)
class ChompConfig:
    """chomp.rs ChompConfig defaults."""

    n_waypoints: int = 50
    dt: float = 0.1
    max_iterations: int = 100
    learning_rate: float = 0.01
    obstacle_cost_weight: float = 1.0
    smoothness_weight: float = 1.0
    line_search_halvings: int = 8


def _second_diff(x):
    """x_{i−1} − 2x_i + x_{i+1} of the interior waypoints; zeros at the ends."""
    d = x[..., :-2, :] - 2.0 * x[..., 1:-1, :] + x[..., 2:, :]
    z = torch.zeros_like(x[..., :1, :])
    return torch.cat([z, d, z], -2)


def chomp_optimize(start, goal, obstacles, radii, cfg: ChompConfig = ChompConfig(), dtype=None,
                   device=None):
    """Returns (waypoints [..., N, 2], cost, iterations) — ChompResult."""
    start = as_float(start, dtype, device)
    f, dev = start.dtype, start.device
    goal, obstacles, radii = (as_float(v, f, dev) for v in (goal, obstacles, radii))
    n = cfg.n_waypoints
    t = linspace(1.0, n, dtype=f, device=dev)[:, None]
    # the straight line and the tiny sine bump off it (chomp.rs:143), each
    # multiply-add rounded once as XLA fuses it (JAX jits the optimizer)
    x0 = mul_add(t, (goal - start)[..., None, :], start[..., None, :])
    bump = mul_add(torch.full_like(t, 1e-3), torch.sin(math.pi * t), x0[..., 1:])
    x = torch.cat([x0[..., :1], bump], -1)
    dt2 = cfg.dt * cfg.dt
    reach = radii + ROBOT_RADIUS

    def cost(x):
        sd = x[..., :-2, :] - 2.0 * x[..., 1:-1, :] + x[..., 2:, :]
        smooth = true_div(torch.sum(sd * sd, (-2, -1)), dt2)
        signed = norm2(x[..., :, None, :] - obstacles) - reach
        pen = torch.where(signed < INFLUENCE_DISTANCE, INFLUENCE_DISTANCE - signed, 0.0)
        return (cfg.smoothness_weight * smooth
                + cfg.obstacle_cost_weight * torch.sum(0.5 * pen * pen, (-2, -1)))

    def gradient(x):
        smooth_g = true_div(-2.0 * _second_diff(x), dt2)
        delta = x[..., :, None, :] - obstacles  # [..., N, M, 2]
        norm = torch.clamp(norm2(delta), min=1e-9)
        signed = norm - reach
        direction = delta / norm[..., None]
        obs_g = -torch.sum(torch.where((signed < INFLUENCE_DISTANCE)[..., None],
                                       (INFLUENCE_DISTANCE - signed)[..., None] * direction, 0.0),
                           -2)
        g = cfg.smoothness_weight * smooth_g + cfg.obstacle_cost_weight * obs_g
        ends = torch.arange(n, device=dev)
        return torch.where(((ends == 0) | (ends == n - 1))[:, None], 0.0, g)  # endpoints pinned

    c = cost(x)
    it = torch.zeros(c.shape, dtype=torch.int64, device=dev)
    done = torch.zeros(c.shape, dtype=torch.bool, device=dev)
    for k in range(cfg.max_iterations):
        g = gradient(x)
        accepted = torch.zeros_like(done)
        bx, bc = x, c
        for h in range(cfg.line_search_halvings):
            nx = x - (cfg.learning_rate * 0.5 ** h) * g
            nc = cost(nx)
            take = ~accepted & (nc <= c)
            accepted = accepted | take
            bx = torch.where(take[..., None, None], nx, bx)
            bc = torch.where(take, nc, bc)
        converged = ~accepted | (torch.abs(c - bc) < 1e-9)
        x = torch.where(done[..., None, None], x, bx)
        c = torch.where(done, c, bc)
        it = it + (~done).to(torch.int64)
        done = done | converged
        if (k + 1) % READ_EVERY == 0 and bool(done.all()):
            break
    return x, c, it
