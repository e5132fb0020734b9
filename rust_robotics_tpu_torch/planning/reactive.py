"""Small reactive and optimization planners: elastic bands, DMP, PSO,
the LQR planner, bug algorithms.

The port of rust_robotics_tpu/planning/reactive.py. Reference
(crates/rust_robotics_planning/src/): elastic_bands.rs (internal spring +
external obstacle forces deforming a path), dynamic_movement_primitives.rs
(canonical system + learned forcing term), particle_swarm_optimization.rs
(global-best PSO), lqr_planner.rs (LQR steering toward a goal as a local
planner), bug_planning.rs / tangent_bug.rs (boundary following).

The band relaxes every waypoint at once an iteration, the DMP and the LQR
rollout step in order, the swarm moves as one tensor; each takes leading
batch dims. JAX runs these loops as compiled `fori_loop`/`scan` bodies,
where XLA contracts an update's a·b + c into one rounding; the port does
the same (`mul_add`). The products are `_small`'s explicit sums (no
matmul, so no TF32). PSO takes a torch objective and `draws=` (JAX's
uniforms) or a `torch.Generator`. The bug planners are host NumPy state
machines, in JAX too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import linspace, norm2, true_div
from rust_robotics_tpu_torch.control._small import as_float, mm, mv, rsum, take_rows
from rust_robotics_tpu_torch.control.trajopt import lqr_regulator
from rust_robotics_tpu_torch.planning.grid import _host_bool
from rust_robotics_tpu_torch.planning.rrt import mul_add


# ---------------------------------------------------------------------------
# Elastic bands (elastic_bands.rs)
# ---------------------------------------------------------------------------

def elastic_band_optimize(points, obstacles, radii, iterations=100, spring_gain=0.4,
                          repulse_gain=0.8, influence=2.0):
    """Deform paths points [..., N, 2] by internal contraction and obstacle
    repulsion, the endpoints fixed; returns the optimized [..., N, 2]."""
    pts = points
    obstacles = as_float(obstacles, pts.dtype, pts.device)
    radii = as_float(radii, pts.dtype, pts.device)
    n = pts.shape[-2]
    ar = torch.arange(n, device=pts.device)
    interior = ((ar > 0) & (ar < n - 1))[:, None]
    for _ in range(iterations):
        prev, nxt = torch.roll(pts, 1, -2), torch.roll(pts, -1, -2)
        internal = 0.5 * (prev + nxt) - pts
        d = pts[..., :, None, :] - obstacles  # [..., N, M, 2]
        dist = norm2(d)
        # break the collinear degeneracy (a path through an obstacle's
        # centre): there, push along the local path normal
        tangent = nxt - prev
        normal = torch.stack([-tangent[..., 1], tangent[..., 0]], -1)
        normal = normal / torch.clamp(norm2(normal), min=1e-9)[..., None]
        direction = torch.where((dist < 1e-3)[..., None], normal[..., None, :].expand(d.shape),
                                d / torch.clamp(dist, min=1e-6)[..., None])
        mag = torch.clamp(influence - (dist - radii), min=0.0)
        external = repulse_gain * rsum(mag[..., None] * direction, -2)
        step = mul_add(torch.full_like(internal, spring_gain), internal, external * 0.1)
        pts = torch.where(interior, pts + step, pts)
    return pts


# ---------------------------------------------------------------------------
# Dynamic movement primitives (dynamic_movement_primitives.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DMPConfig:
    alpha: float = 25.0
    beta: float = 6.25
    alpha_x: float = 3.0
    n_basis: int = 20
    tau: float = 1.0


def _basis(cfg, dtype, device):
    centers = torch.exp(-cfg.alpha_x * linspace(1.0, cfg.n_basis, dtype=dtype, device=device))
    return centers, cfg.n_basis ** 1.5 / centers


def _gradient(y, dt):
    """`jnp.gradient(y, dt, axis=0)`: central differences inside, one-sided
    at the ends."""
    h = torch.full((), dt, dtype=y.dtype, device=y.device)
    inner = (y[2:] - y[:-2]) * 0.5 / h
    return torch.cat([(y[1:2] - y[0:1]) / h, inner, (y[-1:] - y[-2:-1]) / h])


def dmp_fit(demo, dt, cfg: DMPConfig = DMPConfig()):
    """Basis weights [n_basis, D] learned from a demonstration [T, D]
    (locally weighted regression on the forcing term), and (y0, g)."""
    t = demo.shape[0]
    y = demo
    yd = _gradient(y, dt)
    ydd = _gradient(yd, dt)
    g, y0 = y[-1], y[0]
    k = torch.arange(t, device=y.device).to(y.dtype)
    x = torch.exp(true_div((-cfg.alpha_x * k) * dt, cfg.tau))
    f_target = cfg.tau**2 * ydd - cfg.alpha * (cfg.beta * (g - y) - cfg.tau * yd)
    centers, widths = _basis(cfg, y.dtype, y.device)
    psi = torch.exp(-widths[None, :] * (x[:, None] - centers[None, :]) ** 2)  # [T, B]
    xi = x[:, None] * (g - y0)[None, :]  # [T, D]
    num = mm(psi.T, xi * f_target)
    den = mm(psi.T, xi * xi) + 1e-10
    return num / den, (y0, g)


def dmp_rollout(weights, y0, g, steps, dt, cfg: DMPConfig = DMPConfig()):
    """Integrate the DMP: the trajectory [steps, D]."""
    centers, widths = _basis(cfg, weights.dtype, weights.device)
    y, yd = y0, torch.zeros_like(y0)
    x = torch.ones((), dtype=y0.dtype, device=y0.device)
    dt_ = torch.full((), dt, dtype=y0.dtype, device=y0.device)
    out = []
    for _ in range(steps):
        psi = torch.exp(-widths * (x - centers) ** 2)
        f = mv(weights.T, psi) * x * (g - y0) / torch.clamp(rsum(psi), min=1e-10)
        ydd = (cfg.alpha * (cfg.beta * (g - y) - cfg.tau * yd) + f) / cfg.tau**2
        yd = mul_add(ydd, dt_, yd)
        y = mul_add(yd, dt_, y)
        x = mul_add(true_div(-cfg.alpha_x * x, cfg.tau), dt_, x)
        out.append(y)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Particle swarm optimization (particle_swarm_optimization.rs)
# ---------------------------------------------------------------------------

def pso_minimize(generator, objective, dim, num_particles=64, iterations=100,
                 bounds=(-10.0, 10.0), w=0.7, c1=1.5, c2=1.5, draws=None, dtype=None,
                 device=None):
    """Global-best PSO; objective maps [..., P, dim] -> [..., P]. `draws` =
    (the initial positions [..., P, dim] in bounds, r1 and r2 [...,
    iterations, P, dim] uniforms), else drawn from `generator` on `device`
    (default cuda) in `dtype`. Returns (best_x [..., dim], best_f)."""
    lo, hi = bounds
    if draws is None:
        dev = resolve_device(device)
        f = torch.get_default_dtype() if dtype is None else dtype
        shape = (num_particles, dim)
        x = lo + torch.rand(shape, generator=generator, dtype=f, device=dev) * (hi - lo)
        r1, r2 = (torch.rand((iterations,) + shape, generator=generator, dtype=f, device=dev)
                  for _ in range(2))
    else:
        x, r1, r2 = draws
    v = torch.zeros_like(x)
    fx = objective(x)
    pbest, pbest_f = x, fx
    gi = torch.argmin(fx, dim=-1)
    gbest = take_rows(x, gi)
    for i in range(iterations):
        a = r1[..., i, :, :]
        b = r2[..., i, :, :]
        v = mul_add(c1 * a, pbest - x, w * v)
        v = mul_add(c2 * b, gbest[..., None, :] - x, v)
        x = torch.clamp(x + v, lo, hi)
        fx = objective(x)
        better = fx < pbest_f
        pbest = torch.where(better[..., None], x, pbest)
        pbest_f = torch.where(better, fx, pbest_f)
        gi = torch.argmin(pbest_f, dim=-1)
        gbest = take_rows(pbest, gi)
    return gbest, pbest_f.gather(-1, gi[..., None])[..., 0]


# ---------------------------------------------------------------------------
# LQR planner (lqr_planner.rs)
# ---------------------------------------------------------------------------

def lqr_plan(start_xy, goal_xy, steps=100, dt=0.1, dtype=None, device=None):
    """Double-integrator LQR steering toward the goal as a local planner;
    the rollout [..., steps, 2]. Host points go to `device` (default cuda)."""
    start = as_float(start_xy, dtype, device)
    goal = as_float(goal_xy, start.dtype, start.device)
    f, dev = start.dtype, start.device
    eye2 = torch.eye(2, dtype=f, device=dev)
    zero2 = torch.zeros((2, 2), dtype=f, device=dev)
    a = torch.cat([torch.cat([eye2, dt * eye2], 1), torch.cat([zero2, eye2], 1)], 0)
    b = torch.cat([0.5 * dt * dt * eye2, dt * eye2], 0)
    k = lqr_regulator(a, b, torch.eye(4, dtype=f, device=dev), 0.1 * eye2)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
    x = torch.cat([(start - goal).expand(batch + (2,)), torch.zeros(batch + (2,), dtype=f,
                                                                     device=dev)], -1)
    out = []
    for _ in range(steps):
        u = -mv(k, x)
        x = mv(a, x) + mv(b, u)
        out.append(x[..., :2] + goal)
    return torch.stack(out, -2)


# ---------------------------------------------------------------------------
# Bug planning (bug_planning.rs)
# ---------------------------------------------------------------------------

def bug2_plan(blocked, start_idx, goal_idx, max_steps=2000):
    """Bug2 on a raster: march along the start-goal line; on hit, follow
    the obstacle boundary (left-hand rule) until back on the line closer to
    the goal. Host-side FSM (the reference's sequential logic); returns
    (path [K, 2] int cells, reached)."""
    blocked = _host_bool(blocked)
    w, h = blocked.shape
    s = np.asarray(start_idx, int)
    g = np.asarray(goal_idx, int)

    def on_line(p):
        d = g - s
        cross = d[0] * (p[1] - s[1]) - d[1] * (p[0] - s[0])
        denom = max(np.hypot(*d), 1e-9)
        return abs(cross) / denom <= 0.71

    dirs4 = [(1, 0), (0, 1), (-1, 0), (0, -1)]

    def free(p):
        return 0 <= p[0] < w and 0 <= p[1] < h and not blocked[p[0], p[1]]

    def line_step(cur):
        # 4-connected march toward the goal, larger axis first
        d = g - cur
        order = ([(np.sign(d[0]), 0), (0, np.sign(d[1]))]
                 if abs(d[0]) >= abs(d[1])
                 else [(0, np.sign(d[1])), (np.sign(d[0]), 0)])
        return [np.asarray(o, int) for o in order if any(o)]

    path = [tuple(s)]
    cur = s.copy()
    mode = "line"
    heading = 0
    hit_dist = np.inf
    for _ in range(max_steps):
        if (cur == g).all():
            return np.array(path), True
        if mode == "line":
            steps = line_step(cur)
            nxt = cur + steps[0]
            if free(nxt):
                cur = nxt
            else:
                mode = "boundary"
                hit_dist = np.hypot(*(g - cur))
                # turn right at the hit: the wall ends up on the LEFT,
                # matching the left-hand try order below
                heading = (dirs4.index(tuple(steps[0])) - 1) % 4
                continue
        else:
            # left-hand wall following: try left, straight, right, back
            moved = False
            for k in (1, 0, -1, -2):
                nd = (heading + k) % 4
                nxt = cur + np.asarray(dirs4[nd])
                if free(nxt):
                    cur = nxt
                    heading = nd
                    moved = True
                    break
            if not moved:
                return np.array(path), False
            if on_line(cur) and np.hypot(*(g - cur)) < hit_dist - 0.5:
                mode = "line"
        path.append(tuple(cur))
    return np.array(path), False


def tangent_bug_plan(blocked, start_idx, goal_idx, sensor_range=6.0,
                     max_steps=2000):
    """Tangent Bug (tangent_bug.rs): motion-to-goal until the next cell is
    blocked, then boundary-following — scan boundary cells within
    `sensor_range`, take the one minimizing distance-to-goal as the tangent
    point, wall-follow toward it; leave when the direct step is free AND
    the current goal distance beats d_reach (recorded at the hit), per
    Kamon & Rivlin (1997). Host-side FSM mirroring bug2_plan; returns
    (path [K, 2] int cells, reached)."""
    blocked = _host_bool(blocked)
    w, h = blocked.shape
    s = np.asarray(start_idx, int)
    g = np.asarray(goal_idx, int)
    dirs4 = [(1, 0), (0, 1), (-1, 0), (0, -1)]

    def free(p):
        return 0 <= p[0] < w and 0 <= p[1] < h and not blocked[p[0], p[1]]

    def goal_step(cur):
        d = g - cur
        order = ([(np.sign(d[0]), 0), (0, np.sign(d[1]))]
                 if abs(d[0]) >= abs(d[1])
                 else [(0, np.sign(d[1])), (np.sign(d[0]), 0)])
        return [np.asarray(o, int) for o in order if any(o)]

    def boundary_cells_near(cur):
        """Free 4-neighbors of obstacle cells within sensor range of cur."""
        r = int(np.ceil(sensor_range))
        out = []
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                p = cur + np.array([dx, dy])
                if dx * dx + dy * dy > sensor_range ** 2 or not free(p):
                    continue
                if any(not free(p + np.asarray(d4)) and
                       0 <= p[0] + d4[0] < w and 0 <= p[1] + d4[1] < h
                       for d4 in dirs4):
                    out.append(p)
        return out

    path = [tuple(s)]
    cur = s.copy()
    mode = "goal"
    heading = 0
    d_reach = np.inf
    for _ in range(max_steps):
        if (cur == g).all():
            return np.array(path), True
        if mode == "goal":
            nxt = cur + goal_step(cur)[0]
            if free(nxt):
                cur = nxt
            else:
                mode = "boundary"
                d_reach = np.hypot(*(g - cur))
                blocked_dir = goal_step(cur)[0]
                # tangent point: sensed boundary cell closest to the goal
                # (tangent_bug.rs step 2) — its side of the blocked
                # direction picks the following hand
                bnd = boundary_cells_near(cur)
                if bnd:
                    dists = [np.hypot(*(g - p)) for p in bnd]
                    tangent = bnd[int(np.argmin(dists))]
                else:
                    tangent = g
                rel = tangent - cur
                cross = blocked_dir[0] * rel[1] - blocked_dir[1] * rel[0]
                hand = 1 if cross >= 0 else -1  # +1 left-hand, −1 right
                heading = (dirs4.index(tuple(blocked_dir)) - hand) % 4
                continue
        else:
            # hand-rule wall following (rounds corners); `hand` chosen
            # toward the tangent point at hit time
            moved = False
            for k in (hand, 0, -hand, -2 * hand):
                nd = (heading + k) % 4
                nxt = cur + np.asarray(dirs4[nd])
                if free(nxt):
                    cur = nxt
                    heading = nd
                    moved = True
                    break
            if not moved:
                return np.array(path), False
            direct_free = free(cur + goal_step(cur)[0]) if \
                goal_step(cur) else False
            if direct_free and np.hypot(*(g - cur)) < d_reach - 0.5:
                mode = "goal"
        path.append(tuple(cur))
    return np.array(path), False
