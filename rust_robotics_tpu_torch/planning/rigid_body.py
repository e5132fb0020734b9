"""Rigid-body planning with MIP-style disjunctive separation certificates.

The port of rust_robotics_tpu/planning/rigid_body.py. Reference:
crates/rust_robotics_planning/src/rigid_body_mip.rs — a deterministic
SE(2)-lattice planner (position_step × heading_count grid, translate/turn
moves with integer move_cost/turn_cost) where every accepted pose carries
the binary disjunctive certificate of convex-obstacle MILP formulations:
for each obstacle, ONE active half-space (from the obstacle's CCW edges,
a·x + b·y ≤ c containing the interior) separates the whole robot rectangle
with margin > clearance (min signed violation over the 4 rotated vertices,
:357-:430); segment feasibility checks the swept rectangle at α ∈ {0, ½, 1}
(:382). A sampling RRT backend reports the same comparable outcome metrics
(path length, heading change, iterations, min separation margin,
:217-:243).

Pose feasibility and certificates for the whole (heading × x × y) lattice
are one batched tensor program; a margin is a·x + b·y − c written out
over the two coordinates, so a pose's margins do not depend on the batch.
The search is a min-plus relaxation over the [H, NX, NY] raster (8
translations at fixed heading + ±1 heading turns) in blocks of 4 sweeps,
its changed flag read once a block, as JAX's `while_loop` tests it. The
path descent is a host loop, in JAX too, and lists its candidates in JAX's
order (`min` keeps the first tie). The RRT backend is a host NumPy loop
seeded by an integer (`seed`; JAX draws it with
`jax.random.randint(key, (), 0, 2**31 - 1)`) or a NumPy Generator; each
segment check evaluates its 3 poses in one device call and one read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from rust_robotics_tpu_torch._device import _placement, resolve_device
from rust_robotics_tpu_torch._numeric import filled

__all__ = [
    "RigidBodyConfig",
    "convex_polygon_halfspaces",
    "aabb_obstacle",
    "robot_vertices",
    "separation_margins",
    "pose_certificates",
    "lattice_feasibility",
    "rigid_body_lattice_plan",
    "rigid_body_rrt_plan",
]

BLOCK = 4  # sweeps between reads of the relaxation's changed flag


@dataclasses.dataclass(frozen=True)
class RigidBodyConfig:
    """RigidBodyMipConfig2D (rigid_body_mip.rs:159)."""

    min_x: float = 0.0
    max_x: float = 10.0
    min_y: float = 0.0
    max_y: float = 10.0
    position_step: float = 0.5
    heading_count: int = 8
    robot_half_length: float = 0.55
    robot_half_width: float = 0.25
    clearance: float = 0.02
    move_cost: float = 10.0
    turn_cost: float = 3.0


def convex_polygon_halfspaces(vertices, dtype=torch.float32, device=None):
    """CCW polygon → edge half-spaces a·x + b·y ≤ c containing the interior
    (rigid_body_mip.rs:76-118). Returns [E, 3] rows (a, b, c), computed in
    float64 on the host and placed on `device` (default cuda) in `dtype`."""
    v = np.asarray(vertices, float)
    area = 0.5 * np.sum(v[:, 0] * np.roll(v[:, 1], -1) - np.roll(v[:, 0], -1) * v[:, 1])
    if area < 0:
        v = v[::-1]
    nxt = np.roll(v, -1, axis=0)
    d = nxt - v
    # (dy, -dx, dy·x0 − dx·y0): interior (left of CCW edge) satisfies ≤ c
    hs = np.stack([d[:, 1], -d[:, 0], d[:, 1] * v[:, 0] - d[:, 0] * v[:, 1]], axis=1)
    return torch.as_tensor(hs, device=resolve_device(device)).to(dtype)


def aabb_obstacle(min_x, max_x, min_y, max_y, dtype=torch.float32, device=None):
    return convex_polygon_halfspaces(
        [(min_x, min_y), (max_x, min_y), (max_x, max_y), (min_x, max_y)], dtype, device)


def _stack_obstacles(obstacles, dtype=None, device=None):
    """Pad ragged half-space lists to [O, E_max, 3] + validity mask, on the
    first obstacle's device and in its dtype unless given."""
    obstacles = [torch.as_tensor(o) for o in obstacles]
    dtype = dtype or obstacles[0].dtype
    device = _placement(obstacles[0], device)
    e_max = max(o.shape[0] for o in obstacles)
    hs = torch.stack([
        F.pad(o.to(device=device, dtype=dtype), (0, 0, 0, e_max - o.shape[0])) for o in obstacles
    ])
    arange = torch.arange(e_max, device=device)
    valid = torch.stack([arange < o.shape[0] for o in obstacles])
    return hs, valid


def robot_vertices(pose, half_length, half_width):
    """4 rotated rectangle corners [..., 4, 2] (rigid_body_mip.rs:357)."""
    c, s = torch.cos(pose[..., 2])[..., None], torch.sin(pose[..., 2])[..., None]
    lx = filled((half_length, half_length, -half_length, -half_length), pose.dtype, pose.device)
    ly = filled((half_width, -half_width, -half_width, half_width), pose.dtype, pose.device)
    x = pose[..., None, 0] + c * lx - s * ly
    y = pose[..., None, 1] + s * lx + c * ly
    return torch.stack([x, y], dim=-1)


def separation_margins(vertices, halfspaces, valid):
    """[..., O, E] margins: min over vertices of a·x + b·y − c (positive ⇒
    all vertices outside that half-space). Invalid edge slots → −inf."""
    x = vertices[..., None, None, :, 0]  # [..., 1, 1, V]
    y = vertices[..., None, None, :, 1]
    a, b, c = (halfspaces[..., i, None] for i in range(3))  # [O, E, 1]
    proj = (a * x + b * y) - c
    m = torch.amin(proj, dim=-1)
    return torch.where(valid, m, -torch.inf)


def pose_certificates(pose, obstacles_hs, valid, cfg: RigidBodyConfig):
    """Per-obstacle best separating half-space (index, margin) for a pose;
    feasible iff every obstacle has margin > clearance and the rectangle is
    in bounds. Returns (feasible, halfspace_idx [..., O], margins [..., O])."""
    v = robot_vertices(pose, cfg.robot_half_length, cfg.robot_half_width)
    inb = torch.all((v[..., 0] >= cfg.min_x) & (v[..., 0] <= cfg.max_x)
                    & (v[..., 1] >= cfg.min_y) & (v[..., 1] <= cfg.max_y), dim=-1)
    m = separation_margins(v, obstacles_hs, valid)  # [..., O, E]
    best = torch.argmax(m, dim=-1)  # the first of equal margins, as jnp.argmax
    margin = torch.amax(m, dim=-1)
    feasible = inb & torch.all(margin > cfg.clearance, dim=-1)
    return feasible, best, margin


def lattice_feasibility(obstacles_hs, valid, cfg: RigidBodyConfig, nx: int, ny: int):
    """Feasibility + certificates for the whole [H, NX, NY] lattice in one
    batched program, on the obstacles' device and in their dtype. Returns
    (poses [H, NX, NY, 3] as (x, y, θ), feasible, best, margin)."""
    hs = cfg.heading_count
    dev, dt = obstacles_hs.device, obstacles_hs.dtype
    th = torch.arange(hs, dtype=dt, device=dev) * (2.0 * np.pi / hs)
    xs = cfg.min_x + torch.arange(nx, dtype=dt, device=dev) * cfg.position_step
    ys = cfg.min_y + torch.arange(ny, dtype=dt, device=dev) * cfg.position_step
    g = torch.meshgrid(th, xs, ys, indexing="ij")
    poses = torch.stack([g[1], g[2], g[0]], dim=-1)  # (x, y, theta)
    feasible, best, margin = pose_certificates(poses, obstacles_hs, valid, cfg)
    return poses, feasible, best, margin


def _relax_se2(free, move_cost, turn_cost, goals, max_iters=None, dtype=torch.float32):
    """Min-plus relaxation over [H, NX, NY]: 8 translations at fixed
    heading + ±1 heading turns (wrapping), in blocks of BLOCK sweeps with
    the changed flag read once a block."""
    big = torch.finfo(dtype).max / 4
    d = torch.where(goals & free, torch.zeros((), dtype=dtype, device=free.device),
                    torch.full((), big, dtype=dtype, device=free.device))
    h, nx, ny = free.shape
    if max_iters is None:
        max_iters = 4 * (nx + ny + h)
    moves = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)]
    blocked = torch.full((), big, dtype=dtype, device=free.device)

    def sweep(d):
        best = d
        p = F.pad(d, (1, 1, 1, 1), value=big)
        for dx, dy in moves:
            cand = p[:, 1 + dx: 1 + dx + nx, 1 + dy: 1 + dy + ny] + move_cost
            best = torch.minimum(best, torch.where(free, cand, blocked))
        for r in (1, -1):
            cand = torch.roll(d, r, dims=0) + turn_cost
            best = torch.minimum(best, torch.where(free, cand, blocked))
        return best

    it = 0
    while it < max_iters:
        new = d
        for _ in range(BLOCK):
            new = sweep(new)
        changed = bool(torch.any(new < d))
        d, it = new, it + BLOCK
        if not changed:
            break
    return torch.where(d >= big, torch.inf, d)


def _path_metrics(pose_path):
    dxy = np.diff(pose_path[:, :2], axis=0)
    dth = np.diff(np.unwrap(pose_path[:, 2]))
    return float(np.linalg.norm(dxy, axis=1).sum()), float(np.abs(dth).sum())


def rigid_body_lattice_plan(start, goal, obstacles, cfg: RigidBodyConfig = RigidBodyConfig(),
                            require_goal_heading: bool = True, dtype=None, device=None):
    """Deterministic lattice backend (RigidBodyMipPlanner2D::plan):
    min-cost translate/turn path where every pose carries a separation
    certificate. `obstacles`: [E, 3] half-space tensors (on their device
    and in their dtype unless `device`/`dtype` are given). Returns None
    when the start cannot reach the goal, else dict(poses [K, 3],
    certificate_halfspaces [K, O], certificate_margins [K, O], total_cost,
    path_length, heading_change, iterations (feasible lattice states),
    min_separation_margin), host NumPy."""
    obstacles_hs, valid = _stack_obstacles(obstacles, dtype, device)
    nx = int(round((cfg.max_x - cfg.min_x) / cfg.position_step)) + 1
    ny = int(round((cfg.max_y - cfg.min_y) / cfg.position_step)) + 1
    poses, feasible, best_hs, margins = lattice_feasibility(obstacles_hs, valid, cfg, nx, ny)
    h = cfg.heading_count

    def snap(p):
        ih = int(round((p[2] % (2 * np.pi)) / (2 * np.pi / h))) % h
        ix = int(round((p[0] - cfg.min_x) / cfg.position_step))
        iy = int(round((p[1] - cfg.min_y) / cfg.position_step))
        return ih, ix, iy

    s = snap(np.asarray(start, float))
    g = snap(np.asarray(goal, float))
    goals = torch.zeros((h, nx, ny), dtype=torch.bool, device=feasible.device)
    if require_goal_heading:
        goals[g[0], g[1], g[2]] = True
    else:
        goals[:, g[1], g[2]] = True
    costs = _relax_se2(feasible, cfg.move_cost, cfg.turn_cost, goals, dtype=obstacles_hs.dtype)
    d = costs.cpu().numpy()
    if not np.isfinite(d[s]):
        return None

    # greedy descent over the SE(2) raster
    cur = s
    path = [cur]
    for _ in range(d.size):
        if d[cur] <= 0:
            break
        cands = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if (dx, dy) == (0, 0):
                    continue
                q = (cur[0], cur[1] + dx, cur[2] + dy)
                if 0 <= q[1] < nx and 0 <= q[2] < ny:
                    cands.append((d[q] + cfg.move_cost, q))
        for r in (1, -1):
            q = ((cur[0] + r) % h, cur[1], cur[2])
            cands.append((d[q] + cfg.turn_cost, q))
        _, q = min(cands, key=lambda z: z[0])
        if d[q] >= d[cur]:
            break
        cur = q
        path.append(cur)
    idx = tuple(np.asarray(path).T)
    pose_path = poses.cpu().numpy()[idx]
    cert_hs = best_hs.cpu().numpy()[idx]
    cert_m = margins.cpu().numpy()[idx]
    length, turn = _path_metrics(pose_path)
    return {
        "backend": "lattice",
        "poses": pose_path,
        "certificate_halfspaces": cert_hs,
        "certificate_margins": cert_m,
        "total_cost": float(d[s]),
        "path_length": length,
        "heading_change": turn,
        "iterations": int(feasible.sum()),
        "min_separation_margin": float(cert_m.min()),
    }


def rigid_body_rrt_plan(seed, start, goal, obstacles, cfg: RigidBodyConfig = RigidBodyConfig(),
                        max_nodes: int = 256, expand: float = 0.8, dtype=None, device=None):
    """Sampling backend (RigidBodyRrtBackend2D): SE(2) RRT whose edges are
    validated by swept-rectangle certificates at α ∈ {0, ½, 1}
    (rigid_body_mip.rs:382). Same outcome metrics as the lattice backend.
    `seed`: the integer that seeds NumPy's generator, or a
    `np.random.Generator`. The tree lives on the host in float64; the
    certificates run on the obstacles' device in their dtype (or `device`,
    `dtype`)."""
    obstacles_hs, valid = _stack_obstacles(obstacles, dtype, device)
    dev, dt = obstacles_hs.device, obstacles_hs.dtype

    def feasible_segment(a, b):
        mid = 0.5 * (np.asarray(a) + np.asarray(b))
        ok, _, _ = pose_certificates(torch.as_tensor(np.stack([a, mid, b]), device=dev).to(dt),
                                     obstacles_hs, valid, cfg)
        return bool(ok.all())

    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(int(seed))
    nodes = [np.asarray(start, float)]
    parents = [-1]
    goal = np.asarray(goal, float)
    it = 0
    for it in range(max_nodes):
        sample = goal if rng.uniform() < 0.1 else np.array([
            rng.uniform(cfg.min_x, cfg.max_x),
            rng.uniform(cfg.min_y, cfg.max_y),
            rng.uniform(-np.pi, np.pi),
        ])
        dists = [np.linalg.norm(n[:2] - sample[:2]) for n in nodes]
        ni = int(np.argmin(dists))
        direction = sample - nodes[ni]
        dist = max(np.linalg.norm(direction[:2]), 1e-9)
        step = min(dist, expand)
        new = nodes[ni] + direction * (step / dist)
        if feasible_segment(nodes[ni], new):
            nodes.append(new)
            parents.append(ni)
            if np.linalg.norm(new[:2] - goal[:2]) < expand and feasible_segment(new, goal):
                nodes.append(goal)
                parents.append(len(nodes) - 2)
                break
    else:
        return None
    # walk back
    path = []
    cur = len(nodes) - 1
    while cur >= 0:
        path.append(nodes[cur])
        cur = parents[cur]
    pose_path = np.asarray(path[::-1])
    _, _, margins = pose_certificates(torch.as_tensor(pose_path, device=dev).to(dt),
                                      obstacles_hs, valid, cfg)
    m = torch.amax(margins, dim=-1).cpu().numpy()
    length, turn = _path_metrics(pose_path)
    return {
        "backend": "rrt",
        "poses": pose_path,
        "path_length": length,
        "heading_change": turn,
        "iterations": it + 1,
        "min_separation_margin": float(m.min()),
    }
