"""Arm control: planar n-joint kinematics, resolved-rate IK, 3-D arm FK/IK,
joint-space RRT* among spheres, joint-space interpolation.

The port of rust_robotics_tpu/control/arm.py. Reference
(crates/rust_robotics_control/src/): two_joint_arm_control.rs (analytic
2-link IK), n_joint_arm_control.rs (Jacobian resolved-rate IK),
n_joint_arm_3d.rs, arm_obstacle_navigation.rs (joint-space planning around
circle obstacles), rrt_star_seven_joint_arm.rs.

Jacobians come from `torch.func.jacrev` of the FK; configurations batch
over leading dims (the 3-D IK solves a batch of targets in lock-step with
`_small`'s products and 3×3 solves). The RRT* grows a fixed-capacity node
array by one masked update per iteration with no read: nearest and near
sets are masked reductions over all nodes, each candidate edge FK-checks
its interpolated configurations against every sphere at once. Its samples
are `draws=` (the uniforms JAX's split keys give) or drawn from a
`torch.Generator`.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacrev, vmap

from rust_robotics_tpu_torch._numeric import linspace, norm2
from rust_robotics_tpu_torch.control._small import at, mm, mt, mv, rsum, solve_small
from rust_robotics_tpu_torch.core.angles import normalize_angle

_BIG = 1e18


def _norm(v):
    """‖v‖ over the last axis (differentiable)."""
    return torch.sqrt(rsum(v * v, -1))


def forward_kinematics(angles, lengths):
    """Planar chain FK: joint positions [..., N+1, 2] (n_joint_arm_control.rs)."""
    cum = torch.cumsum(angles, dim=-1)
    steps = torch.stack([lengths * torch.cos(cum), lengths * torch.sin(cum)], dim=-1)
    pts = torch.cumsum(steps, dim=-2)
    return torch.cat([torch.zeros_like(pts[..., :1, :]), pts], dim=-2)


def end_effector(angles, lengths):
    return forward_kinematics(angles, lengths)[..., -1, :]


def two_joint_ik(target, l1, l2, elbow_up=True):
    """Analytic 2-link IK (two_joint_arm_control.rs)."""
    x, y = target[..., 0], target[..., 1]
    d2 = x * x + y * y
    c2 = torch.clamp((d2 - l1 * l1 - l2 * l2) / (2 * l1 * l2), -1.0, 1.0)
    s2 = torch.sqrt(torch.clamp(1.0 - c2 * c2, min=0.0))
    s2 = s2 if elbow_up else -s2
    th2 = torch.atan2(s2, c2)
    th1 = torch.atan2(y, x) - torch.atan2(l2 * s2, l1 + l2 * c2)
    return torch.stack([normalize_angle(th1), normalize_angle(th2)], dim=-1)


def resolved_rate_ik(angles0, target, lengths, iterations: int = 200, gain: float = 0.5,
                     damping: float = 1e-3):
    """Damped-least-squares resolved-rate IK (n_joint_arm_control.rs):
    θ ← θ + Jᵀ(JJᵀ + λI)⁻¹ (gain·e), J by `jacrev` of the FK."""
    jac_fn = jacrev(lambda a: end_effector(a, lengths))
    eye = damping * torch.eye(2, dtype=angles0.dtype, device=angles0.device)
    a = angles0
    for _ in range(iterations):
        e = target - end_effector(a, lengths)
        j = jac_fn(a)  # [2, N]
        a = a + mv(mt(j), solve_small(mm(j, mt(j)) + eye, gain * e))
    return a


def arm_collides(angles, lengths, obstacles, radii, samples: int = 8):
    """Any link segment intersects any circle obstacle
    (arm_obstacle_navigation.rs collision check); over leading dims."""
    pts = forward_kinematics(angles, lengths)
    t = linspace(1.0, samples, dtype=pts.dtype, device=pts.device)
    seg = pts[..., :-1, None, :] + t[:, None] * (pts[..., 1:, :] - pts[..., :-1, :])[..., None, :]
    d = norm2(seg[..., :, :, None, :] - obstacles)  # [..., N, S, M]
    return torch.any((d <= radii).flatten(-3), dim=-1)


def _rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def forward_kinematics_3d(angles, lengths):
    """3D alternating yaw/pitch chain FK → joint positions [..., N+1, 3]
    (n_joint_arm_3d.rs:65: even joints rotate about Z, odd about Y; each
    link extends along the accumulated local X)."""
    n = angles.shape[-1]
    rot = torch.eye(3, dtype=angles.dtype, device=angles.device).expand(angles.shape[:-1] + (3, 3))
    pts = [torch.zeros_like(rot[..., 0])]
    for i in range(n):
        a = angles[..., i]
        rot = mm(rot, _rot_z(a) if i % 2 == 0 else _rot_y(a))
        pts.append(pts[-1] + rot[..., :, 0] * lengths[..., i, None])
    return torch.stack(pts, dim=-2)


def end_effector_3d(angles, lengths):
    """End-effector position (n_joint_arm_3d.rs:90)."""
    return forward_kinematics_3d(angles, lengths)[..., -1, :]


def jacobian_3d(angles, lengths):
    """3xN end-effector Jacobian (n_joint_arm_3d.rs:101 takes central
    differences; here the exact derivative of the same FK), over leading
    dims of `angles`."""
    jac = jacrev(lambda a: end_effector_3d(a, lengths))
    if angles.dim() == 1:
        return jac(angles)
    flat = angles.reshape(-1, angles.shape[-1])
    return vmap(jac)(flat).reshape(angles.shape[:-1] + (3, angles.shape[-1]))


def inverse_kinematics_3d(angles0, target, lengths, iterations: int = 100, damping: float = 0.5):
    """Damped least-squares (LM) IK (n_joint_arm_3d.rs:134):
    dq = Jᵀ (J Jᵀ + λI)⁻¹ e with λ = 0.5, over leading dims (one target
    each). Returns (angles, error norm)."""
    eye = damping * torch.eye(3, dtype=angles0.dtype, device=angles0.device)
    a = angles0
    for _ in range(iterations):
        e = target - end_effector_3d(a, lengths)
        j = jacobian_3d(a, lengths)  # [..., 3, N]
        a = a + mv(mt(j), solve_small(mm(j, mt(j)) + eye, e))
    return a, _norm(target - end_effector_3d(a, lengths))


def _segment_sphere_hit(p0, p1, centers, radii):
    """Whether the segment p0→p1 [..., 3] meets any sphere: the exact
    nearest point of the segment to each center
    (rrt_star_seven_joint_arm.rs segment_sphere_intersects)."""
    d = p1 - p0
    denom = torch.clamp(rsum(d * d), min=1e-12)
    t = torch.clamp(rsum((centers - p0[..., None, :]) * d[..., None, :]) / denom[..., None],
                    0.0, 1.0)
    near = p0[..., None, :] + t[..., None] * d[..., None, :]
    return torch.any(_norm(near - centers) <= radii, dim=-1)


def arm_collides_3d(angles, lengths, centers, radii):
    """Any link segment of the 3D arm hits any sphere obstacle
    (rrt_star_seven_joint_arm.rs:config_collision_free); over leading dims."""
    pts = forward_kinematics_3d(angles, lengths)
    return torch.any(_segment_sphere_hit(pts[..., :-1, :], pts[..., 1:, :], centers, radii), dim=-1)


def _arm_edge_free(a0, a1, lengths, centers, radii, checks: int):
    """Joint-space edge a0→a1 [..., D] collision-free: `checks`
    interpolated configurations, each FK'd and tested against every
    sphere (rrt_star_seven_joint_arm.rs:collision_free)."""
    t = linspace(1.0, checks, dtype=a0.dtype, device=a0.device)[:, None]
    configs = a0[..., None, :] + t * (a1 - a0)[..., None, :]
    return ~torch.any(arm_collides_3d(configs, lengths, centers, radii), dim=-1)


def rrt_star_arm_plan(generator, start, goal, lengths, centers, radii, joint_lo=-math.pi,
                      joint_hi=math.pi, max_nodes: int = 512, step_size: float = 0.3,
                      goal_bias: float = 0.1, rewire_radius: float = 1.0, edge_checks: int = 10,
                      path_len: int = 64, draws=None):
    """Joint-space RRT* for an N-DOF (typically 7) arm among sphere
    obstacles (rrt_star_seven_joint_arm.rs:93 `RRTStarArmPlanner::plan`).

    A fixed-capacity [max_nodes, D] node array with parents, costs and an
    active mask, grown by one masked update per iteration. Iteration i
    samples `rand[i]` (uniform in [joint_lo, joint_hi)) unless `bias[i]` <
    goal_bias, when it samples the goal: `draws = (rand [max_nodes−2, D],
    bias [max_nodes−2])`, else both drawn from `generator` (a
    `torch.Generator` on start's device, or None). A node within
    `step_size` of the goal whose final edge is free updates the
    incumbent.

    Returns dict(waypoints [path_len, D], mask, cost, found).
    """
    d = start.shape[0]
    f, dev = start.dtype, start.device
    iters = max_nodes - 2
    if draws is None:
        rand = joint_lo + (joint_hi - joint_lo) * torch.rand((iters, d), generator=generator,
                                                             dtype=f, device=dev)
        bias = torch.rand(iters, generator=generator, dtype=f, device=dev)
    else:
        rand, bias = draws
    slots = torch.arange(max_nodes, device=dev)
    nodes = torch.zeros((max_nodes, d), dtype=f, device=dev)
    nodes[0] = start
    parents = torch.full((max_nodes,), -1, dtype=torch.int64, device=dev)
    costs = torch.full((max_nodes,), _BIG, dtype=f, device=dev)
    costs[0] = 0.0
    active = slots == 0
    count = torch.ones((), dtype=torch.int64, device=dev)
    big = torch.full((), _BIG, dtype=f, device=dev)

    start_free = ~arm_collides_3d(start, lengths, centers, radii)
    goal_free = ~arm_collides_3d(goal, lengths, centers, radii)

    for i in range(iters):
        sample = torch.where(bias[i] < goal_bias, goal, rand[i])
        dist = torch.where(active, _norm(nodes - sample), big)
        ni = torch.argmin(dist)
        dn = at(dist, ni)
        ratio = torch.clamp(step_size / torch.clamp(dn, min=1e-9), max=1.0)
        near_node = at(nodes, ni)
        new = near_node + ratio * (sample - near_node)
        free = _arm_edge_free(near_node, new, lengths, centers, radii, edge_checks)

        # choose the parent among the near set, then rewire (rrt_star idiom)
        dnew = _norm(nodes - new)
        near = active & (dnew < rewire_radius)
        edge_ok = near & _arm_edge_free(nodes, new.expand(max_nodes, d), lengths, centers, radii,
                                        edge_checks)
        cand = torch.where(edge_ok, costs + dnew, big)
        base = torch.where(free, at(costs, ni) + at(dnew, ni), big)
        cand = torch.where(slots == ni, torch.minimum(cand, base), cand)
        parent = torch.argmin(cand)
        new_cost = at(cand, parent)
        ok = new_cost < _BIG / 2

        put = (slots == count) & ok
        nodes = torch.where(put[:, None], new, nodes)
        parents = torch.where(put, parent, parents)
        costs = torch.where(put, new_cost, costs)
        active = active | put
        # rewire the near nodes through the new node
        rew = edge_ok & (new_cost + dnew < costs) & ok
        parents = torch.where(rew, count, parents)
        costs = torch.where(rew, new_cost + dnew, costs)
        count = count + ok.to(count.dtype)

    # the best goal connection: any active node within step_size, edge free
    dg = _norm(nodes - goal)
    near_goal = active & (dg < step_size)
    goal_edge = near_goal & _arm_edge_free(nodes, goal.expand(max_nodes, d), lengths, centers,
                                           radii, edge_checks)
    total = torch.where(goal_edge, costs + dg, big)
    best = torch.argmin(total)
    best_cost = at(total, best)
    found = (best_cost < _BIG / 2) & start_free & goal_free

    # walk the parents from `best`, then append the goal
    idx = best
    rev, rmask = [], []
    for _ in range(path_len - 1):
        safe = torch.clamp(idx, min=0)
        rev.append(at(nodes, safe))
        rmask.append(idx >= 0)
        idx = torch.where(idx >= 0, at(parents, safe), idx)
    rev, rmask = torch.stack(rev), torch.stack(rmask)
    n_valid = torch.sum(rmask)
    order = torch.argsort((~rmask).to(torch.int8), stable=True)  # valid first
    fwd = torch.flip(rev[order], dims=(0,))
    # shift so the path starts at slot 0, the goal after the last valid
    shift = path_len - 1 - n_valid
    idxs = torch.clamp(torch.arange(path_len - 1, device=dev) + shift, 0, path_len - 2)
    waypoints = torch.cat([fwd[idxs], goal[None, :]], dim=0)
    mask = torch.cat([torch.arange(path_len - 1, device=dev) < n_valid,
                      torch.ones(1, dtype=torch.bool, device=dev)]) & found
    return dict(waypoints=waypoints, mask=mask,
                cost=torch.where(found, best_cost, torch.full_like(best_cost, math.inf)),
                found=found)


def joint_space_plan(start_angles, goal_angles, lengths, obstacles, radii, steps: int = 100):
    """Straight-line joint-space interpolation with a collision mask — the
    validity profile feeds higher-level planners. Returns (configs
    [steps, N], collision_free [steps])."""
    t = linspace(1.0, steps, dtype=start_angles.dtype, device=start_angles.device)[:, None]
    configs = start_angles[None, :] + t * normalize_angle(goal_angles - start_angles)[None, :]
    return configs, ~arm_collides(configs, lengths, obstacles, radii)
