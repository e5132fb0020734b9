"""Kinematic-edge RRT variants: Dubins and Reeds-Shepp RRT(*), closed-loop
RRT*, LQR-RRT*.

The port of rust_robotics_tpu/planning/rrt_kinematic.py. Reference:
crates/rust_robotics_planning/src/ — rrt_dubins.rs / rrt_star_dubins.rs
(a tree of SE(2) poses whose edges are shortest Dubins connections),
rrt_star_reeds_shepp.rs (Reeds-Shepp edges: both gears),
closed_loop_rrt_star.rs (the plan validated by simulating a pursuit and
speed tracking loop and collision-checking the tracked trajectory),
lqr_rrt_star.rs (the LQR cost-to-go as the metric and the LQR rollout as
the steer function on a double integrator).

The trees are `planning/rrt.py`'s fixed-capacity masked trees with poses
(or states) as nodes; choose-parent and rewire evaluate the closed-form
Dubins / Reeds-Shepp words against every slot at once, over leading batch
dims (a forest; a lane equals its solo run). No read in a grow loop; the
samples are `draws=` (the uniforms JAX's split keys give) or drawn from a
`torch.Generator`. JAX's planners are jitted, so XLA contracts the
sample's a·b + c into one rounding; the port does the same (`mul_add`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._numeric import filled, norm2, true_div
from rust_robotics_tpu_torch.control._small import (
    as_float,
    dot,
    mm,
    mt,
    mv,
    rsum,
    solve_small,
    take,
    take_rows,
)
from rust_robotics_tpu_torch.control.trackers import (
    PurePursuitConfig,
    pure_pursuit_control,
    solve_dare,
)
from rust_robotics_tpu_torch.planning.curves import dubins_path_lengths, dubins_shortest_path
from rust_robotics_tpu_torch.planning.reeds_shepp import reeds_shepp_path, sample_reeds_shepp
from rust_robotics_tpu_torch.planning.rrt import (
    _inputs,
    area,
    init_tree,
    insert,
    mul_add,
    rewire,
    walk_parents,
)

BIG = 1e18

__all__ = [
    "KinematicRRTConfig",
    "PoseTree",
    "rrt_dubins_plan",
    "rrt_star_dubins_plan",
    "rrt_star_reeds_shepp_plan",
    "extract_pose_path",
    "closed_loop_rrt_star_plan",
    "LQRRRTConfig",
    "lqr_rrt_star_plan",
]


@dataclasses.dataclass(frozen=True)
class KinematicRRTConfig:
    """rrt_dubins.rs / rrt_star_dubins.rs / rrt_star_reeds_shepp.rs surface."""

    curvature: float = 1.0
    goal_sample_rate: float = 0.1
    max_nodes: int = 128
    connect_radius: float = 4.0  # choose-parent/rewire ball (workspace dist)
    edge_samples: int = 24
    area_min: tuple = (-2.0, -2.0)
    area_max: tuple = (12.0, 12.0)
    goal_xy_threshold: float = 0.7
    goal_yaw_threshold: float = 0.6


@dataclasses.dataclass(frozen=True)
class PoseTree:
    poses: torch.Tensor  # [..., N, 3] (x, y, yaw)
    parents: torch.Tensor  # [..., N] int64
    costs: torch.Tensor  # [..., N] cost-to-come along kinematic edges
    active: torch.Tensor  # [..., N] bool
    count: torch.Tensor  # [...] int64


def _pose_tree(tree):
    return PoseTree(tree.nodes, tree.parents, tree.costs, tree.active, tree.count)


def _dubins_cost(a, b, curvature):
    """The shortest Dubins length a → b [..., 3]."""
    return true_div(torch.amin(rsum(dubins_path_lengths(a, b, curvature), -1), -1), curvature)


def _obstacle_free(pts, obstacles, radii):
    """Whether every point [..., S, ≥2] clears every circle: [...]."""
    d = norm2(pts[..., :, None, :2] - obstacles)
    return torch.all((d > radii).flatten(-2), dim=-1)


def _dubins_edge_free(a, b, curvature, obstacles, radii, samples):
    pts, total, _ = dubins_shortest_path(a, b, curvature, num_points=samples)
    return _obstacle_free(pts, obstacles, radii) & torch.isfinite(total)


def _rs_cost(a, b, curvature):
    return reeds_shepp_path(a, b, curvature)[2]


def _rs_edge_free(a, b, curvature, obstacles, radii, samples):
    segs, steers, total = reeds_shepp_path(a, b, curvature)
    pts = sample_reeds_shepp(a, segs, steers, curvature, num_points=samples)
    return _obstacle_free(pts, obstacles, radii) & torch.isfinite(total)


def _kinematic_rrt(generator, start, goal, obstacles, radii, cfg, cost_fn, edge_free_fn, star,
                   draws, dtype, device):
    """The shared grow loop: nodes are SE(2) poses, edges are kinematic
    connections from the parent pose to the sampled pose (the reference
    grows by a full Dubins/RS connection to the sample, not a fixed step).
    Iteration i samples the goal where draws[..., i, 0] < goal_sample_rate,
    else (lo + draws[..., i, 1:3]·(hi − lo), (2·draws[..., i, 3] − 1)·π):
    draws [..., max_nodes − 1, 4]."""
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    n = cfg.max_nodes
    f, dev = start.dtype, start.device
    lo, hi = area(cfg, f, dev)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = torch.rand(batch + (n - 1, 4), generator=generator, dtype=f, device=dev)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-2])
    start, goal = start.expand(batch + (3,)), goal.expand(batch + (3,))
    cost = lambda a, b: cost_fn(a, b, cfg.curvature)  # noqa: E731
    free = lambda a, b: edge_free_fn(a, b, cfg.curvature, obstacles, radii,  # noqa: E731
                                     cfg.edge_samples)
    tree = init_tree(start, n)
    for i in range(n - 1):
        u = draws[..., i, :]
        drawn = torch.cat([mul_add(u[..., 1:3], hi - lo, lo), ((u[..., 3:] * 2.0 - 1.0) * math.pi)],
                          -1)
        sample = torch.where(u[..., :1] < cfg.goal_sample_rate, goal, drawn)
        tiled = sample[..., None, :].expand(tree.nodes.shape)
        if star:
            # the cheapest feasible parent within the workspace ball
            dxy = norm2(tree.nodes[..., :2] - sample[..., None, :2])
            near = tree.active & (dxy <= cfg.connect_radius)
            cand = torch.where(near & free(tree.nodes, tiled), tree.costs + cost(tree.nodes, tiled),
                               BIG)
            parent = torch.argmin(cand, dim=-1)
            new_cost = take(cand, parent)
            ok = new_cost < BIG / 2
        else:
            # the nearest by kinematic cost, connected if collision-free
            edge = torch.where(tree.active, cost(tree.nodes, tiled), BIG)
            parent = torch.argmin(edge, dim=-1)
            ok = free(take_rows(tree.nodes, parent), sample)
            new_cost = take(tree.costs, parent) + take(edge, parent)
            ok = ok & (new_cost < BIG / 2)
        idx = tree.count
        tree = insert(tree, ok, sample, parent, new_cost)
        if star:
            # rewire: route near nodes through the new node where cheaper
            dxy = norm2(tree.nodes[..., :2] - sample[..., None, :2])
            near = tree.active & (dxy <= cfg.connect_radius)
            through = new_cost[..., None] + cost(tiled, tree.nodes)
            better = ok[..., None] & near & free(tiled, tree.nodes) & (through < tree.costs)
            tree = rewire(tree, better, idx, through)
    # the goal anchor: the cheapest node with a feasible kinematic edge to the goal
    tiled_goal = goal[..., None, :].expand(tree.nodes.shape)
    dxy = norm2(tree.nodes[..., :2] - goal[..., None, :2])
    reachable = tree.active & free(tree.nodes, tiled_goal) & (dxy <= cfg.connect_radius)
    total = torch.where(reachable, tree.costs + cost(tree.nodes, tiled_goal), BIG)
    best = torch.argmin(total, dim=-1)
    return _pose_tree(tree), best, take(total, best)


def rrt_dubins_plan(generator, start, goal, obstacles, radii,
                    cfg: KinematicRRTConfig = KinematicRRTConfig(), draws=None, dtype=None,
                    device=None):
    """RRT with Dubins edges (rrt_dubins.rs). Returns (PoseTree, best,
    cost), the cost including the final node → goal Dubins connection."""
    return _kinematic_rrt(generator, start, goal, obstacles, radii, cfg, _dubins_cost,
                          _dubins_edge_free, False, draws, dtype, device)


def rrt_star_dubins_plan(generator, start, goal, obstacles, radii,
                         cfg: KinematicRRTConfig = KinematicRRTConfig(), draws=None, dtype=None,
                         device=None):
    """RRT* with Dubins edges (rrt_star_dubins.rs): choose-parent and
    rewire over shortest-Dubins connections."""
    return _kinematic_rrt(generator, start, goal, obstacles, radii, cfg, _dubins_cost,
                          _dubins_edge_free, True, draws, dtype, device)


def rrt_star_reeds_shepp_plan(generator, start, goal, obstacles, radii,
                              cfg: KinematicRRTConfig = KinematicRRTConfig(), draws=None,
                              dtype=None, device=None):
    """RRT* with Reeds-Shepp edges (rrt_star_reeds_shepp.rs): both gears,
    endpoint-verified words."""
    return _kinematic_rrt(generator, start, goal, obstacles, radii, cfg, _rs_cost, _rs_edge_free,
                          True, draws, dtype, device)


def extract_pose_path(tree: PoseTree, node, goal, curvature=1.0, max_nodes: int = 32,
                      samples_per_edge: int = 24, reeds_shepp: bool = False):
    """The densely sampled SE(2) path start → … → node → goal: walks the
    parent links, then samples each kinematic edge. Returns (poses [...,
    L·S, 3], mask [..., L·S])."""
    f, dev = tree.poses.dtype, tree.poses.device
    node = torch.as_tensor(node, device=dev).to(torch.int64)
    goal = torch.as_tensor(goal, device=dev).to(f)
    idxs = walk_parents(tree.parents, node, max_nodes)
    valid = idxs >= 0
    ar = torch.arange(max_nodes, device=dev)
    order = torch.argsort(torch.where(valid, -ar, max_nodes), dim=-1, stable=True)  # root first
    idxs = torch.gather(torch.where(valid, idxs, 0), -1, order)
    valid = torch.gather(valid, -1, order)
    batch = idxs.shape[:-1]
    poses = torch.gather(tree.poses.expand(batch + tree.poses.shape[-2:]), -2,
                         idxs[..., None].expand(batch + (max_nodes, 3)))
    nvalid = torch.sum(valid, -1)
    goal = goal.expand(batch + (3,))
    waypoints = torch.cat([poses, goal[..., None, :]], -2)
    wvalid = torch.cat([valid, torch.ones_like(valid[..., :1])], -1)

    def sample_edge(a, b):
        if reeds_shepp:
            segs, steers, _ = reeds_shepp_path(a, b, curvature)
            return sample_reeds_shepp(a, segs, steers, curvature, num_points=samples_per_edge)
        return dubins_shortest_path(a, b, curvature, num_points=samples_per_edge)[0]

    segs = sample_edge(waypoints[..., :-1, :], waypoints[..., 1:, :])  # [..., L, S, 3]
    # edge k is real iff waypoints k and k+1 are; the last valid node
    # connects to the goal, re-sampled in its slot
    edge_valid = wvalid[..., :-1] & (wvalid[..., 1:] | (ar + 1 == nvalid[..., None]))
    last = torch.clamp(nvalid - 1, 0, max_nodes - 1)
    goal_seg = sample_edge(take_rows(waypoints, last), goal)  # [..., S, 3]
    at_last = ar == last[..., None]
    segs = torch.where(at_last[..., None, None], goal_seg[..., None, :, :], segs)
    edge_valid = edge_valid | at_last
    mask = torch.repeat_interleave(edge_valid, samples_per_edge, dim=-1)
    return segs.reshape(batch + (max_nodes * samples_per_edge, 3)), mask


# ---------------------------------------------------------------------------
# closed-loop RRT* (closed_loop_rrt_star.rs)


def closed_loop_rrt_star_plan(generator, start, goal, obstacles, radii,
                              cfg: KinematicRRTConfig = KinematicRRTConfig(),
                              target_speed: float = 1.0, wheelbase: float = 0.5, dt: float = 0.1,
                              sim_steps: int = 400, draws=None, dtype=None, device=None):
    """Closed-loop RRT* (closed_loop_rrt_star.rs): plan with the Dubins
    RRT*, then track the sampled path with pure pursuit and a speed loop
    (`control/trackers.py`) and collision-check the simulated trajectory.
    Returns (traj [..., T, 4] of (x, y, yaw, v), tree, plan cost, a report
    of the tracked feasibility and goal flags)."""
    tree, best, cost = rrt_star_dubins_plan(generator, start, goal, obstacles, radii, cfg, draws,
                                            dtype, device)
    f, dev = tree.poses.dtype, tree.poses.device
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, f, dev)
    poses, mask = extract_pose_path(tree, best, goal, cfg.curvature,
                                    samples_per_edge=cfg.edge_samples)
    points = poses[..., :2]
    pp = PurePursuitConfig(wheelbase=wheelbase, look_ahead_distance=1.0, look_ahead_gain=0.1)
    speed = torch.full((), target_speed, dtype=f, device=dev)
    state = torch.cat([start.expand(best.shape + (3,)), torch.zeros_like(cost)[..., None]], -1)
    traj = []
    for _ in range(sim_steps):
        accel, steer, _ = pure_pursuit_control(state, points, mask.to(f), speed, pp)
        x, y, yaw, v = state.unbind(-1)
        # XLA fuses each update's last multiply into the add (a scan body)
        nx = mul_add(v * torch.cos(yaw), torch.full_like(v, dt), x)
        ny = mul_add(v * torch.sin(yaw), torch.full_like(v, dt), y)
        nyaw = mul_add(true_div(v, wheelbase) * torch.tan(steer), torch.full_like(v, dt), yaw)
        nv = torch.clamp(mul_add(accel, torch.full_like(v, dt), v), 0.0, 2.0 * target_speed)
        state = torch.stack([nx, ny, nyaw, nv], -1)
        traj.append(state)
    traj = torch.stack(traj, -2)
    collision_free = _obstacle_free(traj, obstacles, radii)
    dist_goal = norm2(traj[..., :2] - goal[..., None, :2])
    min_goal = torch.amin(dist_goal, -1)
    report = {"tracked_collision_free": collision_free,
              "tracked_goal_reached": min_goal <= cfg.goal_xy_threshold * 2.0,
              "min_goal_distance": min_goal}
    return traj, tree, cost, report


# ---------------------------------------------------------------------------
# LQR-RRT* (lqr_rrt_star.rs)


@dataclasses.dataclass(frozen=True)
class LQRRRTConfig:
    """lqr_rrt_star.rs surface: double-integrator plant, LQR metric."""

    max_nodes: int = 160
    goal_sample_rate: float = 0.15
    steer_steps: int = 12
    dt: float = 0.15
    connect_cost: float = 25.0  # near-set threshold on LQR cost
    area_min: tuple = (-2.0, -2.0)
    area_max: tuple = (12.0, 12.0)
    goal_threshold: float = 0.8
    q_diag: tuple = (1.0, 1.0, 0.3, 0.3)
    r_diag: tuple = (0.1, 0.1)
    edge_checks: int = 8


def _lqr_gain(cfg: LQRRRTConfig, dtype, device):
    """(A, B, K, P, Q, R) of the double integrator [x, y, vx, vy] at
    cfg.dt: P from `solve_dare`, K = (R + BᵀPB)⁻¹ BᵀPA."""
    a = torch.eye(4, dtype=dtype, device=device)
    a[0, 2] = cfg.dt
    a[1, 3] = cfg.dt
    b = torch.zeros((4, 2), dtype=dtype, device=device)
    b[2, 0] = cfg.dt
    b[3, 1] = cfg.dt
    q = torch.diag(filled(cfg.q_diag, dtype, device))
    r = torch.diag(filled(cfg.r_diag, dtype, device))
    p = solve_dare(a, b, q, r)
    btp = mm(mt(b), p)
    return a, b, solve_small(r + mm(btp, b), mm(btp, a)), p, q, r


def _quad(e, m):
    """e m e over the last axis (JAX's (e @ m) @ e)."""
    return dot(mv(mt(m), e), e)


def lqr_rrt_star_plan(generator, start, goal, obstacles, radii,
                      cfg: LQRRRTConfig = LQRRRTConfig(), draws=None, dtype=None, device=None):
    """LQR-RRT* (lqr_rrt_star.rs) on a planar double integrator [x, y,
    vx, vy]: the LQR value xᵀPx is the distance (nearest and near set),
    and steering rolls the LQR-controlled plant toward the sample for
    steer_steps. Iteration i samples the goal where draws[..., i, 0] <
    goal_sample_rate, else (lo + draws[..., i, 1:]·(hi − lo), 0, 0): draws
    [..., max_nodes − 1, 3]. Returns (tree dict, best, cost), the cost the
    accumulated LQR stage cost."""
    start = as_float(start, dtype, device)
    f, dev = start.dtype, start.device
    goal, obstacles, radii = (as_float(v, f, dev) for v in (goal, obstacles, radii))
    a, b, k, p, q, r = _lqr_gain(cfg, f, dev)
    n = cfg.max_nodes
    lo, hi = area(cfg, f, dev)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = torch.rand(batch + (n - 1, 3), generator=generator, dtype=f, device=dev)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-2])
    start, goal = start.expand(batch + (4,)), goal.expand(batch + (4,))

    def steer(x0, x1):
        """x' = Ax + B(−K(x − x1)) for steer_steps: (final state, summed
        stage cost, trajectory [..., steps, 4])."""
        x, cs, traj = x0, [], []
        for _ in range(cfg.steer_steps):
            e = x - x1
            u = -mv(k, e)
            x = mv(a, x) + mv(b, u)
            cs.append(_quad(e, q) + _quad(u, r))
            traj.append(x)
        return x, rsum(torch.stack(cs, -1), -1), torch.stack(traj, -2)

    def traj_free(traj):
        return _obstacle_free(traj, obstacles, radii)

    zeros2 = torch.zeros(batch + (2,), dtype=f, device=dev)
    tree = init_tree(start, n)
    for i in range(n - 1):
        u = draws[..., i, :]
        drawn = torch.cat([mul_add(u[..., 1:], hi - lo, lo), zeros2], -1)
        sample = torch.where(u[..., :1] < cfg.goal_sample_rate, goal, drawn)
        dist = torch.where(tree.active, _quad(sample[..., None, :] - tree.nodes, p), BIG)
        nearest = torch.argmin(dist, dim=-1)
        new_state, edge_cost, traj = steer(take_rows(tree.nodes, nearest), sample)
        ok = traj_free(traj)
        # the parent among the LQR-near set
        target = new_state[..., None, :].expand(tree.nodes.shape)
        ends, costs_all, trajs = steer(tree.nodes, target)
        close = norm2(ends[..., :2] - new_state[..., None, :2]) < 0.5
        near = (tree.active & (_quad(target - tree.nodes, p) <= cfg.connect_cost) & close
                & traj_free(trajs))
        cand = torch.where(near, tree.costs + costs_all, BIG)
        via = torch.where(ok, take(tree.costs, nearest) + edge_cost, BIG)
        at_nearest = torch.arange(n, device=dev) == nearest[..., None]
        cand = torch.where(at_nearest, torch.minimum(cand, via[..., None]), cand)
        parent = torch.argmin(cand, dim=-1)
        new_cost = take(cand, parent)
        ok = new_cost < BIG / 2
        tree = insert(tree, ok, new_state, parent, new_cost)
    dg = norm2(tree.nodes[..., :2] - goal[..., None, :2])
    total = torch.where(tree.active & (dg <= cfg.goal_threshold), tree.costs, BIG)
    best = torch.argmin(total, dim=-1)
    return (dict(nodes=tree.nodes, parents=tree.parents, costs=tree.costs, active=tree.active,
                 count=tree.count), best, take(total, best))
