"""BranchOut-lite multimodal driving planner.

The port of rust_robotics_tpu/planning/branchout.py. Reference:
crates/rust_robotics_planning/src/branchout_multimodal.rs — lane-aligned
scene (lane_center/nearest_lane_index :109-:117), per-mode rollouts
(smoothstep lateral blend to the mode's target lane, first-order speed law
0.35·(v_des − v), yield_speed ramp to a stop 1.25 m before the nearest
ahead obstacle :469-:619), cost = progress·w + collision·w + lane·w +
comfort·w + route·w with the exact clearance potential (1−c)² inside /
0.03/(c+0.3) outside (:519-:551), softmax mixture probabilities
exp(−(cost−min)/T) (:561), multimodal metrics (pairwise final distance &
discrete Fréchet, min-GT Fréchet, final-pose mixture NLL with σ=0.75,
speed JSD over 8 bins, expected route completion :655-:710), TTC by
quadratic root (:760), and a receding-horizon closed loop that re-plans
each step, tracks the winning mode's lane with bounded lateral rate, and
accumulates clearance/TTC/comfort metrics (:335-:460).

All four modes roll out at once as [4, T+1, 3]. The discrete Fréchet
distance is computed by anti-diagonals (N+M−1 vector steps, each cell the
max of its distance and the min of its three predecessors): min and max
are exact, so the value is bitwise JAX's row scan on the same distance
matrix, and many pairs run as lanes of one call (`evaluate_multimodal`'s
6 + 4G). The closed loop keeps the ego and the obstacles on the device and
reads once a step: the mode, the stepped ego and the step's clearance and
TTC minima over all obstacles together (JAX reads once per obstacle).
Distances go through `_numeric.norm2` (JAX's jitted `jnp.linalg.norm`);
divisions by a number through `_numeric.true_div`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on
from rust_robotics_tpu_torch._numeric import norm2, true_div
from rust_robotics_tpu_torch.control._small import rsum
from rust_robotics_tpu_torch.nlls.solver import scatter_add_

__all__ = [
    "BranchOutScene",
    "BranchOutConfig",
    "MODES",
    "branchout_plan",
    "evaluate_multimodal",
    "simulate_closed_loop",
    "discrete_frechet",
    "time_to_collision",
]

EPS = 1e-9
MODES = ("keep-lane", "yield", "lane-change-left", "lane-change-right")


@dataclasses.dataclass(frozen=True)
class BranchOutScene:
    """BranchOutDrivingScene2D; obstacles [K, 3] = (x, y, radius)."""

    start: tuple = (0.0, 0.0, 2.2)  # x, y, speed
    lane_width: float = 1.2
    lane_count_each_side: int = 1
    route_length: float = 9.0
    desired_speed: float = 2.2
    obstacles: tuple = ((4.1, 0.0, 0.42),)

    @staticmethod
    def simple_overtake():
        return BranchOutScene()

    @staticmethod
    def wide_overtake():
        return BranchOutScene(lane_width=1.6)

    @staticmethod
    def forced_yield():
        return BranchOutScene(lane_count_each_side=0)


@dataclasses.dataclass(frozen=True)
class BranchOutConfig:
    horizon_steps: int = 28
    dt: float = 0.12
    ego_radius: float = 0.32
    probability_temperature: float = 4.0
    progress_weight: float = 1.4
    collision_weight: float = 80.0
    lane_weight: float = 12.0
    comfort_weight: float = 0.35
    route_weight: float = 0.12


def _smoothstep(t):
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _nearest_lane(y, lane_width, n_side):
    return torch.clamp(torch.round(true_div(y, lane_width)), -n_side, n_side)


def _mode_target_lanes(start_lane, n_side):
    """[4] target lane per mode: keep, yield, left (+1), right (−1)."""
    return torch.stack([start_lane, start_lane, torch.clamp(start_lane + 1, max=n_side),
                        torch.clamp(start_lane - 1, min=-n_side)])


def _yield_speed(obstacles, start_x, desired_speed, ego_x):
    """yield_speed (branchout_multimodal.rs:608): ramp to stop 1.25 before
    the nearest obstacle ahead of the scene start; ego_x [...]."""
    ahead = obstacles[:, 0] >= start_x
    ox = torch.amin(torch.where(ahead, obstacles[:, 0], torch.inf))
    stop_x = ox - 1.25
    dist = torch.clamp(stop_x - ego_x, min=0.0)
    v = torch.clamp(dist, max=0.75 * desired_speed)
    v = torch.where(ego_x >= stop_x, 0.0, v)
    return torch.where(torch.isfinite(ox), v, desired_speed)


def _rollout_all_modes(start, obstacles, lane_width, n_side, route_length, desired_speed,
                       cfg: BranchOutConfig):
    """[4, T+1, 3] rollouts + per-mode cost terms; start [3] and obstacles
    [K, 3] tensors of one dtype and device."""
    dev, dt = start.device, start.dtype
    start_lane = _nearest_lane(start[1], lane_width, n_side)
    targets = _mode_target_lanes(start_lane, n_side) * lane_width  # [4]
    is_yield = torch.arange(4, device=dev) == 1
    t_steps = cfg.horizon_steps
    steps = torch.arange(1, t_steps + 1, dtype=dt, device=dev)
    pose = start.expand(4, 3)
    traj = [pose]
    for k in range(t_steps):
        smooth = _smoothstep(true_div(steps[k], t_steps))
        vy = _yield_speed(obstacles, start[0], desired_speed, pose[:, 0])
        v_des = torch.where(is_yield, vy, desired_speed)
        speed = pose[:, 2] + 0.35 * (v_des - pose[:, 2])
        x = pose[:, 0] + speed * cfg.dt
        y = start[1] + (targets - start[1]) * smooth
        pose = torch.stack([x, y, speed], dim=-1)
        traj.append(pose)
    poses = torch.stack(traj, dim=1)  # [4, T+1, 3]

    # cost terms (branchout_multimodal.rs:519)
    road_half = (n_side + 0.5) * lane_width
    d = norm2(poses[:, :, None, :2] - obstacles[None, None, :, :2])
    clearance = d - obstacles[None, None, :, 2] - cfg.ego_radius
    pot = torch.where(clearance < 0.0, (1.0 - clearance) ** 2, 0.03 / (clearance + 0.3))
    collision_risk = torch.sum(pot, dim=(1, 2))  # [4]
    ay_abs = torch.abs(poses[:, :, 1])
    lane_pen = torch.sum(torch.where(ay_abs > road_half, (ay_abs - road_half) ** 2, 0.0), dim=1)
    ay = torch.diff(poses[:, :, 1], dim=1)
    jerk = true_div(torch.diff(ay, dim=1) ** 2, cfg.dt * cfg.dt)
    dv = torch.diff(poses[:, :, 2], dim=1)[:, 1:] ** 2
    comfort = torch.sum(jerk + dv, dim=1)

    final = poses[:, -1]
    progress_err = torch.clamp(route_length - final[:, 0], min=0.0)
    completion = torch.clamp(true_div(final[:, 0], route_length), 0.0, 1.0)
    route_dev = torch.abs(final[:, 1] - start_lane * lane_width)
    cost = (cfg.progress_weight * progress_err
            + cfg.collision_weight * collision_risk
            + cfg.lane_weight * lane_pen
            + cfg.comfort_weight * comfort
            + cfg.route_weight * route_dev)
    prob = torch.exp(true_div(-(cost - torch.amin(cost)), cfg.probability_temperature))
    prob = prob / torch.sum(prob)
    return {
        "poses": poses,
        "cost": cost,
        "probability": prob,
        "collision_risk": collision_risk,
        "comfort_cost": comfort,
        "route_completion": completion,
    }


def branchout_plan(scene: BranchOutScene, cfg: BranchOutConfig = BranchOutConfig(),
                   dtype=torch.float32, device=None):
    """One trajectory per decision mode with mixture probabilities, on
    `device` (default cuda) in `dtype`. Returns the dict of
    `_rollout_all_modes` plus mode labels."""
    start = _float_on(scene.start, device, dtype)
    out = _rollout_all_modes(start, _float_on(scene.obstacles, start.device, dtype),
                             scene.lane_width, scene.lane_count_each_side, scene.route_length,
                             scene.desired_speed, cfg)
    out["modes"] = MODES
    return out


def _frechet_of(d):
    """Discrete Fréchet value of distance matrices d [..., N, M] by
    anti-diagonals: D_k[i] is cell (i, k − i)."""
    n, m = d.shape[-2:]
    dev = d.device
    i = torch.arange(n, device=dev)
    k = torch.arange(n + m - 1, device=dev)[:, None]
    j = k - i  # [K, N]
    ok = (j >= 0) & (j < m)
    idx = torch.clamp(j, 0, m - 1).T  # [N, K]
    diag = torch.gather(d, -1, idx.expand(d.shape[:-2] + idx.shape))  # [..., N, K]
    diag = torch.where(ok.T, diag, torch.inf).movedim(-1, 0)  # [K, ..., N]
    inf = torch.full_like(diag[0][..., :1], torch.inf)
    prev2 = torch.full_like(diag[0], torch.inf)
    prev1 = torch.where(i == 0, diag[0], torch.inf)
    for kk in range(1, n + m - 1):
        up = torch.cat([inf, prev1[..., :-1]], -1)
        corner = torch.cat([inf, prev2[..., :-1]], -1)
        cur = torch.maximum(torch.minimum(torch.minimum(up, corner), prev1), diag[kk])
        prev2, prev1 = prev1, torch.where(ok[kk], cur, torch.inf)
    return prev1[..., n - 1]


def _as_tensors(values, device=None):
    """Tensors of `values` on the first tensor's device in its dtype (host
    data alone: `device`, default cuda, float64)."""
    ref = next((v for v in values if isinstance(v, torch.Tensor)), None)
    dtype = torch.float64 if ref is None else ref.dtype
    return [_float_on(v, device if ref is None else ref.device, dtype) for v in values]


def discrete_frechet(a, b, device=None):
    """Discrete Fréchet distance between [..., N, 2] and [..., M, 2] (the
    reference's DP :735), over leading batch dims."""
    a, b = _as_tensors((a, b), device)
    return _frechet_of(norm2(a[..., :, None, :] - b[..., None, :, :]))


def time_to_collision(ego, ego_v, obs, obs_v, radius_sum, device=None):
    """Quadratic-root TTC (branchout_multimodal.rs:760) over leading batch
    dims of [..., 2] positions and velocities; inf when separating, 0 when
    already overlapping."""
    ego, ego_v, obs, obs_v = _as_tensors((ego, ego_v, obs, obs_v), device)
    p = obs - ego
    v = obs_v - ego_v
    d2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
    r2 = radius_sum * radius_sum
    a = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    b = 2.0 * (p[..., 0] * v[..., 0] + p[..., 1] * v[..., 1])
    c = d2 - r2
    disc = b * b - 4 * a * c
    root = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * torch.clamp(a, min=EPS))
    ttc = torch.where((disc >= 0) & (root >= 0) & (a > EPS), root, torch.inf)
    return torch.where(d2 <= r2, 0.0, ttc)


def evaluate_multimodal(plan, ground_truths, sigma: float = 0.75, bins: int = 8,
                        max_speed: float = 4.0):
    """BranchOutMultimodalMetrics2D (branchout_multimodal.rs:282):
    distributional metrics against [G, T+1, 3] ground-truth trajectories
    (host data goes to the plan's device in its dtype)."""
    poses = plan["poses"]  # [4, T+1, 3]
    prob = plan["probability"]
    gts = _float_on(ground_truths, poses.device, poses.dtype)
    m, g = poses.shape[0], gts.shape[0]

    finals = poses[:, -1, :2]
    pi, pj = torch.triu_indices(m, m, 1, device=poses.device)
    pair_final = norm2(finals[pi] - finals[pj])
    # the 6 mode pairs and the 4G (mode, truth) pairs as lanes
    mode_xy, gt_xy = poses[:, :, :2], gts[:, :, :2]
    a_pairs, b_pairs = mode_xy[pi], mode_xy[pj]
    a_gt = mode_xy[None].expand(g, *mode_xy.shape).reshape(g * m, *mode_xy.shape[1:])
    b_gt = gt_xy[:, None].expand(g, m, *gt_xy.shape[1:]).reshape(g * m, *gt_xy.shape[1:])
    if gts.shape[1] == poses.shape[1]:
        frech = discrete_frechet(torch.cat([a_pairs, a_gt]), torch.cat([b_pairs, b_gt]))
        pair_frech, gt_all = frech[:len(pi)], frech[len(pi):]
    else:
        pair_frech, gt_all = discrete_frechet(a_pairs, b_pairs), discrete_frechet(a_gt, b_gt)
    gt_frech = torch.amin(gt_all.reshape(g, m), dim=1)
    var = sigma * sigma
    norm = 2.0 * math.pi * var
    gt_finals = gts[:, -1, :2]
    diff = finals[None] - gt_finals[:, None]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2  # [G, 4]
    lik = torch.clamp(rsum(true_div(prob[None] * torch.exp(true_div(-0.5 * d2, var)), norm), -1),
                      min=EPS)
    nll = -torch.mean(torch.log(lik))

    def speed_hist(speeds, weights):
        b = torch.clamp(torch.floor(true_div(torch.clamp(speeds, 0, max_speed), max_speed) * bins),
                        0, bins - 1).to(torch.int64)
        h = scatter_add_(torch.zeros(bins, dtype=weights.dtype, device=weights.device), (b,),
                         weights)
        return h / torch.clamp(torch.sum(h), min=EPS)

    pred = speed_hist(poses[:, :, 2].reshape(-1), torch.repeat_interleave(prob, poses.shape[1]))
    truth = speed_hist(gts[:, :, 2].reshape(-1), torch.ones_like(gts[:, :, 2].reshape(-1)))
    mix = 0.5 * (pred + truth)

    def kl(p, q):
        ok = p > EPS
        return torch.sum(torch.where(
            ok, p * torch.log(torch.clamp(p, min=EPS) / torch.clamp(q, min=EPS)), 0.0))

    jsd = 0.5 * kl(pred, mix) + 0.5 * kl(truth, mix)
    stats = torch.stack([torch.mean(pair_final), torch.mean(pair_frech), torch.mean(gt_frech),
                         nll, jsd, torch.sum(prob * plan["route_completion"])]).tolist()
    return {
        "mode_count": m,
        "mean_pairwise_final_distance": stats[0],
        "mean_pairwise_frechet": stats[1],
        "min_ground_truth_frechet": stats[2],
        "negative_log_likelihood": stats[3],
        "speed_jsd": stats[4],
        "expected_route_completion": stats[5],
    }


def simulate_closed_loop(scene: BranchOutScene, obstacle_velocities,
                         cfg: BranchOutConfig = BranchOutConfig(), steps: int = 40,
                         ttc_threshold: float = 1.5, goal_completion: float = 0.95,
                         max_lateral_speed: float = 0.9, dtype=torch.float32, device=None):
    """Receding-horizon closed loop (branchout_multimodal.rs:335): re-plan
    each step, track the winning mode's lane at bounded lateral rate,
    advance obstacles, accumulate clearance/TTC/comfort metrics. The ego
    and the obstacles stay on `device` (default cuda) in `dtype`; each
    step reads its mode, ego, clearance and TTC minima once."""
    ego = _float_on(scene.start, device, dtype)
    dev = ego.device
    obstacles = _float_on(scene.obstacles, dev, dtype)
    vels = _float_on(obstacle_velocities, dev, dtype).reshape(-1, 2)
    dt = cfg.dt
    n_side = scene.lane_count_each_side
    lw = scene.lane_width
    rs = obstacles[:, 2] + cfg.ego_radius
    executed = [np.asarray(scene.start, float)]
    mode_seq = []
    collision_steps = 0
    min_clear = np.inf
    min_ttc = np.inf
    risky = 0
    comfort = []

    for _ in range(steps):
        plan = _rollout_all_modes(ego, obstacles, lw, n_side, scene.route_length,
                                  scene.desired_speed, cfg)
        mode = torch.argmax(plan["probability"])
        tlanes = _mode_target_lanes(_nearest_lane(ego[1], lw, n_side), n_side)
        target_y = tlanes.index_select(0, mode.reshape(1))[0] * lw
        v_des = torch.where(mode == 1, _yield_speed(obstacles, ego[0], scene.desired_speed,
                                                    ego[0]), scene.desired_speed)
        speed = ego[2] + 0.35 * (v_des - ego[2])
        x = ego[0] + speed * dt
        y = ego[1] + torch.clamp(target_y - ego[1], -max_lateral_speed * dt,
                                 max_lateral_speed * dt)
        nxt = torch.stack([x, y, speed])
        ego_v = true_div(nxt[:2] - ego[:2], dt)
        obstacles = torch.cat([obstacles[:, :2] + vels * dt, obstacles[:, 2:]], dim=1)
        clear = torch.hypot(nxt[0] - obstacles[:, 0], nxt[1] - obstacles[:, 1]) - rs
        ttc = time_to_collision(nxt[:2], ego_v, obstacles[:, :2], vels, rs)
        read = torch.cat([mode.to(dtype)[None], nxt, torch.amin(clear)[None],
                          torch.amin(ttc)[None]]).tolist()
        mode_i, host_nxt, step_clear, step_ttc = int(read[0]), np.array(read[1:4]), read[4], read[5]
        mode_seq.append(MODES[mode_i])
        min_clear = min(min_clear, step_clear)
        if step_clear < 0:
            collision_steps += 1
        min_ttc = min(min_ttc, step_ttc)
        if step_ttc < ttc_threshold:
            risky += 1
        if len(executed) >= 2:
            ay0 = executed[-1][1] - executed[-2][1]
            ay1 = host_nxt[1] - executed[-1][1]
            comfort.append((ay1 - ay0) ** 2 / (dt * dt) + (host_nxt[2] - executed[-1][2]) ** 2)
        ego = nxt
        executed.append(host_nxt)

    completion = float(np.clip(executed[-1][0] / scene.route_length, 0.0, 1.0))
    return {
        "steps": steps,
        "route_completion": completion,
        "reached_goal": completion >= goal_completion,
        "collision_steps": collision_steps,
        "no_collision_rate": 1.0 - collision_steps / steps,
        "min_clearance": min_clear,
        "mean_comfort_cost": float(np.mean(comfort)) if comfort else 0.0,
        "min_time_to_collision": min_ttc,
        "risky_ttc_steps": risky,
        "executed_path": np.stack(executed),
        "mode_sequence": mode_seq,
    }
