"""Signal-temporal-logic multi-agent planning: robustness metrics, STL-CBS,
kinodynamic STL-CBS, hierarchical MAPF, STL-shielded constrained decoding.

The port of rust_robotics_tpu/planning/stl.py. Reference:
crates/rust_robotics_planning/src/ —
stl_cbs.rs (CBS over the integer grid with vertex/edge conflicts;
`StlRectangle2D::inside_robustness` = min margin to the four faces;
`stl_eventually_reach_robustness` = max-over-interval of inside-robustness;
`stl_always_avoid_robustness` = min-over-interval of −inside;
`stl_pairwise_separation_robustness` = min over time/pairs of distance −
min_distance; plan stats include total_cost/conflicts_resolved,
lib.rs:178-183), kinodynamic_stl_cbs.rs (speed-limited moves),
hierarchical_mapf.rs (region graph: plan independently, find coarse region
conflicts, replan only the affected agent groups), safe_decode_nav.rs
(greedy policy + STL shield: hard always-avoid pruning + soft
eventually-reach shaping in a deterministic beam).

Paths are dense [T, 2] integer-cell arrays (position at every timestep);
robustness metrics are reductions over the time axis; the low level is the
time-expanded wavefront of `planning/temporal.py` with a parametric move
set (kinodynamic = larger move radius), one read of the field a plan. CBS's
high-level loop (detect the earliest conflict, constrain the
lower-priority agent, replan it) runs on the host over those paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import filled, norm2
from rust_robotics_tpu_torch.planning.grid import _bool_on, _float_on, _placement
from rust_robotics_tpu_torch.planning.temporal import _time_relax

BIG = 1e18

__all__ = [
    "StlRectangle",
    "inside_robustness",
    "avoid_robustness",
    "eventually_reach_robustness",
    "always_avoid_robustness",
    "pairwise_separation_robustness",
    "first_conflict",
    "stl_cbs_plan",
    "kinodynamic_stl_cbs_plan",
    "hierarchical_mapf_plan",
    "safe_decode_nav",
]


@dataclasses.dataclass(frozen=True)
class StlRectangle:
    """StlRectangle2D (stl_cbs.rs:108): axis-aligned STL predicate region."""

    min_x: float
    max_x: float
    min_y: float
    max_y: float

    def as_array(self, device=None, dtype=torch.float32):
        """[min_x, max_x, min_y, max_y] on `device` (default cuda)."""
        return filled(dataclasses.astuple(self), dtype, _placement(None, device))


def _rect(r, device, dtype):
    if isinstance(r, StlRectangle):
        return r.as_array(device, dtype)
    return _float_on(r, device, dtype)


def inside_robustness(rect, x, y):
    """Margin to the nearest face; positive inside
    (StlRectangle2D::inside_robustness). rect a [4] tensor."""
    return torch.minimum(torch.minimum(x - rect[0], rect[1] - x),
                         torch.minimum(y - rect[2], rect[3] - y))


def avoid_robustness(rect, x, y):
    return -inside_robustness(rect, x, y)


def _interval_mask(t_len, interval, device):
    t = torch.arange(t_len, device=device)
    return (t >= interval[0]) & (t <= interval[1])


def _path_xy(path, device, dtype):
    path = torch.as_tensor(path, device=_placement(path, device))
    return path[:, 0].to(dtype), path[:, 1].to(dtype)


def eventually_reach_robustness(path, rect, interval, device=None, dtype=torch.float32):
    """ρ(F_[a,b] inside(region)) = max_t∈[a,b] inside_robustness(path_t)
    (stl_cbs.rs:548). path [T, 2] (host data goes to `device`, default
    cuda), rect a StlRectangle or [4]; a 0-d tensor in `dtype`."""
    x, y = _path_xy(path, device, dtype)
    rho = inside_robustness(_rect(rect, x.device, dtype), x, y)
    m = _interval_mask(x.shape[0], interval, x.device)
    return torch.amax(torch.where(m, rho, -torch.inf))


def always_avoid_robustness(path, rect, interval, device=None, dtype=torch.float32):
    """ρ(G_[a,b] outside(region)) = min_t∈[a,b] −inside_robustness
    (stl_cbs.rs:563); arguments as `eventually_reach_robustness`."""
    x, y = _path_xy(path, device, dtype)
    rho = avoid_robustness(_rect(rect, x.device, dtype), x, y)
    m = _interval_mask(x.shape[0], interval, x.device)
    return torch.amin(torch.where(m, rho, torch.inf))


def pairwise_separation_robustness(paths, min_distance, interval, device=None,
                                   dtype=torch.float32):
    """min over t∈[a,b] and agent pairs of (‖a_t − b_t‖ − min_distance)
    (stl_cbs.rs:578); +inf for <2 agents."""
    paths = _float_on(paths, device, dtype)  # [A, T, 2]
    a = paths.shape[0]
    if a < 2:
        return torch.full((), torch.inf, dtype=dtype, device=paths.device)
    d = norm2(paths[:, None] - paths[None, :])  # [A, A, T]
    iu = torch.triu_indices(a, a, 1, device=paths.device)
    pair_d = d[iu[0], iu[1]]  # [P, T]
    m = _interval_mask(paths.shape[1], interval, paths.device)
    return torch.amin(torch.where(m[None, :], pair_d - min_distance, torch.inf))


def first_conflict(paths, arrivals=None):
    """Earliest vertex or edge (swap) conflict among dense [A, T, 2] paths;
    returns (t, agent_i, agent_j, kind) with kind 0=vertex 1=edge, or None.
    Host-side (drives the CBS loop)."""
    p = np.asarray(paths)
    a, t_max, _ = p.shape
    for t in range(t_max):
        for i in range(a):
            for j in range(i + 1, a):
                if (p[i, t] == p[j, t]).all():
                    return t, i, j, 0
                if t > 0 and (p[i, t] == p[j, t - 1]).all() and (p[i, t - 1] == p[j, t]).all():
                    return t, i, j, 1
    return None


# ---------------------------------------------------------------------------
# parametric time-expanded low level


def _moves(speed: int):
    out = []
    for dx in range(-speed, speed + 1):
        for dy in range(-speed, speed + 1):
            out.append((dx, dy, float(np.hypot(dx, dy))))
    return tuple(out)


def _time_costs(free_t, start_idx, speed: int = 1, dtype=torch.float32):
    """Earliest-arrival field with Chebyshev move radius `speed`
    (kinodynamic_stl_cbs.rs speed-limited motion)."""
    return _time_relax(free_t, start_idx, _moves(speed), dtype)


def _backtrack(d, goal_idx, t_arrival, speed=1):
    """Backtrack the host field d [T, W, H] from the goal at t_arrival."""
    moves = _moves(speed)
    t_len, w, h = d.shape
    cur = (int(goal_idx[0]), int(goal_idx[1]))
    out = [cur] * t_len
    for t in range(int(t_arrival), 0, -1):
        best, best_val = cur, np.inf
        for dx, dy, c in moves:
            px, py = cur[0] - dx, cur[1] - dy
            if 0 <= px < w and 0 <= py < h and d[t - 1, px, py] + c < best_val:
                best, best_val = (px, py), d[t - 1, px, py] + c
        cur = best
        out[t - 1] = cur
    for t in range(int(t_arrival) + 1, t_len):
        out[t] = (int(goal_idx[0]), int(goal_idx[1]))
    return np.array(out)


def _carve_regions(free_t, regions):
    """Carve hard always-avoid STL regions (cell centers inside the
    rectangle during the interval) out of [T, W, H] traversability;
    regions hold [4] tensors in the field's dtype."""
    t_len, w, h = free_t.shape
    dev = free_t.device
    for rect, interval in regions:
        gx = torch.arange(w, device=dev)[:, None].expand(w, h).to(rect.dtype)
        gy = torch.arange(h, device=dev)[None, :].expand(w, h).to(rect.dtype)
        inside = inside_robustness(rect, gx, gy) >= 0.0
        m = _interval_mask(t_len, interval, dev)
        free_t = free_t & ~(m[:, None, None] & inside[None])
    return free_t


def _plan_agent(free_t, start, goal, speed, constraints, dtype):
    """Plan one agent around explicit (t, x, y) constraints; one read of
    its field."""
    if constraints:
        free_t = free_t.clone()
        for t, x, y in constraints:
            free_t[t, x, y] = False
    d = _time_costs(free_t, start, speed, dtype).cpu().numpy()
    reach = d[:, int(goal[0]), int(goal[1])] < BIG / 2
    if not reach.any():
        return None, -1
    t_arr = int(np.argmax(reach))
    return _backtrack(d, goal, t_arr, speed), t_arr


def _static_free_t(static_free, t_max, device):
    static = _bool_on(static_free, device)
    return static[None].expand((t_max,) + tuple(static.shape))


def stl_cbs_plan(static_free, starts, goals, t_max, avoid_regions=(), reach_specs=(),
                 min_separation=1.0, speed: int = 1, max_conflict_rounds: int = 64, device=None,
                 dtype=torch.float32):
    """STL-CBS (stl_cbs.rs): multi-agent grid planning with STL shields.

    avoid_regions: ((StlRectangle|[4], (t0, t1)), ...) — hard G-avoid specs
    carved from every agent's traversability. reach_specs: ((agent, rect,
    interval), ...) — evaluated into the robustness report. Conflicts
    (vertex + swap) are resolved by constraining the lower-priority agent
    and replanning it — iterated to quiescence. The fields on `device`
    (default cuda; static_free's own when a tensor), in `dtype`.

    Returns dict(paths [A, T, 2], arrivals [A], total_cost,
    conflicts_resolved, min_pairwise_separation_robustness,
    reach_robustness, avoid_robustness)."""
    a = len(starts)
    free_t = _static_free_t(static_free, t_max, device)
    dev = free_t.device
    regions = [(_rect(r, dev, dtype), iv) for r, iv in avoid_regions]
    free_t = _carve_regions(free_t, regions)

    constraints = [set() for _ in range(a)]
    paths, arrivals = [], []
    for i in range(a):
        p, t_arr = _plan_agent(free_t, starts[i], goals[i], speed, constraints[i], dtype)
        if p is None:
            p = np.tile(np.asarray(starts[i]), (t_max, 1))
        paths.append(p)
        arrivals.append(t_arr)
    paths = np.stack(paths)

    resolved = 0
    for _ in range(max_conflict_rounds):
        c = first_conflict(paths)
        if c is None:
            break
        t, i, j, kind = c
        # constrain the lower-priority (higher-index) agent
        loser = j
        if kind == 0:
            constraints[loser].add((t, int(paths[i, t, 0]), int(paths[i, t, 1])))
        else:
            constraints[loser].add((t, int(paths[loser, t, 0]), int(paths[loser, t, 1])))
            constraints[loser].add((t, int(paths[loser, t - 1, 0]),
                                    int(paths[loser, t - 1, 1])))
        p, t_arr = _plan_agent(free_t, starts[loser], goals[loser], speed, constraints[loser],
                               dtype)
        if p is None:
            p = np.tile(np.asarray(starts[loser]), (t_max, 1))
            t_arr = -1
        paths[loser] = p
        arrivals[loser] = t_arr
        resolved += 1

    full = (0, t_max - 1)
    paths_d = torch.as_tensor(paths, device=dev)
    sep = pairwise_separation_robustness(paths_d, min_separation, full, dtype=dtype)
    reach = {int(agent): float(eventually_reach_robustness(paths_d[agent], _rect(r, dev, dtype),
                                                           iv, dtype=dtype))
             for agent, r, iv in reach_specs}
    avoid = {k: min(float(always_avoid_robustness(paths_d[agent], r, iv, dtype=dtype))
                    for agent in range(a))
             for k, (r, iv) in enumerate(regions)}
    total_cost = int(sum(t for t in arrivals if t >= 0))
    return {
        "paths": paths,
        "arrivals": np.asarray(arrivals),
        "total_cost": total_cost,
        "conflicts_resolved": resolved,
        "min_pairwise_separation_robustness": float(sep),
        "reach_robustness": reach,
        "avoid_robustness": avoid,
    }


def kinodynamic_stl_cbs_plan(static_free, starts, goals, t_max, speed=2, **kw):
    """Kinodynamic STL-CBS (kinodynamic_stl_cbs.rs): the same coordination
    layer over a speed-limited move set (Chebyshev radius `speed` per
    step — cells/step is the discrete velocity bound)."""
    return stl_cbs_plan(static_free, starts, goals, t_max, speed=speed, **kw)


def hierarchical_mapf_plan(static_free, starts, goals, t_max, region_size: int = 8,
                           speed: int = 1, device=None, dtype=torch.float32):
    """Hierarchical MAPF (hierarchical_mapf.rs): plan all agents
    independently; detect coarse *region* conflicts (two agents in the same
    region_size×region_size block at the same time); replan only the
    affected groups with the CBS layer.

    Returns dict(paths, arrivals, groups_replanned, region_conflicts,
    conflicts_resolved)."""
    a = len(starts)
    free_t = _static_free_t(static_free, t_max, device)
    paths, arrivals = [], []
    for i in range(a):
        p, t_arr = _plan_agent(free_t, starts[i], goals[i], speed, set(), dtype)
        if p is None:
            p = np.tile(np.asarray(starts[i]), (t_max, 1))
        paths.append(p)
        arrivals.append(t_arr)
    paths = np.stack(paths)

    # region-time occupancy
    regions = paths // region_size  # [A, T, 2]
    conflict_pairs = set()
    for t in range(t_max):
        seen = {}
        for i in range(a):
            key = (int(regions[i, t, 0]), int(regions[i, t, 1]))
            if key in seen:
                conflict_pairs.add((seen[key], i))
            else:
                seen[key] = i
    # union-find groups over conflicting pairs
    parent = list(range(a))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in conflict_pairs:
        parent[find(i)] = find(j)
    groups = {}
    for i in range(a):
        groups.setdefault(find(i), []).append(i)

    groups_replanned = 0
    resolved = 0
    for members in groups.values():
        if len(members) < 2:
            continue
        sub = stl_cbs_plan(free_t[0], [starts[m] for m in members], [goals[m] for m in members],
                           t_max, speed=speed, dtype=dtype)
        for k, m in enumerate(members):
            paths[m] = sub["paths"][k]
            arrivals[m] = int(sub["arrivals"][k])
        groups_replanned += 1
        resolved += sub["conflicts_resolved"]
    return {
        "paths": paths,
        "arrivals": np.asarray(arrivals),
        "groups_replanned": groups_replanned,
        "region_conflicts": len(conflict_pairs),
        "conflicts_resolved": resolved,
    }


# ---------------------------------------------------------------------------
# STL-shielded constrained decoding (safe_decode_nav.rs)

_ACTIONS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))


def _rect_host(r):
    return np.asarray(dataclasses.astuple(r) if isinstance(r, StlRectangle) else r, np.float64)


def safe_decode_nav(static_free, start, goal, t_max, avoid_regions=(), reach_spec=None,
                    beam_width: int = 8, reach_weight: float = 0.1, device=None,
                    dtype=torch.float32):
    """SafeDec-lite (safe_decode_nav.rs): a greedy goal-seeking base policy
    decoded under an STL shield, on the host.

    - Base policy score: negative Euclidean distance-to-goal of the next
      cell (deterministically tie-broken by action index).
    - Hard shield: candidates entering an always-avoid region during its
      interval are pruned.
    - Soft shaping: an eventually-reach spec adds `reach_weight ×
      inside_robustness` to the beam score.

    The two paths' avoid robustness is computed on `device` (default
    cuda) in `dtype`. Returns dict(greedy_path [T, 2], shielded_path
    [T, 2], overrides, greedy_avoid_robustness, shielded_avoid_robustness,
    robustness_gain)."""
    free = np.asarray(static_free.cpu() if isinstance(static_free, torch.Tensor)
                      else static_free)
    w, h = free.shape
    goal = np.asarray(goal, float)
    regions = [(_rect_host(r), iv) for r, iv in avoid_regions]
    device = _placement(static_free, device)

    def valid(c):
        return 0 <= c[0] < w and 0 <= c[1] < h and free[c[0], c[1]]

    def inside(rect, c):
        return min(c[0] - rect[0], rect[1] - c[0], c[1] - rect[2], rect[3] - c[1]) >= 0

    def greedy_rollout(shielded: bool):
        beams = [((int(start[0]), int(start[1])), [tuple(start)], 0.0)]
        overrides = 0
        for t in range(1, t_max):
            cand = []
            for (cell, hist, score) in beams:
                best_unshielded = None
                for ai, (dx, dy) in enumerate(_ACTIONS):
                    nxt = (cell[0] + dx, cell[1] + dy)
                    if not valid(nxt):
                        continue
                    base = -float(np.hypot(nxt[0] - goal[0], nxt[1] - goal[1]))
                    if best_unshielded is None or base > best_unshielded[0]:
                        best_unshielded = (base, nxt)
                    if shielded:
                        blocked = any(iv[0] <= t <= iv[1] and inside(rect, nxt)
                                      for rect, iv in regions)
                        if blocked:
                            continue
                    bonus = 0.0
                    if shielded and reach_spec is not None:
                        rect, iv = reach_spec
                        ra = _rect_host(rect)
                        if iv[0] <= t <= iv[1]:
                            bonus = reach_weight * min(nxt[0] - ra[0], ra[1] - nxt[0],
                                                       nxt[1] - ra[2], ra[3] - nxt[1])
                    cand.append((score + base + bonus, ai, nxt, hist + [nxt]))
                if shielded and best_unshielded is not None and cand:
                    # did the shield override the greedy argmax this step?
                    top = max(cand, key=lambda z: (z[0], -z[1]))
                    if top[2] != best_unshielded[1] and all(
                            c[2] != best_unshielded[1] for c in cand):
                        overrides += 1
            if not cand:
                # stuck: wait in place
                beams = [(b[0], b[1] + [b[0]], b[2]) for b in beams]
                continue
            cand.sort(key=lambda z: (-z[0], z[1]))
            beams = [(c[2], c[3], c[0]) for c in cand[:beam_width]]
        best = max(beams, key=lambda z: z[2])
        return np.asarray(best[1]), overrides

    greedy_path, _ = greedy_rollout(shielded=False)
    shielded_path, overrides = greedy_rollout(shielded=True)

    def worst_avoid(path):
        if not regions:
            return float("inf")
        return float(min(always_avoid_robustness(path, torch.as_tensor(rect, device=device),
                                                 iv, device=device, dtype=dtype)
                         for rect, iv in regions))

    g_rho = worst_avoid(greedy_path)
    s_rho = worst_avoid(shielded_path)
    return {
        "greedy_path": greedy_path,
        "shielded_path": shielded_path,
        "overrides": overrides,
        "greedy_avoid_robustness": g_rho,
        "shielded_avoid_robustness": s_rho,
        "robustness_gain": s_rho - g_rho,
    }
