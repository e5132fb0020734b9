"""Temporal planning: time-expanded wavefront (SIPP-family capability).

The port of rust_robotics_tpu/planning/temporal.py. Reference:
crates/rust_robotics_planning/src/ — sipp.rs (safe-interval path planning
around moving obstacles), time_based_path_planning.rs, conformal_sipp.rs,
hierarchical_mapf.rs, stl_cbs.rs.

The search runs on the *time-expanded raster* D[t, x, y] — arrival-time
cost relaxed forward in time against a per-step dynamic obstacle mask
[T, W, H]. Wait-in-place is an edge; every timestep relaxes all cells at
once, a loop over T with nothing read back. Multi-agent prioritized
planning reserves each planned trajectory in the obstacle tensor. Start
and goal cells are host integers; backtracking reads the field once.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch.planning.grid import _bool_on
from rust_robotics_tpu_torch.planning.wavefront import _shift

BIG = 1e18

# 8-connected + wait
_MOVES = ((0, 0, 1.0), (1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
          (1, 1, 1.4142135623730951), (1, -1, 1.4142135623730951),
          (-1, 1, 1.4142135623730951), (-1, -1, 1.4142135623730951))


def _time_relax(free_t, start_idx, moves, dtype):
    """D [T, W, H]: d0 is 0 at the start cell (if free at t = 0), BIG
    elsewhere; D[t] = where(free_t[t], min over moves of shift(D[t-1]) + c,
    BIG)."""
    t_max, w, h = free_t.shape
    out = torch.empty((t_max, w, h), dtype=dtype, device=free_t.device)
    d = torch.full((w, h), BIG, dtype=dtype, device=free_t.device)
    d[int(start_idx[0]), int(start_idx[1])] = 0.0
    out[0] = torch.where(free_t[0], d, BIG)
    for t in range(1, t_max):
        d = out[t - 1]
        best = torch.full_like(d, BIG)
        for dx, dy, c in moves:
            best = torch.minimum(best, _shift(d, dx, dy, BIG) + c)
        out[t] = torch.where(free_t[t], best, BIG)
    return out


def time_expanded_costs(free_t, start_idx, device=None, dtype=torch.float32):
    """Earliest-arrival cost field.

    free_t [T, W, H]: traversability per timestep (dynamic obstacles carved
    out; host data goes to `device`, default cuda). start_idx host
    integers. Returns D [T, W, H] in `dtype`: minimal path cost to be AT
    cell (x, y) at time t, starting from start_idx at t=0 (BIG where
    unreachable/blocked).
    """
    return _time_relax(_bool_on(free_t, device), start_idx, _MOVES, dtype)


def earliest_arrival(costs, goal_idx):
    """(t*, cost) of the earliest affordable arrival at the host goal cell,
    0-d tensors: (-1, inf) when never reached."""
    series = costs[:, int(goal_idx[0]), int(goal_idx[1])]
    reachable = series < BIG
    t_star = torch.argmax(reachable.to(torch.int32)).reshape(1)  # the first reachable step
    found = torch.any(reachable)
    return (torch.where(found, t_star[0], -1),
            torch.where(found, series.index_select(0, t_star)[0], torch.inf))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extract_time_path(costs, goal_idx, t_arrival):
    """Backtrack the time-expanded field (read once); returns cells [T, 2]
    (position at every timestep up to t_arrival, then frozen at the goal)."""
    d = _host(costs)
    t_max = d.shape[0]
    cur = (int(goal_idx[0]), int(goal_idx[1]))
    out = [cur] * t_max
    w, h = d.shape[1:]
    for t in range(int(t_arrival), 0, -1):
        best, best_val = cur, np.inf
        for dx, dy, c in _MOVES:
            px, py = cur[0] - dx, cur[1] - dy
            if 0 <= px < w and 0 <= py < h:
                val = d[t - 1, px, py] + c
                if val < best_val and abs(val - d[t, cur[0], cur[1]]) < 1e-9:
                    best, best_val = (px, py), val
        # fall back to min-predecessor when exact cost match fails
        if best_val == np.inf:
            for dx, dy, c in _MOVES:
                px, py = cur[0] - dx, cur[1] - dy
                if 0 <= px < w and 0 <= py < h and d[t - 1, px, py] + c < best_val:
                    best, best_val = (px, py), d[t - 1, px, py] + c
        cur = best
        out[t - 1] = cur
    for t in range(int(t_arrival), t_max):
        out[t] = (int(goal_idx[0]), int(goal_idx[1]))
    return np.array(out)


def moving_obstacle_mask(static_free, obstacle_trajs, t_max, radius=0, device=None):
    """[T, W, H] traversability with moving obstacles carved out.

    obstacle_trajs [A, T', 2] integer cells per timestep (T' >= t_max), on
    static_free's device (host data: `device`, default cuda).
    """
    static_free = _bool_on(static_free, device)
    dev = static_free.device
    w, h = static_free.shape
    trajs = torch.as_tensor(obstacle_trajs, device=dev)[:, :t_max].to(torch.int64)
    gx = torch.arange(w, device=dev)[None, :, None]
    gy = torch.arange(h, device=dev)[None, None, :]
    hit = torch.zeros((t_max, w, h), dtype=torch.bool, device=dev)
    for a in range(trajs.shape[0]):
        d2 = (gx - trajs[a, :, 0, None, None]) ** 2 + (gy - trajs[a, :, 1, None, None]) ** 2
        hit = hit | (d2 <= radius * radius)
    return static_free[None] & ~hit


def prioritized_multi_agent(static_free, starts, goals, t_max, radius=0, device=None,
                            dtype=torch.float32):
    """Decoupled prioritized MAPF: plan agents in order, reserving each
    trajectory in the shared dynamic obstacle tensor, on the host. Returns
    (paths [A, T, 2], arrivals [A]); the fields on `device` (default cuda;
    a tensor's own)."""
    static = _bool_on(static_free, device)
    free_t = np.broadcast_to(_host(static), (t_max,) + tuple(static.shape)).copy()
    paths, arrivals = [], []
    for a in range(len(starts)):
        costs = time_expanded_costs(torch.as_tensor(free_t, device=static.device), starts[a],
                                    dtype=dtype)
        t_arr, _ = earliest_arrival(costs, goals[a])
        t_arr = int(t_arr)
        if t_arr < 0:
            paths.append(np.tile(np.asarray(starts[a]), (t_max, 1)))
            arrivals.append(-1)
            continue
        path = extract_time_path(costs, goals[a], t_arr)
        paths.append(path)
        arrivals.append(t_arr)
        for t in range(t_max):
            x, y = path[t]
            free_t[t, x, y] = False  # vertex reservation
            if t + 1 < t_max:
                free_t[t + 1, x, y] = False  # swap-conflict guard
    return np.stack(paths), np.asarray(arrivals)
