"""Coverage path planning: wavefront CPP, Spiral-STC, spiral coverage.

The port of rust_robotics_tpu/planning/coverage.py. Reference:
crates/rust_robotics_planning/src/ —
wavefront_cpp.rs (Zelinsky wavefront coverage: BFS transform from the goal
— Chessboard all-1 or Euclidean 1/√2 costs, optional Path transform adding
α · obstacle-distance of the expanded cell :153-:199; coverage walk
greedily visits the unvisited neighbor with the HIGHEST transform value,
backtracking along the path when stuck :278-:340; goal-relative neighbor
search order :214),
spiral_spanning_tree_cpp.rs (Spiral-STC: 2×2 mega-cells, DFS spanning
tree with S/E/N/W order and backtrace route, coverage segments at
original resolution :156-:305),
coverage_planning.rs (clockwise spiral walk :97-:150; the boustrophedon
lives in planning/fields.py).

Both transform fields (goal wavefront + obstacle distance) are min-plus
relaxations on the device: one launch of kernel B2 each on the card, or
the plain risk stencil for the Path transform. The coverage walks are
sequential (every step depends on the visited set) and stay on the host
over the fields read back once, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from rust_robotics_tpu_torch.planning.grid import _bool_on, _host_bool, _one_hot
from rust_robotics_tpu_torch.planning.risk_graph import risk_wavefront_costs
from rust_robotics_tpu_torch.planning.wavefront import SQRT2, wavefront_costs

__all__ = [
    "WavefrontCppConfig",
    "obstacle_distance_transform",
    "coverage_transform",
    "wavefront_cpp",
    "spiral_stc_plan",
    "spiral_coverage",
    "coverage_metrics",
]


@dataclasses.dataclass(frozen=True)
class WavefrontCppConfig:
    """wavefront_cpp.rs config: distance_type ∈ {chessboard, euclidean},
    transform_type ∈ {distance, path}."""

    distance_type: str = "chessboard"
    transform_type: str = "distance"
    alpha: float = 0.01


def obstacle_distance_transform(blocked, device=None, dtype=torch.float32):
    """4-connected BFS distance from obstacle cells (wavefront_cpp.rs:114);
    all-free grids get +inf everywhere. blocked [W, H] (host data goes to
    `device`, default cuda); one B2 launch on the card."""
    blocked = _bool_on(blocked, device)
    d = wavefront_costs(torch.ones_like(blocked), blocked, connectivity=4, dtype=dtype)
    return torch.where(torch.any(blocked), d, torch.inf)


def coverage_transform(blocked, goal, cfg: WavefrontCppConfig, device=None,
                       dtype=torch.float32):
    """Wavefront transform from the host cell `goal` with the reference's
    cost law: chessboard (diag 1) or euclidean (diag √2), 8-connected (one
    B2 launch); or, for the Path transform, the risk stencil with
    α·obstacle-distance as the cell risk (the obstacle distance one B2
    launch)."""
    blocked = _bool_on(blocked, device)
    free = ~blocked
    goals = _one_hot(blocked.shape, goal, blocked.device)
    if cfg.transform_type == "path":
        # per-cell additive α·obstacle_dist along the expansion — the
        # min-plus equivalent uses the entered cell's obstacle distance
        od = obstacle_distance_transform(blocked, dtype=dtype)
        od = torch.where(torch.isfinite(od), od, 0.0)
        return risk_wavefront_costs(free, cfg.alpha * od, goals, distance_weight=1.0,
                                    risk_weight=2.0,  # ½(r_from + r_to)·2 ≈ r per step
                                    dtype=dtype)
    diag = 1.0 if cfg.distance_type == "chessboard" else SQRT2
    return wavefront_costs(free, goals, connectivity=8, diag_cost=diag, dtype=dtype)


def wavefront_cpp(blocked, start, goal, cfg: WavefrontCppConfig = WavefrontCppConfig(),
                  device=None, dtype=torch.float32):
    """Coverage path visiting every reachable free cell (wavefront_cpp.rs:
    278): greedily step to the unvisited free neighbor with the highest
    transform value; when stuck, backtrack along the path to the first cell
    with an unvisited neighbor. The transform on `device` (default cuda;
    a tensor's own), the walk on the host. Returns (path [K, 2],
    covered_count)."""
    t = coverage_transform(blocked, goal, cfg, device, dtype).cpu().numpy()
    blocked = _host_bool(blocked)
    w, h = blocked.shape
    sr, sc = start
    gr, gc = goal
    # goal-relative neighbor order (wavefront_cpp.rs:214)
    if sr >= gr and sc >= gc:
        order = [(1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]
    elif sr <= gr and sc >= gc:
        order = [(-1, 0), (0, 1), (1, 0), (0, -1), (-1, 1), (-1, -1), (1, 1), (1, -1)]
    elif sr >= gr and sc <= gc:
        order = [(1, 0), (0, -1), (-1, 0), (0, 1), (1, -1), (-1, -1), (1, 1), (-1, 1)]
    else:
        order = [(-1, 0), (0, -1), (0, 1), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)]

    visited = np.zeros((w, h), bool)
    path = []
    cur = tuple(start)
    goal = tuple(goal)
    for _ in range(4 * w * h):
        if cur == goal:
            path.append(cur)
            break
        path.append(cur)
        visited[cur] = True
        best, best_val = None, -np.inf
        for pr, pc in reversed(path):
            for dr, dc in order:
                nr, nc = pr + dr, pc + dc
                if 0 <= nr < w and 0 <= nc < h and not blocked[nr, nc] and \
                        not visited[nr, nc] and np.isfinite(t[nr, nc]) and \
                        t[nr, nc] > best_val:
                    best_val = t[nr, nc]
                    best = (nr, nc)
            if best is not None:
                break
        if best is None:
            break
        cur = best
    path = np.asarray(path)
    return path, int(len(np.unique(path, axis=0)))


# ---------------------------------------------------------------------------
# Spiral-STC (spiral_spanning_tree_cpp.rs), host NumPy


def _valid_merged(free, i, j):
    mh, mw = free.shape[0] // 2, free.shape[1] // 2
    if not (0 <= i < mh and 0 <= j < mw):
        return False
    r, c = 2 * i, 2 * j
    return bool(free[r, c] and free[r + 1, c] and free[r, c + 1] and free[r + 1, c + 1])


_SUB = {
    "SE": lambda r, c: (2 * r + 1, 2 * c + 1),
    "SW": lambda r, c: (2 * r + 1, 2 * c),
    "NE": lambda r, c: (2 * r, 2 * c + 1),
    "NW": lambda r, c: (2 * r, 2 * c),
}


def _direction(p, q):
    if p[0] == q[0]:
        return "E" if p[1] < q[1] else "W"
    return "S" if p[0] < q[0] else "N"


_MOVE_QUADS = {"E": ("SE", "SW"), "W": ("NW", "NE"), "S": ("SW", "NW"), "N": ("NE", "SE")}
_ROUND_TRIP = {"E": ("SE", "NE"), "S": ("SW", "SE"), "W": ("NW", "SW"), "N": ("NE", "NW")}


def spiral_stc_plan(free, start_merged):
    """Spiral-STC: DFS spanning tree over 2×2 mega-cells, then coverage
    segments at original resolution. Returns dict(edges, route,
    path_segments [K, 2, 2]) — CoveragePlanResult."""
    free = _host_bool(free)
    if free.shape[0] % 2 or free.shape[1] % 2:
        raise ValueError(f"Spiral-STC needs even grid sides, got {free.shape}")
    mh, mw = free.shape[0] // 2, free.shape[1] // 2
    visit = np.zeros((mh, mw), np.uint8)
    visit[tuple(start_merged)] = 1
    edges, route = [], []
    order = [(1, 0), (0, 1), (-1, 0), (0, -1)]  # S, E, N, W

    def dfs(cur):
        route.append(cur)
        found = False
        for di, dj in order:
            ni, nj = cur[0] + di, cur[1] + dj
            if _valid_merged(free, ni, nj) and visit[ni, nj] == 0:
                edges.append((cur, (ni, nj)))
                found = True
                visit[ni, nj] = 1
                dfs((ni, nj))
        if not found:
            for node in reversed(list(route)):
                if visit[node] == 2:
                    continue
                visit[node] += 1
                route.append(node)
                if any(_valid_merged(free, node[0] + di, node[1] + dj)
                       and visit[node[0] + di, node[1] + dj] == 0 for di, dj in order):
                    break

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * mh * mw + 100))
    try:
        dfs(tuple(start_merged))
    finally:
        sys.setrecursionlimit(old)

    segments = []
    for k in range(len(route) - 1):
        cur, nxt = route[k], route[k + 1]
        dp = abs(cur[0] - nxt[0]) + abs(cur[1] - nxt[1])
        if dp == 0:
            if k > 0:
                d = _direction(route[k - 1], cur)
                a, b = _ROUND_TRIP[d]
                segments.append((_SUB[a](*cur), _SUB[b](*cur)))
        elif dp == 1:
            d = _direction(cur, nxt)
            a, b = _MOVE_QUADS[d]
            segments.append((_SUB[a](*cur), _SUB[b](*nxt)))
        else:
            # distance-2 hop: shared spanning-tree neighbor in between
            p_ngb = {n for m, n in edges if m == cur} | {m for m, n in edges if n == cur}
            q_ngb = {n for m, n in edges if m == nxt} | {m for m, n in edges if n == nxt}
            mid = (p_ngb & q_ngb).pop()
            for a, b in ((cur, mid), (mid, nxt)):
                d = _direction(a, b)
                qa, qb = _MOVE_QUADS[d]
                segments.append((_SUB[qa](*a), _SUB[qb](*b)))
    return {
        "edges": edges,
        "route": np.asarray(route),
        "path_segments": np.asarray(segments),
    }


def spiral_coverage(blocked, start):
    """Clockwise spiral coverage (coverage_planning.rs:97): march straight,
    turn clockwise when blocked/visited; stop after 4 consecutive turns.
    Returns path [K, 2] (host)."""
    blocked = _host_bool(blocked)
    w, h = blocked.shape
    dx = [1, 0, -1, 0]
    dy = [0, 1, 0, -1]
    x, y = start
    if blocked[x, y]:
        return np.zeros((0, 2), int)
    visited = np.zeros((w, h), bool)
    path = [(x, y)]
    visited[x, y] = True
    d = 0
    stuck = 0
    total_free = int((~blocked).sum())
    while len(path) < total_free and stuck < 4:
        nx, ny = x + dx[d], y + dy[d]
        if 0 <= nx < w and 0 <= ny < h and not blocked[nx, ny] and not visited[nx, ny]:
            x, y = nx, ny
            path.append((x, y))
            visited[x, y] = True
            stuck = 0
        else:
            d = (d + 1) % 4
            stuck += 1
    return np.asarray(path)


def coverage_metrics(path, blocked):
    """Coverage ratio + revisit count for a cell path (host)."""
    blocked = _host_bool(blocked)
    free_count = int((~blocked).sum())
    uniq = len(np.unique(np.asarray(path), axis=0)) if len(path) else 0
    return {
        "coverage_ratio": uniq / max(free_count, 1),
        "revisits": int(len(path) - uniq),
        "path_cells": int(len(path)),
    }
