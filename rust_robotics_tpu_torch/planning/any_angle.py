"""Any-angle planners: corner-visibility optimum + Theta*-style wavefront.

The port of rust_robotics_tpu/planning/any_angle.py. Reference surface:
- theta_star.rs:1-507 / lazy_theta_star.rs:1-548 /
  enhanced_lazy_theta_star.rs:1-609 — any-angle grid planners whose parent
  pointers may skip to any LOS-visible ancestor (the "path-2" vertex rule).
- anya.rs:1-463 — the reference's *optimality baseline*: exact any-angle
  shortest paths via visibility-graph Dijkstra (run on tractable grids,
  tests/any_angle_optimality_gap.rs:1-20).

1. `VisibilityPlanner` — the exact any-angle optimum. Taut shortest
   any-angle paths only turn at convex obstacle corners, so the optimum is
   a shortest path in the visibility graph over corners + start + goal.
   The corner-pair LOS matrix is a batched sampled-segment probe in row
   tiles; the single-source solve is dense min-plus relaxation (Bellman)
   over the [C, C] adjacency, the scenarios of a batch in lock-step, each
   lane masked once its own relaxation stops, so a lane equals its solo
   run. The stop flags stay on the device and are read every
   `READ_EVERY` hops.

2. `theta_wavefront_costs` — a Theta*-equivalent LOS-relaxed wavefront:
   the octile recursion extended with Theta*'s path-2 rule evaluated
   synchronously. Each sweep is 8 shifted min-plus updates + 8 raster-wide
   batched LOS probes; the stop flag is read once a block of sweeps, as
   the JAX `while_loop` tests it.

Lengths are `_numeric.norm2`, `jnp.linalg.norm`'s rounding.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import norm2
from rust_robotics_tpu_torch.planning.grid import _bool_on, _host_bool
from rust_robotics_tpu_torch.planning.smoothing import line_of_sight_free
from rust_robotics_tpu_torch.planning.wavefront import SQRT2, _shift

BIG = 1e18
# the visibility solve reads its lanes' stop flags once every this many hops
READ_EVERY = 8


# --------------------------------------------------------------------------
# corner extraction
# --------------------------------------------------------------------------

def corner_mask(free, device=None):
    """Convex-corner raster: free cells diagonal to a blocked cell whose two
    adjacent orthogonal cells are free (the same corner rule as
    a_star_variants.rs:349-405). On free's device (host data: `device`,
    default cuda)."""
    free = _bool_on(free, device)
    blocked = ~free
    out = torch.zeros_like(free)
    for dx in (-1, 1):
        for dy in (-1, 1):
            diag = _shift(blocked, dx, dy, True)
            side_x = _shift(blocked, dx, 0, True)
            side_y = _shift(blocked, 0, dy, True)
            out = out | (diag & ~side_x & ~side_y)
    return out & free


def corner_points(free, device=None):
    """[C, 2] float64 cell-center coordinates of the convex corners (host)."""
    m = corner_mask(free, device).cpu().numpy()
    return np.argwhere(m).astype(np.float64) + 0.5


def corner_vertices(free, eps: float = 1e-3):
    """[C, 2] ε-offset lattice corner vertices of the blocked region (host
    NumPy, float64).

    Continuous-space shortest paths among the blocked cells (unit squares)
    turn exactly at convex corners of the blocked region: lattice points
    where exactly ONE of the four surrounding cells is blocked (anya.rs:
    208-216). Each vertex is nudged by ε diagonally away from its blocked
    cell so sampled-LOS segments pass strictly outside the obstacle.
    """
    blocked = ~_host_bool(free)
    w, h = blocked.shape
    pad = np.pad(blocked, 1, constant_values=False)  # outside counts free
    # cell (vx+sx, vy+sy) for sx,sy in {-1,0} surrounds lattice vertex (vx,vy)
    cells = {
        (sx, sy): pad[1 + sx: w + 2 + sx, 1 + sy: h + 2 + sy]
        for sx in (-1, 0) for sy in (-1, 0)
    }  # each [w+1, h+1] — blocked flag of the quadrant cell
    count = sum(c.astype(np.int8) for c in cells.values())
    out = []
    for (sx, sy), c in cells.items():
        sel = (count == 1) & c
        vx, vy = np.nonzero(sel)
        # offset away from the blocked cell: its center is at
        # (vx + sx + .5, vy + sy + .5); away = -sign(center - vertex)
        ox = -np.sign(sx + 0.5) * eps
        oy = -np.sign(sy + 0.5) * eps
        out.append(np.stack([vx + ox, vy + oy], -1))
    return np.concatenate(out, 0)


# --------------------------------------------------------------------------
# batched LOS matrix
# --------------------------------------------------------------------------

def visibility_matrix(points, blocked, samples: int = 256, tile: int = 512):
    """Pairwise LOS between points [N, 2] over a blocked raster → bool
    [N, N] on the points' device, in row tiles so the [tile, N, S] probe
    tensor stays bounded."""
    n = points.shape[0]
    out = torch.empty((n, n), dtype=torch.bool, device=points.device)
    for i in range(0, n, tile):
        rows = points[i:i + tile]
        out[i:i + tile] = line_of_sight_free(
            rows[:, None, :].expand(-1, n, 2), points[None].expand(rows.shape[0], n, 2),
            blocked, 0.0, 0.0, 1.0, samples)
    return out


# --------------------------------------------------------------------------
# exact any-angle optimum (visibility min-plus)
# --------------------------------------------------------------------------

def _visibility_solve(corners, vis, blocked, starts, goals, samples: int = 256,
                      max_hops: int = 128):
    """Batched single-source min-plus over the corner visibility graph.

    corners [C, 2], vis [C, C] bool (corner-corner LOS), starts/goals
    [B, 2] cell-center coordinates in corners' dtype. Returns lengths [B]
    (inf when unreachable within max_hops corner turns). Each lane relaxes
    until a hop lowers none of its distances by more than 1e-12, as the JAX
    `while_loop` of each vmapped scenario does."""
    b = starts.shape[0]
    c = corners.shape[0]
    direct = line_of_sight_free(starts, goals, blocked, 0.0, 0.0, 1.0, samples)
    direct_len = torch.where(direct, norm2(goals - starts), BIG)
    if c == 0:  # obstacle-free map: only the direct segment exists
        return torch.where(direct, norm2(goals - starts), torch.inf)
    d_cc = norm2(corners[:, None] - corners[None, :])
    adj = torch.where(vis, d_cc, BIG)
    adj.diagonal().fill_(0.0)

    def to_corners(p):
        p = p[:, None, :].expand(b, c, 2)
        seen = line_of_sight_free(p, corners[None].expand(b, c, 2), blocked, 0.0, 0.0, 1.0,
                                  samples)
        return torch.where(seen, norm2(corners[None] - p), BIG)

    dist, d_g = to_corners(starts), to_corners(goals)
    live = torch.ones(b, dtype=torch.bool, device=starts.device)
    hops = 0
    while hops < max_hops:
        for _ in range(min(READ_EVERY, max_hops - hops)):
            new = torch.minimum(dist, torch.amin(dist[:, :, None] + adj[None], dim=1))
            changed = torch.any(new < dist - 1e-12, dim=1)
            dist = torch.where(live[:, None], new, dist)
            hops += 1
            live = live & changed
        if not bool(live.any()):
            break
    best = torch.minimum(torch.amin(dist + d_g, dim=1), direct_len)
    return torch.where(best >= BIG, torch.inf, best)


class VisibilityPlanner:
    """Exact any-angle planner over a free raster (anya.rs capability,
    continuous-LOS semantics).

    Precomputes the ε-offset corner vertices + their LOS matrix once per
    map on `device` (default cuda; a tensor's own device), the corners in
    `dtype`; `lengths` solves a batch of (start, goal) scenarios at once.
    `samples` defaults to 2 probes per cell of the longest possible
    segment so a 1-cell wall can never be jumped.
    """

    def __init__(self, free, samples: int | None = None, tile: int = 128, eps: float = 1e-3,
                 device=None, dtype=torch.float32):
        self.free = _bool_on(free, device)
        self.blocked = ~self.free
        if samples is None:
            samples = 2 * max(self.free.shape) + 4
        self.samples = samples
        self.corners = torch.as_tensor(corner_vertices(self.free, eps=eps),
                                       device=self.free.device).to(dtype)
        self.vis = visibility_matrix(self.corners, self.blocked, samples=samples, tile=tile)

    def _centers(self, cells):
        cells = torch.as_tensor(cells, device=self.free.device)
        return cells.to(self.corners.dtype) + 0.5

    def lengths(self, starts, goals, max_hops: int = 128):
        """Optimal any-angle lengths [B] for cell-index starts/goals [B, 2]
        (converted to cell centers)."""
        return _visibility_solve(self.corners, self.vis, self.blocked, self._centers(starts),
                                 self._centers(goals), samples=self.samples, max_hops=max_hops)

    def path(self, start, goal, max_hops: int = 128):
        """Single-scenario path [K, 2] (host float64) via a host heap
        Dijkstra over the visibility graph, or None when unreachable."""
        s_dev, g_dev = self._centers(start), self._centers(goal)
        start = np.asarray(start, np.float64) + 0.5
        goal = np.asarray(goal, np.float64) + 0.5
        corners = self.corners.cpu().numpy()
        vis = self.vis.cpu().numpy()
        pts = np.concatenate([start[None], corners, goal[None]])
        n = len(pts)
        c = self.corners.shape[0]

        def seen_from(p):
            return line_of_sight_free(p.expand(c, 2), self.corners, self.blocked, 0.0, 0.0, 1.0,
                                      self.samples).cpu().numpy()

        svis, gvis = seen_from(s_dev), seen_from(g_dev)
        direct = bool(line_of_sight_free(s_dev, g_dev, self.blocked, 0.0, 0.0, 1.0,
                                         self.samples))

        def edges(i):
            if i == 0:
                nbrs = np.nonzero(svis)[0] + 1
                if direct:
                    nbrs = np.concatenate([nbrs, [n - 1]])
            elif i == n - 1:
                nbrs = np.nonzero(gvis)[0] + 1
            else:
                nbrs = np.nonzero(vis[i - 1])[0] + 1
                nbrs = nbrs[nbrs != i]
                if gvis[i - 1]:
                    nbrs = np.concatenate([nbrs, [n - 1]])
                if svis[i - 1]:
                    nbrs = np.concatenate([nbrs, [0]])
            return nbrs

        dist = np.full(n, np.inf)
        pred = np.full(n, -1, np.int64)
        dist[0] = 0.0
        heap = [(0.0, 0)]
        while heap:
            d, i = heapq.heappop(heap)
            if d > dist[i] + 1e-12:
                continue
            if i == n - 1:
                break
            for j in edges(i):
                nd = d + float(np.linalg.norm(pts[i] - pts[j]))
                if nd < dist[j] - 1e-12:
                    dist[j] = nd
                    pred[j] = i
                    heapq.heappush(heap, (nd, j))
        if not np.isfinite(dist[n - 1]):
            return None
        seq = [n - 1]
        while seq[-1] != 0:
            seq.append(int(pred[seq[-1]]))
        seq.reverse()
        return pts[seq]


def dijkstra_visibility_oracle(free, start, goal, samples: int = 256, device=None,
                               dtype=torch.float32):
    """Independent host-side exact any-angle length: heap Dijkstra over the
    full visibility graph of corners + endpoints (certifies
    `VisibilityPlanner.lengths`)."""
    planner = VisibilityPlanner(free, samples=samples, device=device, dtype=dtype)
    path = planner.path(np.asarray(start), np.asarray(goal))
    if path is None:
        return math.inf
    return float(np.sum(np.linalg.norm(np.diff(path, axis=0), axis=-1)))


# --------------------------------------------------------------------------
# Theta*-equivalent LOS-relaxed wavefront
# --------------------------------------------------------------------------

_MOTIONS = (
    (1, 0, 1.0), (0, 1, 1.0), (-1, 0, 1.0), (0, -1, 1.0),
    (-1, -1, SQRT2), (-1, 1, SQRT2), (1, -1, SQRT2), (1, 1, SQRT2),
)


def theta_wavefront_costs(free, goal_idx, iters: int = 512, samples: int = 160, block: int = 4,
                          device=None, dtype=torch.float32):
    """Any-angle cost field by LOS-relaxed wavefront (Theta* path-2 rule).

    free [W, H] bool (host data goes to `device`, default cuda); goal_idx
    host integers. Returns (g [W, H], parent [W, H, 2]) in `dtype`. Each
    sweep relaxes every cell from its 8 neighbors with BOTH rules:
      path-1: g[u] + step_cost           (parent ← u)
      path-2: g[p] + ‖p − v‖  if LOS(p, v), p = parent[u]   (parent ← p)
    Segments longer than (samples − 1)/2 cells are rejected so a thin wall
    is never jumped. Blocks of `block` sweeps run until one lowers no cell
    by more than 1e-9 or `iters` sweeps have run; one read a block.
    """
    free = _bool_on(free, device)
    dev = free.device
    w, h = free.shape
    blocked = ~free
    gx = torch.arange(w, device=dev)[:, None].expand(w, h)
    gy = torch.arange(h, device=dev)[None, :].expand(w, h)
    centers = torch.stack([gx, gy], -1).to(dtype) + 0.5
    gx0, gy0 = int(goal_idx[0]), int(goal_idx[1])

    g = torch.full((w, h), BIG, dtype=dtype, device=dev)
    g[gx0, gy0] = 0.0
    g = torch.where(free, g, BIG)
    parent = torch.empty((w, h, 2), dtype=dtype, device=dev)
    parent[..., 0], parent[..., 1] = gx0 + 0.5, gy0 + 0.5

    moves = []
    for dx, dy, c in _MOTIONS:
        m = free & _shift(free, dx, dy, False)
        if dx != 0 and dy != 0:
            m = m & _shift(free, dx, 0, False) & _shift(free, 0, dy, False)
        u_xy = torch.stack([gx + dx, gy + dy], -1).to(dtype) + 0.5
        moves.append((dx, dy, c, m, u_xy))
    max_seg = (samples - 1) / 2

    def sweep(g, parent):
        best_g, best_parent = g, parent
        for dx, dy, c, m, u_xy in moves:
            cand1 = torch.where(m, _shift(g, dx, dy, BIG) + c, BIG)
            px = _shift(parent[..., 0], dx, dy, 0.0)
            py = _shift(parent[..., 1], dx, dy, 0.0)
            p_xy = torch.stack([px, py], -1)
            gp_x = (px - 0.5).to(torch.int64).clamp(0, w - 1)
            gp_y = (py - 0.5).to(torch.int64).clamp(0, h - 1)
            gp = g[gp_x, gp_y]
            seg = norm2(p_xy - centers)
            los = line_of_sight_free(p_xy, centers, blocked, 0.0, 0.0, 1.0, samples)
            cand2 = torch.where(m & los & (seg <= max_seg), gp + seg, BIG)
            take2 = cand2 <= cand1
            cand = torch.where(take2, cand2, cand1)
            cand_parent = torch.where(take2[..., None], p_xy, u_xy)
            better = cand < best_g
            best_g = torch.where(better, cand, best_g)
            best_parent = torch.where(better[..., None], cand_parent, best_parent)
        return best_g, best_parent

    it = 0
    while it < iters:
        new_g, new_p = g, parent
        for _ in range(block):
            new_g, new_p = sweep(new_g, new_p)
        changed = bool(torch.any(new_g < g - 1e-9))
        g, parent, it = new_g, new_p, it + block
        if not changed:
            break
    return torch.where(g >= BIG, torch.inf, g), parent
