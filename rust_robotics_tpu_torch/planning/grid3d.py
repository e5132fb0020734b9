"""3D voxel grid planning: 6/26-connected wavefront relaxation.

The port of rust_robotics_tpu/planning/grid3d.py. Reference:
crates/rust_robotics_planning/src/grid_a_star_3d.rs (A* over a voxel grid
with 6- or 26-connected motion, BinaryHeap + HashMap closed set).

The same min-plus stencil as `planning/wavefront.py` lifted to 3 axes:
each sweep is 6 (or 26) shifted adds + a min over a [..., W, H, D]
raster; the convergence flag is read once a block of `block` sweeps, as
the JAX `while_loop` tests it. Path extraction is greedy steepest descent,
a loop of masked steps with nothing read back, as in 2D.
"""

from __future__ import annotations

import itertools
import math

import torch

from rust_robotics_tpu_torch.planning.grid import _placement

__all__ = ["wavefront_costs_3d", "extract_path_3d", "plan_grid_3d"]


def _motions_3d(connectivity: int):
    if connectivity == 6:
        deltas = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    else:  # 26-connected
        deltas = [d for d in itertools.product((-1, 0, 1), repeat=3) if d != (0, 0, 0)]
    return tuple((dx, dy, dz, math.sqrt(dx * dx + dy * dy + dz * dz)) for dx, dy, dz in deltas)


def _span(n, k):
    """(destination slice, source slice) along an axis of n for offset k."""
    return slice(max(0, -k), n - max(0, k)), slice(max(0, k), n + min(0, k))


def _shift3(a, dx, dy, dz, fill):
    """shifted[x, y, z] = a[x+dx, y+dy, z+dz], out-of-bounds -> fill."""
    out = torch.full_like(a, fill)
    (ox, ix), (oy, iy), (oz, iz) = (_span(n, k) for n, k in zip(a.shape[-3:], (dx, dy, dz)))
    out[..., ox, oy, oz] = a[..., ix, iy, iz]
    return out


def wavefront_costs_3d(free, goals, connectivity: int = 26, max_iters: int | None = None,
                       block: int = 8, dtype=torch.float32):
    """Optimal cost-to-go over a [..., W, H, D] voxel raster
    (grid_a_star_3d.rs cost parity: Euclidean step costs 1/√2/√3) in
    `dtype`. Both move endpoints must be free (the reference's 3D model has
    no corner rule)."""
    motions = _motions_3d(connectivity)
    free = free.to(torch.bool)
    big = torch.finfo(dtype).max / 4
    d = torch.full(free.shape, big, dtype=dtype, device=free.device).where(~(goals & free), 0.0)
    if max_iters is None:
        max_iters = free.shape[-3] * free.shape[-2] * free.shape[-1]
    masks = [free & _shift3(free, dx, dy, dz, False) for dx, dy, dz, _ in motions]

    def sweep(d):
        best = d
        for (dx, dy, dz, c), m in zip(motions, masks):
            best = torch.minimum(best, (_shift3(d, dx, dy, dz, big) + c).where(m, big))
        return best

    it, changed = 0, True
    while changed and it < max_iters:
        new = d
        for _ in range(block):
            new = sweep(new)
        changed = bool(torch.any(new < d))
        d, it = new, it + block
    return d.where(d < big, torch.inf)


def extract_path_3d(costs, free, start_idx, max_len: int = 512, connectivity: int = 26):
    """Greedy steepest descent down the 3D cost field; returns
    (indices [L, 3] int32, mask [L], path_cost)."""
    motions = _motions_3d(connectivity)
    f = costs.dtype
    dev = costs.device
    big = torch.finfo(f).max / 4
    w, h, dd = free.shape
    d = costs.where(~torch.isinf(costs), big).reshape(-1)
    masks = torch.stack([free & _shift3(free, dx, dy, dz, False)
                         for dx, dy, dz, _ in motions]).reshape(len(motions), -1)
    deltas = torch.tensor([(dx, dy, dz) for dx, dy, dz, _ in motions], dtype=torch.int64,
                          device=dev)
    step_costs = torch.tensor([c for *_, c in motions], dtype=f, device=dev)

    def flat(p):  # [..., 3] -> [...] flat voxel index, clipped like a JAX gather
        return (p[..., 0].clamp(0, w - 1) * h + p[..., 1].clamp(0, h - 1)) * dd \
            + p[..., 2].clamp(0, dd - 1)

    start = torch.as_tensor(start_idx, device=dev).to(torch.int64).reshape(3)
    pos = start
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    positions, moved = [start], [torch.ones(1, dtype=torch.bool, device=dev)]
    for _ in range(max_len - 1):
        here_at = flat(pos).reshape(1)
        here = d[here_at]
        at_goal = here <= 0.0
        nbrs = pos + deltas  # [D, 3]
        d_nbrs = d[flat(nbrs)]
        valid = masks[:, here_at].reshape(-1)
        cand = torch.where(valid, step_costs + d_nbrs, big)
        best = torch.argmin(cand).reshape(1)  # the first minimum, as jnp.argmin
        descends = d_nbrs[best] < here
        move = ~done & ~at_goal & (here < big) & descends
        pos = torch.where(move, nbrs[best].reshape(3), pos)
        done = done | at_goal | ~move
        positions.append(pos)
        moved.append(move)
    idx = torch.stack(positions).to(torch.int32)
    return idx, torch.cat(moved), costs.reshape(-1)[flat(start)]


def plan_grid_3d(free, start_idx, goal_idx, connectivity: int = 26, max_len: int = 512,
                 device=None, dtype=torch.float32):
    """Single-query 3D plan: wavefront from the goal voxel, descend from the
    start. Returns (indices [L, 3], mask, cost). A host raster goes to
    `device` (default cuda); a tensor keeps its device. The indices are
    host integers."""
    device = _placement(free, device)
    free = torch.as_tensor(free, device=device).to(torch.bool)
    w, h, d = free.shape
    gx = torch.arange(w, device=device)[:, None, None]
    gy = torch.arange(h, device=device)[None, :, None]
    gz = torch.arange(d, device=device)[None, None, :]
    goals = (gx == int(goal_idx[0])) & (gy == int(goal_idx[1])) & (gz == int(goal_idx[2]))
    costs = wavefront_costs_3d(free, goals, connectivity=connectivity, dtype=dtype)
    return extract_path_3d(costs, free, start_idx, max_len=max_len, connectivity=connectivity)
