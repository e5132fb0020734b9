"""Grid planning as batched wavefront (min-plus stencil) relaxation.

The port of rust_robotics_tpu/planning/wavefront.py. Reference surface: the
heap-based best-first grid planners of crates/rust_robotics_planning
(A* a_star.rs:93-235, Dijkstra, ...; 8-connected motion model grid.rs:29-44
with the no-corner-cutting diagonal rule grid.rs:206-236).

Search is iterated Bellman-Ford relaxation over the occupancy raster: the
cost-to-go field D satisfies D = min(D, shift_d(D) + c_d) over the motion
directions, and its fixpoint is the Dijkstra/A* optimal cost at every
reachable cell. The sweeps run in `ops/wavefront_sweep.py`: kernel B2
(`csrc/wavefront_sweep.cu`, one launch per call) on CUDA tensors, its
plain twin on CPU tensors.

`extract_path` walks down the field in a fixed number of steps with masks,
so it never waits on the device inside the walk.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.core.types import Path2D
from rust_robotics_tpu_torch.ops.stencil import (  # noqa: F401 (the planners import them from here)
    MOTIONS_4,
    MOTIONS_8,
    SQRT2,
    _incoming_masks,
    _motions,
    _shift,
)
from rust_robotics_tpu_torch.planning.grid import _placement


def goal_raster(shape, goal_idx):
    """One-hot goal raster [W, H] (or [..., W, H] for goal_idx [..., 2]), on
    goal_idx's device (`cuda` for host data)."""
    goal_idx = torch.as_tensor(goal_idx, device=_placement(goal_idx, None))
    w, h = shape
    gx = torch.arange(w, device=goal_idx.device)[:, None]
    gy = torch.arange(h, device=goal_idx.device)[None, :]
    if goal_idx.ndim > 1:
        return (gx == goal_idx[..., 0:1, None]) & (gy == goal_idx[..., 1:2, None])
    return (gx == goal_idx[0]) & (gy == goal_idx[1])


def wavefront_costs(free, goals, connectivity: int = 8, corner_cutting: bool = False,
                    max_iters: int | None = None, diag_cost: float = SQRT2, block: int = 8,
                    dtype=torch.float32):
    """Optimal cost-to-go D [..., W, H] from every cell to the nearest goal,
    inf where no goal is reachable.

    free:  [..., W, H] bool traversability raster.
    goals: [..., W, H] bool goal cells (sources of the wavefront).

    Runs `block` relaxation sweeps between convergence checks. The first
    block always runs; the loop stops after a block that changed nothing or
    once `max_iters` sweeps have run, as the JAX `while_loop` does. On CUDA
    the same field comes from one kernel launch in which each map stops on
    its own, with nothing read back (`ops.wavefront_sweep.wavefront_relax`).
    """
    from rust_robotics_tpu_torch.ops.wavefront_sweep import relax_wavefront

    return relax_wavefront(free, goals, _motions(connectivity, diag_cost), corner_cutting,
                           max_iters, block, dtype)


def extract_path(costs, free, start_idx, max_len: int = 1024, connectivity: int = 8,
                 corner_cutting: bool = False, diag_cost: float = SQRT2):
    """Greedy steepest-descent walk down the cost-to-go field [W, H].

    The optimal successor of cell c is argmin_d (step_cost_d + D[c+d]); a
    loop of `max_len - 1` masked steps emits a padded index path + mask.
    Returns (indices [L, 2] int32, mask [L] bool, path_cost).
    """
    motions = _motions(connectivity, diag_cost)
    f = costs.dtype
    dev = costs.device
    big = torch.finfo(f).max / 4
    w, h = free.shape[-2], free.shape[-1]
    d = torch.where(torch.isinf(costs), big, costs).reshape(-1)
    # m[x,y]: the step (x,y) -> (x+dx,y+dy) is allowed (the same rule)
    masks = torch.stack(_incoming_masks(free, motions, corner_cutting)).reshape(len(motions), -1)
    deltas = torch.tensor([(dx, dy) for dx, dy, _ in motions], dtype=torch.int64, device=dev)
    step_costs = torch.tensor([c for _, _, c in motions], dtype=f, device=dev)

    def flat(p):  # [..., 2] -> [...] flat cell index, clipped like a JAX gather
        return p[..., 0].clamp(0, w - 1) * h + p[..., 1].clamp(0, h - 1)

    start = torch.as_tensor(start_idx, device=dev).to(torch.int64).reshape(2)
    pos = start
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    positions, moved = [start], [torch.ones(1, dtype=torch.bool, device=dev)]
    for _ in range(max_len - 1):
        here_at = flat(pos).reshape(1)
        here = d[here_at]
        at_goal = here <= 0.0
        reachable = here < big
        nbrs = pos + deltas  # [D, 2]
        d_nbrs = d[flat(nbrs)]
        valid = masks[:, here_at].reshape(-1)
        cand = torch.where(valid, step_costs + d_nbrs, big)
        best = torch.argmin(cand).reshape(1)  # the first minimum, as jnp.argmin
        descends = d_nbrs[best] < here
        move = ~done & ~at_goal & reachable & descends
        pos = torch.where(move, nbrs[best].reshape(2), pos)
        done = done | at_goal | ~move
        positions.append(pos)
        moved.append(move)
    idx = torch.stack(positions).to(torch.int32)
    mask = torch.cat(moved)
    return idx, mask, costs.reshape(-1)[flat(start)]


def plan_grid(grid, start_xy, goal_xy, connectivity=8, corner_cutting=False, max_len=2048,
              max_iters=None):
    """End-to-end single-query plan on a GridMap: world coordinates in,
    (Path2D, cost) out, on the grid's device and in its dtype.

    The counterpart of `AStarPlanner::plan(start, goal)` (a_star.rs:165):
    wavefront from the goal, then descent from the start. The path holds
    the start and goal cells, start first.
    """
    free = grid.free()
    s_idx = grid.world_to_index(start_xy)
    g_idx = grid.world_to_index(goal_xy)
    goals = goal_raster(free.shape, g_idx)
    costs = wavefront_costs(free, goals, connectivity=connectivity,
                            corner_cutting=corner_cutting, max_iters=max_iters,
                            dtype=grid.resolution.dtype)
    idx, mask, cost = extract_path(costs, free, s_idx, max_len=max_len,
                                   connectivity=connectivity, corner_cutting=corner_cutting)
    pts = grid.index_to_world(idx)
    return Path2D(pts, mask.to(pts.dtype)), cost
