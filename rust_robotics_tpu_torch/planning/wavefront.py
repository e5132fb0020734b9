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
    Each cell's successor and whether the walk moves there (reachable, not
    a goal, strictly descending) are a function of the cell alone, so they
    are tabulated once over the grid and the walk only looks them up. A
    walk that starts or steps off the grid reads the field as JAX's gather
    does (a negative index counts from the end, then each axis is clamped)
    and takes the step computed in full, as JAX's walk does; one read of
    the device picks that walk. start_idx [..., 2]: leading dims are walks
    over the one field in lock-step, each lane bitwise its solo walk.
    Returns (indices [..., L, 2] int32, mask [..., L] bool, path_cost [...]).
    """
    motions = _motions(connectivity, diag_cost)
    f = costs.dtype
    dev = costs.device
    big = torch.finfo(f).max / 4
    w, h = free.shape[-2], free.shape[-1]
    d = torch.where(torch.isinf(costs), big, costs).reshape(-1)
    # m[x,y]: the step (x,y) -> (x+dx,y+dy) is allowed (the same rule)
    masks = torch.stack(_incoming_masks(free, motions, corner_cutting)).reshape(len(motions), -1)
    step_costs = torch.tensor([c for _, _, c in motions], dtype=f, device=dev)
    deltas = torch.tensor([(dx, dy) for dx, dy, _ in motions], dtype=torch.int64, device=dev)

    def gathered(x, y):  # the flat cell JAX's gather reads at (x, y)
        x = torch.where(x < 0, x + w, x).clamp(0, w - 1)
        return x * h + torch.where(y < 0, y + h, y).clamp(0, h - 1)

    def choose(cell_xy, here_at):
        """Each walk's candidate steps from raw cells [..., 2] (neighbours
        clipped like JAX's), the first cheapest allowed one and whether the
        walk moves there: (best step [...], moves [...])."""
        nbrs = cell_xy[..., None, :] + deltas  # [..., D, 2]
        d_nbrs = d[nbrs[..., 0].clamp(0, w - 1) * h + nbrs[..., 1].clamp(0, h - 1)]
        cand = torch.where(masks[:, here_at].movedim(0, -1), step_costs + d_nbrs, big)
        best = torch.argmin(cand, dim=-1, keepdim=True)  # the first minimum, as jnp.argmin
        here = d[here_at]
        moves = (here > 0.0) & (here < big) & (torch.gather(d_nbrs, -1, best)[..., 0] < here)
        return best[..., 0], moves

    start = torch.as_tensor(start_idx, device=dev).to(torch.int64)
    lead = start.shape[:-1]
    start = start.reshape(-1, 2)  # [N, 2] lanes
    cells = torch.arange(w * h, device=dev)
    best, moves = choose(torch.stack([cells // h, cells % h], -1), cells)  # the tables
    succ_xy = torch.stack([cells // h, cells % h], -1) + deltas[best]
    on_grid = lambda xy: (xy >= 0).all(-1) & (xy[..., 0] < w) & (xy[..., 1] < h)  # noqa: E731
    # the table walk holds while every start is on the grid and no move leaves it
    tabled = bool(on_grid(start).all() & ~(moves & ~on_grid(succ_xy)).any())

    done = torch.zeros(start.shape[0], dtype=torch.bool, device=dev)
    moved = [torch.ones(start.shape[0], dtype=torch.bool, device=dev)]
    if tabled:
        succ = succ_xy[:, 0] * h + succ_xy[:, 1]
        pos = start[:, 0] * h + start[:, 1]
        positions = [pos]
        for _ in range(max_len - 1):
            move = ~done & moves[pos]
            pos = torch.where(move, succ[pos], pos)
            done = done | ~move
            positions.append(pos)
            moved.append(move)
        flat = torch.stack(positions, dim=-1)
        idx = torch.stack([flat // h, flat % h], dim=-1)
    else:
        pos = start
        positions = [pos]
        for _ in range(max_len - 1):
            step, moves_here = choose(pos, gathered(pos[:, 0], pos[:, 1]))
            move = ~done & moves_here
            pos = torch.where(move[:, None], pos + deltas[step], pos)
            done = done | ~move
            positions.append(pos)
            moved.append(move)
        idx = torch.stack(positions, dim=-2)
    idx = idx.to(torch.int32)
    mask = torch.stack(moved, dim=-1)
    cost = costs.reshape(-1)[gathered(start[:, 0], start[:, 1])]
    return idx.reshape(lead + idx.shape[-2:]), mask.reshape(lead + mask.shape[-1:]), \
        cost.reshape(lead)


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
