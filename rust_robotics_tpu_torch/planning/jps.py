"""Jump Point Search with real jump rules, as JPS+ distance tables.

The port of rust_robotics_tpu/planning/jps.py. Reference surface:
crates/rust_robotics_planning/src/jps.rs (Harabor & Grastien 2011 online
graph pruning; jump/forced-neighbor rules under the no-corner-cutting
diagonal convention of grid.rs:206-236, the same convention
`planning/wavefront.py` encodes).

The recursive `jump()` + BinaryHeap becomes the JPS+ formulation (Harabor
& Grastien 2014): per-direction jump distance tables, each a directional
scan (a loop over one axis with an [H]-vector carry), then min-plus
relaxation over the induced sparse jump graph (≤ 8 successors per cell,
scatter-min, which is order-free). The jump graph preserves optimal grid
distances, so costs match the wavefront optimum exactly while relaxing
far fewer edges.

Strict-grid jump rules implemented (no corner cutting ⇒ diagonal moves
have no forced neighbors):
- cardinal travel d, perpendicular p: cell x is a jump point iff
  free(x+p) ∧ blocked(x−d+p);
- straight jumps stop at jump points or the goal;
- diagonal jumps stop where either component cardinal jump terminates
  (at a jump point or the goal), stepping only through corner-legal
  diagonal moves.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.planning.grid import _placement
from rust_robotics_tpu_torch.planning.wavefront import SQRT2, _shift

__all__ = ["jump_point_mask", "jump_distances", "jps_costs", "jps_plan"]

_BIG = 1e9


def jump_point_mask(free, dx, dy):
    """Cells with a forced neighbor for cardinal travel (dx, dy)
    (jps.rs forced-neighbor rule, strict-grid form)."""
    assert (dx == 0) != (dy == 0), "cardinal directions only"
    perps = ((dy, dx), (-dy, -dx))
    m = torch.zeros_like(free)
    for px, py in perps:
        side_open = _shift(free, px, py, False)
        behind_side_blocked = ~_shift(free, px - dx, py - dy, False)
        m = m | (side_open & behind_side_blocked)
    return m & free


def _dir_scan(vstep, snext, dx, dy, dtype):
    """dist[x,y] = #steps along (dx,dy) until a stop cell, else BIG.

    vstep[x,y]: the step (x,y)->(x+dx,y+dy) is legal.
    snext[x,y]: the cell (x+dx,y+dy) is a stop cell.
    Recurrence dist = vstep ? (snext ? 1 : 1 + dist∘shift) : BIG — one
    loop along the x-axis with the y-offset folded into the carry.
    """
    if dx == 0:  # canonicalize: scan axis is always axis 0
        return _dir_scan(vstep.T, snext.T, dy, dx, dtype).T
    flip = dx > 0
    v = torch.flip(vstep, (0,)) if flip else vstep
    s = torch.flip(snext, (0,)) if flip else snext
    h = v.shape[1]
    pad = torch.full((abs(dy),), _BIG, dtype=dtype, device=v.device)

    def shift_row(row):
        if dy == 0:
            return row
        if dy > 0:
            return torch.cat([row[dy:], pad])
        return torch.cat([pad, row[:dy]])

    carry = torch.full((h,), _BIG, dtype=dtype, device=v.device)
    rows = []
    for vr, sr in zip(v, s):
        nxt = shift_row(carry)
        d = torch.where(vr, torch.where(sr, 1.0, 1.0 + nxt), _BIG)
        carry = torch.clamp(d, max=_BIG)
        rows.append(carry)
    dist = torch.stack(rows)
    return torch.flip(dist, (0,)) if flip else dist


def jump_distances(free, goal_mask, dtype=torch.float32):
    """All eight JPS+ jump-distance tables for one query.

    Returns dict {(dx, dy): dist [W,H]} where dist is the number of steps
    to the segment's stop cell (jump point / goal), BIG if the ray hits a
    wall first. Goal-aware: the goal is a stop cell for every direction
    (jps.rs jump(): `if node == goal { return Some(node) }`).
    """
    free = free.to(torch.bool)
    cardinals = ((1, 0), (-1, 0), (0, 1), (0, -1))
    dist = {}
    for dx, dy in cardinals:
        vstep = free & _shift(free, dx, dy, False)
        stop = jump_point_mask(free, dx, dy) | goal_mask
        snext = _shift(stop, dx, dy, False)
        dist[(dx, dy)] = _dir_scan(vstep, snext, dx, dy, dtype)
    for dx in (-1, 1):
        for dy in (-1, 1):
            vstep = (free & _shift(free, dx, dy, False) & _shift(free, dx, 0, False)
                     & _shift(free, 0, dy, False))
            # stop where a component straight jump terminates, or goal
            stop = (dist[(dx, 0)] < _BIG) | (dist[(0, dy)] < _BIG) | goal_mask
            snext = _shift(stop, dx, dy, False)
            dist[(dx, dy)] = _dir_scan(vstep, snext, dx, dy, dtype)
    return dist


def _jump_graph(free, start_idx, goal_idx, dtype):
    """Destination flat indices + edge costs of the jump graph, [8, W, H]."""
    w, h = free.shape
    dev = free.device
    gx = torch.arange(w, device=dev)[:, None].expand(w, h)
    gy = torch.arange(h, device=dev)[None, :].expand(w, h)
    goal_mask = (gx == goal_idx[0]) & (gy == goal_idx[1])
    dists = jump_distances(free, goal_mask, dtype)
    dirs = list(dists.keys())
    steps = torch.stack([dists[d] for d in dirs])
    valid = steps < _BIG
    si = steps.to(torch.int64)
    tx = torch.stack([gx + si[k] * dx for k, (dx, _) in enumerate(dirs)]).where(valid, 0)
    ty = torch.stack([gy + si[k] * dy for k, (_, dy) in enumerate(dirs)]).where(valid, 0)
    edge_cost = torch.stack([steps[k] * (1.0 if 0 in d else SQRT2) for k, d in enumerate(dirs)])
    edge_cost = edge_cost.where(valid, torch.inf)
    d0 = torch.full((w, h), torch.inf, dtype=dtype, device=dev)
    d0[start_idx[0], start_idx[1]] = 0.0
    return tx * h + ty, edge_cost, torch.sum(valid), d0


def _sweep(d, target, edge_cost):
    cand = d[None] + edge_cost  # [8, W, H]
    nd = d.reshape(-1).scatter_reduce(0, target.reshape(-1), cand.reshape(-1), "amin")
    nd = nd.reshape(d.shape)
    return nd, torch.any(nd < d)


def jps_costs(free, start_idx, goal_idx, max_sweeps: int = 4096, dtype=torch.float32):
    """Optimal start->goal cost via min-plus relaxation of the jump graph.

    free [W, H] bool tensor; start_idx, goal_idx (ix, iy) host integers.
    Returns (cost, costs [W,H] over jump-graph cells, stats dict with
    jump_edges / cell_edges / sweeps). costs is +inf off the jump graph —
    cost parity with `wavefront_costs` holds at the goal (and at every
    jump point on some optimal path). The convergence loop runs on the
    host and reads one flag a sweep, as the JAX package's does.
    """
    free = free.to(torch.bool)
    w, h = free.shape
    start_idx = tuple(int(v) for v in start_idx)
    goal_idx = tuple(int(v) for v in goal_idx)
    target, edge_cost, jump_edges, d = _jump_graph(free, start_idx, goal_idx, dtype)
    sweeps = 0
    for _ in range(max_sweeps):
        d, changed = _sweep(d, target, edge_cost)
        sweeps += 1
        if not bool(changed):
            break
    stats = {"jump_edges": jump_edges, "cell_edges": 8 * w * h, "sweeps": sweeps}
    return d[goal_idx[0], goal_idx[1]], d, stats


def jps_plan(free, start, goal, device=None, dtype=torch.float32):
    """Cost + stats convenience wrapper (jps.rs `JPSPlanner::plan`
    observable contract: feasibility + octile-optimal path cost). A host
    raster goes to `device` (default cuda); a tensor keeps its device."""
    device = _placement(free, device)
    free = torch.as_tensor(free, device=device).to(torch.bool)
    cost, _, stats = jps_costs(free, start, goal, dtype=dtype)
    cost = float(cost)
    jump_edges = int(stats["jump_edges"])
    return {
        "found": bool(cost < float("inf")),
        "cost": cost,
        "jump_edges": jump_edges,
        "cell_edges": stats["cell_edges"],
        "edge_fraction": float(jump_edges) / float(stats["cell_edges"]),
        "sweeps": stats["sweeps"],
    }
