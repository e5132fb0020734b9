"""Potential field navigation + flow fields + coverage planners.

The port of rust_robotics_tpu/planning/fields.py. Reference
(crates/rust_robotics_planning/src/): potential_field.rs (attractive +
repulsive raster, gradient descent), flow_field.rs (goal-distance
integration field + descent, multi-agent capable),
grid_based_sweep_cpp.rs (boustrophedon sweep).

Potential and flow fields are rasters: the attractive/repulsive terms
evaluate dense [W, H]; the flow field is the wavefront cost-to-go, one
launch of kernel B2 on the card (`planning/wavefront.py`); descent is the
wavefront `extract_path`; boustrophedon sweeping is a per-column order.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import sqrt_rn
from rust_robotics_tpu_torch.planning.grid import _bool_on
from rust_robotics_tpu_torch.planning.wavefront import extract_path, wavefront_costs


def potential_field(free, goal_idx, obstacle_gain=100.0, attract_gain=5.0, repulse_radius=5.0,
                    device=None, dtype=torch.float32):
    """Attractive (distance-to-goal) + repulsive (1/d to obstacles within
    radius) potential raster (potential_field.rs). free [W, H] bool (host
    data goes to `device`, default cuda), goal_idx host integers. Returns
    [W, H] in `dtype`."""
    # imported here: mapping/ imports nlls/, which imports this package
    from rust_robotics_tpu_torch.mapping.distance import compute_udf

    free = _bool_on(free, device)
    w, h = free.shape
    gx = torch.arange(w, device=free.device)[:, None].expand(w, h)
    gy = torch.arange(h, device=free.device)[None, :].expand(w, h)
    dx = (gx - int(goal_idx[0])).to(dtype)
    dy = (gy - int(goal_idx[1])).to(dtype)
    d_goal = sqrt_rn(dx ** 2 + dy ** 2)
    attract = 0.5 * attract_gain * d_goal
    d_obs = compute_udf(~free, dtype)
    near = d_obs <= repulse_radius
    safe = torch.clamp(d_obs, min=0.3)
    repulse = torch.where(
        near, 0.5 * obstacle_gain * (1.0 / safe - 1.0 / repulse_radius) ** 2, 0.0)
    return attract + repulse


def descend_field(field, free, start_idx, max_len=1024):
    """Greedy 8-neighbor descent over an arbitrary potential raster."""
    return extract_path(field, free, start_idx, max_len=max_len)


def flow_field(free, goals, device=None, dtype=torch.float32):
    """Goal-distance integration field (flow_field.rs): the wavefront
    cost-to-go is exactly the integration field; descent directions follow
    its gradient. Every agent shares ONE field; free and goals may carry a
    leading batch of maps. One B2 launch on the card."""
    free = _bool_on(free, device)
    return wavefront_costs(free, _bool_on(goals, free.device), dtype=dtype)


def boustrophedon_sweep(free, col_axis: int = 0, device=None):
    """Boustrophedon coverage order (grid_based_sweep_cpp.rs): visit free
    cells column-by-column, alternating direction. Returns (cells [N, 2]
    int64 ordering, mask [N]) with N = W·H capacity."""
    free = _bool_on(free, device)
    w, h = free.shape
    rows = torch.arange(h, device=free.device)
    cols = torch.arange(w, device=free.device)[:, None]
    order = torch.where(cols % 2 == 0, rows, h - 1 - rows)  # [W, H]
    cells = torch.stack([cols.expand(w, h), order], dim=-1)
    valid = torch.gather(free, 1, order)
    return cells.reshape(-1, 2), valid.reshape(-1)


def coverage_ratio(visited_mask, free, device=None, dtype=torch.float32):
    """Fraction of free cells covered (coverage acceptance metric), a 0-d
    tensor in `dtype` on visited_mask's device (host data: `device`,
    default cuda)."""
    visited = _bool_on(visited_mask, device)
    free = _bool_on(free, visited.device)
    free_count = torch.clamp(torch.sum(free), min=1)
    return torch.sum(visited & free).to(dtype) / free_count.to(dtype)
