"""MPPI terminal-value machinery: value grids, tracks, replay learning.

The port of rust_robotics_tpu/control/mppi_value.py. Reference:
crates/rust_robotics_control/src/mppi.rs — `MppiTerminalValueGrid2D`
(:362, a bilinear value raster with clamped out-of-bounds queries,
`from_goal_distance` :386), `MppiWaypointTrack2D` (:505, polyline
projection/progress + `terminal_value_grid` :605), the TD-style updater
(:672, visited cells toward the discounted cost-to-go, :1506), the FIFO
replay buffer (:715) and the value-augmented terminal cost (:1114).

The grid is a [W, H] tensor, so a lookup is a batched gather + bilinear
blend over all rollout endpoints at once; the replay buffer is a
fixed-capacity masked ring (its count and head stay on the device). A
rollout's visits update the grid one after another, in order, so that
repeated cells compose as in the reference. A wavefront cost-to-go field
(planning/wavefront.py) plugs in as an obstacle-aware terminal value.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import hypot, norm2
from rust_robotics_tpu_torch.control._small import as_float, at, rsum, take, take_rows


# ---------------------------------------------------------------------------
# terminal value grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TerminalValueGrid:
    """MppiTerminalValueGrid2D analog (mppi.rs:362-493)."""

    origin: Any      # [2]
    resolution: Any  # 0-d tensor
    values: Any      # [W, H]


def _axes(origin, width, height, resolution):
    f, dev = origin.dtype, origin.device
    gx = origin[0] + torch.arange(width, dtype=f, device=dev) * resolution
    gy = origin[1] + torch.arange(height, dtype=f, device=dev) * resolution
    return gx, gy


def grid_from_goal_distance(width, height, origin, resolution, goal, dtype=None, device=None):
    """Euclidean goal-distance value grid (mppi.rs:386-410), on `device`
    (default cuda; origin's own when a tensor), in `dtype` (default
    torch's)."""
    origin = as_float(origin, dtype, device)
    goal = as_float(goal, origin.dtype, origin.device)
    gx, gy = _axes(origin, width, height, resolution)
    d = hypot(gx[:, None] - goal[0], gy[None, :] - goal[1])
    return TerminalValueGrid(origin, torch.full((), resolution, dtype=origin.dtype,
                                                device=origin.device), d)


def grid_value_at(grid: TerminalValueGrid, xy):
    """Bilinear value lookup with edge clamping (mppi.rs:416-435).
    xy [..., 2] → [...]."""
    w, h = grid.values.shape
    g = (xy - grid.origin) / grid.resolution
    gx = torch.clamp(g[..., 0], 0.0, w - 1.0)
    gy = torch.clamp(g[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    tx = gx - x0
    ty = gy - y0
    v = grid.values
    v00, v10, v01, v11 = (torch.take(v, i * h + j) for i, j in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)))
    return (v00 * (1 - tx) + v10 * tx) * (1 - ty) + (v01 * (1 - tx) + v11 * tx) * ty


def nearest_cell_indices(grid: TerminalValueGrid, xy):
    """Rounded (half to even), clamped cell index (mppi.rs:445-453).
    xy [..., 2] → [..., 2] int64."""
    w, h = grid.values.shape
    g = torch.round((xy - grid.origin) / grid.resolution)
    return torch.stack([torch.clamp(g[..., 0], 0, w - 1), torch.clamp(g[..., 1], 0, h - 1)],
                       dim=-1).to(torch.int64)


# ---------------------------------------------------------------------------
# waypoint track
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WaypointTrack:
    """MppiWaypointTrack2D analog (mppi.rs:505-643)."""

    waypoints: Any           # [N, 2]
    cumulative_lengths: Any  # [N]


def make_track(waypoints, dtype=None, device=None):
    """A track through `waypoints` [N, 2], on `device` (default cuda; a
    tensor's own), in `dtype` (default a tensor's own, else torch's)."""
    w = as_float(waypoints, dtype, device)
    seg = norm2(w[1:] - w[:-1])
    return WaypointTrack(w, torch.cat([torch.zeros(1, dtype=w.dtype, device=w.device),
                                       torch.cumsum(seg, dim=0)]))


def track_total_length(track: WaypointTrack):
    return track.cumulative_lengths[-1]


def track_project(track: WaypointTrack, xy):
    """Project xy [..., 2] onto the polyline: returns (progress [...],
    lateral_error [...], closest [..., 2]) — mppi.rs:563-598."""
    a = track.waypoints[:-1]           # [S, 2]
    ab = track.waypoints[1:] - a
    seg_len2 = torch.clamp(rsum(ab * ab, -1), min=1e-30)
    ap = xy[..., None, :] - a          # [..., S, 2]
    t = torch.clamp(rsum(ap * ab, -1) / seg_len2, 0.0, 1.0)
    closest = a + t[..., None] * ab    # [..., S, 2]
    d = norm2(xy[..., None, :] - closest)
    best = torch.argmin(d, dim=-1)     # the first minimum, like the scan loop
    bt = take(t, best)
    lateral = take(d, best)
    progress = torch.take(track.cumulative_lengths, best) + bt * torch.take(torch.sqrt(seg_len2), best)
    return progress, lateral, take_rows(closest, best)


def track_remaining_distance(track: WaypointTrack, xy):
    progress, _, _ = track_project(track, xy)
    return torch.clamp(track_total_length(track) - progress, min=0.0)


def track_terminal_value_grid(track: WaypointTrack, width, height, origin, resolution,
                              progress_weight=1.0, lateral_weight=1.0):
    """Progress/lateral terminal value raster (mppi.rs:605-642)."""
    origin = as_float(origin, track.waypoints.dtype, track.waypoints.device)
    gx, gy = _axes(origin, width, height, resolution)
    pts = torch.stack(torch.meshgrid(gx, gy, indexing="ij"), dim=-1)
    progress, lateral, _ = track_project(track, pts)
    remaining = torch.clamp(track_total_length(track) - progress, min=0.0)
    values = progress_weight * remaining + lateral_weight * lateral
    return TerminalValueGrid(origin, torch.full((), resolution, dtype=origin.dtype,
                                                device=origin.device), values)


# ---------------------------------------------------------------------------
# TD-style learning from rollouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ValueUpdateConfig:
    """MppiTerminalValueUpdateConfig2D defaults (mppi.rs:652-658)."""

    learning_rate: float = 0.25
    discount: float = 0.98

    def validate(self):
        if not (0.0 < self.learning_rate <= 1.0):
            raise ValueError("learning_rate must be in (0, 1]")
        if not (0.0 <= self.discount <= 1.0):
            raise ValueError("discount must be in [0, 1]")


def discounted_cost_to_go(stage_costs, discount):
    """v[i] = c[i] + γ·v[i+1], v[last] = c[last] (mppi.rs:1506-1514), over
    the last axis."""
    v = torch.zeros_like(stage_costs[..., 0])
    out = [None] * stage_costs.shape[-1]
    for i in range(stage_costs.shape[-1] - 1, -1, -1):
        v = stage_costs[..., i] + discount * v
        out[i] = v
    return torch.stack(out, dim=-1)


def _visit(values, cells, targets, valid, learning_rate):
    """Update `values` in place at cells [H, 2] toward targets [H], one
    visit after another; returns the |deltas| [H]."""
    deltas = []
    for i in range(targets.shape[0]):
        cx, cy = cells[i, 0:1], cells[i, 1:2]
        old = values[cx, cy]
        new = torch.clamp(old + learning_rate * (targets[i] - old), min=0.0)
        new = torch.where(valid[i], new, old)
        deltas.append(torch.abs(new - old)[0])
        values.index_put_((cx, cy), new)
    return torch.stack(deltas)


def update_grid_from_rollout(grid: TerminalValueGrid, states, stage_costs,
                             cfg: ValueUpdateConfig = ValueUpdateConfig(), valid=None):
    """One rollout's TD update of the visited cells (mppi.rs:682-713).

    states [H, n] (positions in [..., :2]), stage_costs [H]. The visits
    apply in order, so that repeated cells compose like the reference's.
    Returns (grid', report dict)."""
    targets = discounted_cost_to_go(stage_costs, cfg.discount)
    cells = nearest_cell_indices(grid, states[..., :2])
    if valid is None:
        valid = torch.ones(stage_costs.shape, dtype=torch.bool, device=stage_costs.device)
    values = grid.values.clone()
    deltas = _visit(values, cells, targets, valid, cfg.learning_rate)
    updates = torch.sum(valid)
    report = {
        "updates": updates,
        "mean_abs_delta": torch.sum(deltas) / torch.clamp(updates, min=1),
        "max_abs_delta": torch.amax(deltas),
        "start_target": targets[0],
        "terminal_target": targets[-1],
    }
    return TerminalValueGrid(grid.origin, grid.resolution, values), report


# ---------------------------------------------------------------------------
# replay buffer (fixed-capacity masked ring)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    """MppiTerminalValueReplayBuffer2D analog (mppi.rs:715-793) as a
    fixed-capacity ring."""

    states: Any       # [C, H, n]
    stage_costs: Any  # [C, H]
    count: Any        # 0-d int64 (≤ C)
    head: Any         # 0-d int64, the next write slot


def make_replay_buffer(capacity, horizon, state_dim, dtype=None, device=None):
    """An empty ring on `device` (default cuda), in `dtype` (default
    torch's)."""
    if capacity <= 0:
        raise ValueError("replay capacity must be positive")
    device = resolve_device(device)
    f = dtype or torch.get_default_dtype()
    return ReplayBuffer(
        states=torch.zeros((capacity, horizon, state_dim), dtype=f, device=device),
        stage_costs=torch.zeros((capacity, horizon), dtype=f, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        head=torch.zeros((), dtype=torch.int64, device=device),
    )


def replay_push(buf: ReplayBuffer, states, stage_costs):
    """FIFO push: overwrite the oldest slot when full (mppi.rs:754-761)."""
    c = buf.states.shape[0]
    here = torch.arange(c, device=buf.head.device) == buf.head
    return ReplayBuffer(
        states=torch.where(here[:, None, None], states, buf.states),
        stage_costs=torch.where(here[:, None], stage_costs, buf.stage_costs),
        count=torch.clamp(buf.count + 1, max=c),
        head=(buf.head + 1) % c,
    )


def replay_update_grid(buf: ReplayBuffer, grid: TerminalValueGrid,
                       cfg: ValueUpdateConfig = ValueUpdateConfig()):
    """Replay every stored rollout, oldest first (mppi.rs:763-793)."""
    c = buf.states.shape[0]
    slots = torch.arange(c, device=buf.head.device)
    order = (buf.head - buf.count + slots) % c  # from the oldest slot
    live = slots < buf.count
    values = grid.values.clone()
    means, maxs = [], []
    for i in range(c):
        states, costs = at(buf.states, order[i]), at(buf.stage_costs, order[i])
        targets = discounted_cost_to_go(costs, cfg.discount)
        cells = nearest_cell_indices(grid, states[..., :2])
        deltas = _visit(values, cells, targets, live[i].expand(costs.shape), cfg.learning_rate)
        updates = torch.where(live[i], costs.shape[0], 0)
        means.append(torch.sum(deltas) / torch.clamp(updates, min=1))
        maxs.append(torch.amax(deltas))
    means, maxs = torch.stack(means), torch.stack(maxs)
    zero = torch.zeros_like(means)
    report = {
        "rollouts": buf.count,
        "mean_abs_delta": torch.sum(torch.where(live, means, zero)) / torch.clamp(buf.count, min=1),
        "max_abs_delta": torch.amax(torch.where(live, maxs, zero)),
    }
    return TerminalValueGrid(grid.origin, grid.resolution, values), report


# ---------------------------------------------------------------------------
# value-augmented MPPI terminal cost
# ---------------------------------------------------------------------------

def make_value_terminal_cost(grid: TerminalValueGrid, weight=1.0, base_terminal=None):
    """terminal_value_cost analog (mppi.rs:1114-1122): the interpolated
    grid value at the rollout endpoint, plus an optional base terminal
    cost. Batched over rollout endpoints."""

    def terminal(state):
        v = weight * grid_value_at(grid, state[..., :2])
        if base_terminal is not None:
            v = v + base_terminal(state)
        return v

    return terminal
