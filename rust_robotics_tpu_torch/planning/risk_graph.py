"""Traversal-risk graph planning + adaptive movable-obstacle (NAMO) costmaps.

The port of rust_robotics_tpu/planning/risk_graph.py. Reference:
crates/rust_robotics_planning/src/ — traversal_risk_graph.rs: per-cell
risk channels (traversability/stability/exposure), elevation→risk
conversion (central-difference slope × slope_risk_scale, max-|Δz|
roughness × roughness_risk_scale, both clamped to max_risk, optional
blocking step height :149-189), Gaussian risk smoothing preserving blocked
topology (:189), Euclidean clearance map (:256), linear low-clearance
exposure risk (1 − c/c_min)·scale (:580), blocked-cell inflation (:328),
and a planner minimizing distance_weight·d + risk_weight·½(risk_from +
risk_to)·d (:917-922) with a risk-weight sweep helper (:427).
adaptive_costmap_namo.rs: cells labeled Free/Unknown/Static/Movable with
costs; stuck observations raise movable cost toward lethal, progress
decays it back toward the initial cost (:158-190).

Risk channels are [W, H] rasters. The planner is a weighted min-plus
stencil with per-edge costs distance·(dw + rw·½(r + shift(r))), plain
PyTorch (kernel B2 sweeps uniform step costs only); the weight sweep is one
batched relaxation over a leading axis of weights, read once a block of
sweeps as the JAX `while_loop` tests it, and its paths are walked in
lock-step, each lane its solo walk. Every product and sum rounds on its
own: the reference's jitted relaxation may fuse `dw + rw·rr` into one
multiply-add (an ulp apart, within the tests' 1e-12), and its eager run
rounds as the port does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._numeric import filled, hypot, true_div
from rust_robotics_tpu_torch.mapping.distance import compute_udf
from rust_robotics_tpu_torch.planning.grid import _bool_on, _float_on, _one_hot, _placement
from rust_robotics_tpu_torch.planning.wavefront import MOTIONS_4, MOTIONS_8, _shift

__all__ = [
    "RiskChannels",
    "terrain_risk_from_elevation",
    "smooth_terrain_risk",
    "clearance_map",
    "add_clearance_exposure_risk",
    "inflate_blocked_cells",
    "combined_cell_risk",
    "risk_wavefront_costs",
    "extract_risk_path",
    "plan_risk_path",
    "sweep_risk_weights",
    "NamoConfig",
    "namo_new",
    "namo_set_state",
    "namo_update_movable",
    "namo_to_risk",
    "NAMO_FREE",
    "NAMO_UNKNOWN",
    "NAMO_STATIC",
    "NAMO_MOVABLE",
]

BIG_FRAC = 4.0


def _big(dtype):
    return torch.finfo(dtype).max / BIG_FRAC


@dataclasses.dataclass(frozen=True)
class RiskChannels:
    """TerrainRiskCell grid as struct-of-rasters."""

    blocked: torch.Tensor  # [W, H] bool
    traversability: torch.Tensor  # [W, H]
    stability: torch.Tensor
    exposure: torch.Tensor


def terrain_risk_from_elevation(elevation, cell_size: float = 1.0,
                                slope_risk_scale: float = 8.0,
                                roughness_risk_scale: float = 10.0,
                                max_risk: float = 10.0,
                                blocking_step_height: float | None = None,
                                device=None, dtype=torch.float32):
    """terrain_risk_from_elevation_map (traversal_risk_graph.rs:149):
    slope = ‖central-difference ∇z‖ (clamped-index borders), roughness =
    max |z − z_nbr| over the 8-neighborhood. elevation [W, H] (host data
    goes to `device`, default cuda), in `dtype`."""
    z = _float_on(elevation, device, dtype)
    w, h = z.shape

    def grad(axis):
        n = z.shape[axis]
        idx = torch.arange(n, device=z.device)
        nxt_i = torch.clamp(idx + 1, max=n - 1)
        prv_i = torch.clamp(idx - 1, min=0)
        dz = z.index_select(axis, nxt_i) - z.index_select(axis, prv_i)
        dist = (nxt_i - prv_i).to(dtype) * cell_size
        dist = torch.where(dist == 0, 1.0, dist)
        shape = [1, 1]
        shape[axis] = -1
        return dz / dist.reshape(shape)

    slope = hypot(grad(0), grad(1))
    rough = torch.zeros_like(z)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nbr = _shift(z, dx, dy, torch.nan)
            diff = torch.abs(z - nbr)
            rough = torch.maximum(rough, torch.where(torch.isnan(nbr), 0.0, diff))
    trav = torch.clamp(slope * slope_risk_scale, max=max_risk)
    stab = torch.clamp(rough * roughness_risk_scale, max=max_risk)
    blocked = (rough >= blocking_step_height if blocking_step_height is not None
               else torch.zeros((w, h), dtype=torch.bool, device=z.device))
    return RiskChannels(blocked, trav, stab, torch.zeros_like(z))


def smooth_terrain_risk(risk: RiskChannels, radius_cells: int = 1, iterations: int = 1,
                        sigma_cells: float = 1.0, smooth_blocked_cells: bool = False):
    """Gaussian-disc smoothing (traversal_risk_graph.rs:189): blocked cells
    stay blocked; unless smooth_blocked_cells they keep their values but
    still contribute to neighbors. Border-normalized. The weights are
    float64 host numbers, as JAX's at x64."""
    r = radius_cells
    offs = [(dx, dy) for dx in range(-r, r + 1) for dy in range(-r, r + 1)
            if dx * dx + dy * dy <= r * r]
    wts = [math.exp(-(dx * dx + dy * dy) / (2.0 * sigma_cells * sigma_cells))
           for dx, dy in offs]

    def smooth_one(a):
        num = torch.zeros_like(a)
        den = torch.zeros_like(a)
        for (dx, dy), wt in zip(offs, wts):
            v = _shift(a, dx, dy, torch.nan)
            ok = ~torch.isnan(v)
            num = num + torch.where(ok, wt * v, 0.0)
            den = den + ok.to(a.dtype) * wt
        return num / den

    chans = (risk.traversability, risk.stability, risk.exposure)
    for _ in range(iterations):
        sm = tuple(smooth_one(c) for c in chans)
        if not smooth_blocked_cells:
            sm = tuple(torch.where(risk.blocked, c, s) for c, s in zip(chans, sm))
        chans = sm
    return RiskChannels(risk.blocked, *chans)


def clearance_map(blocked, cell_size: float = 1.0, device=None, dtype=torch.float32):
    """Exact Euclidean clearance to the nearest blocked cell (the dense EDT
    of mapping/distance.py); ∞ when nothing is blocked."""
    blocked = _bool_on(blocked, device)
    d = compute_udf(blocked, dtype) * cell_size
    return torch.where(torch.any(blocked), d, torch.inf)


def add_clearance_exposure_risk(risk: RiskChannels, cell_size: float = 1.0,
                                minimum_clearance: float = 2.0, risk_scale: float = 5.0,
                                max_risk: float = 10.0, additive: bool = True):
    """Low-clearance exposure (traversal_risk_graph.rs:296,:580):
    (1 − clearance/c_min)·scale below c_min, clamped to max_risk; blocked
    cells keep their exposure."""
    c = clearance_map(risk.blocked, cell_size, dtype=risk.exposure.dtype)
    extra = torch.where(torch.isfinite(c) & (c < minimum_clearance),
                        (1.0 - true_div(c, minimum_clearance)) * risk_scale, 0.0)
    extra = torch.clamp(extra, max=max_risk)
    new = torch.clamp(risk.exposure + extra, max=max_risk) if additive else extra
    new = torch.where(risk.blocked, risk.exposure, new)
    return RiskChannels(risk.blocked, risk.traversability, risk.stability, new)


def inflate_blocked_cells(blocked, radius_cells: int, device=None, dtype=torch.float32):
    """Circular-footprint inflation via the EDT (traversal_risk_graph.rs:372)."""
    blocked = _bool_on(blocked, device)
    return blocked | (compute_udf(blocked, dtype) <= radius_cells)


def combined_cell_risk(risk: RiskChannels, traversability_weight=1.0, stability_weight=1.0,
                       exposure_weight=1.0):
    """cell_risk (traversal_risk_graph.rs:910): weighted channel sum."""
    return (traversability_weight * risk.traversability
            + stability_weight * risk.stability
            + exposure_weight * risk.exposure)


def _weights(x, dtype, device):
    """A weight (number or sequence) as a tensor in `dtype`; (tensor, is it
    an axis)."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=dtype, device=device), False
    x = _float_on(x, device, dtype)
    return x, x.ndim > 0


def risk_wavefront_costs(free, cell_risk, goals, distance_weight=1.0, risk_weight=1.0,
                         allow_diagonal: bool = True, max_iters: int | None = None,
                         block: int = 8, device=None, dtype=torch.float32):
    """Cost-to-go under edge cost d·(dw + rw·½(r_from + r_to))
    (traversal_risk_graph.rs:917-922) — the weighted min-plus stencil.
    `distance_weight`/`risk_weight` may carry a leading batch axis (the
    weight sweep runs as one batched relaxation). free, cell_risk, goals
    [W, H] (host data goes to `device`, default cuda); in `dtype`."""
    motions = MOTIONS_8 if allow_diagonal else MOTIONS_4
    free = _bool_on(free, device)
    dev = free.device
    goals = _bool_on(goals, dev)
    risk = _float_on(cell_risk, dev, dtype)
    dw, dw_axis = _weights(distance_weight, dtype, dev)
    rw, rw_axis = _weights(risk_weight, dtype, dev)
    batched = dw_axis or rw_axis
    if batched:
        dw = dw.reshape(-1, 1, 1)
        rw = rw.reshape(-1, 1, 1)
    big = _big(dtype)
    d = torch.full(free.shape, big, dtype=dtype, device=dev).masked_fill_(goals & free, 0.0)
    if batched:
        d = d.expand((max(dw.shape[0], rw.shape[0]),) + d.shape)
    w, h = free.shape
    if max_iters is None:
        max_iters = w * h

    edges = []
    for dx, dy, c in motions:
        m = free & _shift(free, dx, dy, False)
        rr = 0.5 * (risk + _shift(risk, dx, dy, 0.0))
        edges.append((dx, dy, m, c * (dw + rw * rr)))

    def sweep(d):
        best = d
        for dx, dy, m, step in edges:
            cand = _shift(d, dx, dy, big) + step
            best = torch.minimum(best, torch.where(m, cand, big))
        return best

    it = 0
    while it < max_iters:
        new = d
        for _ in range(block):
            new = sweep(new)
        changed = bool(torch.any(new < d))
        d, it = new, it + block
        if not changed:
            break
    return torch.where(d >= big, torch.inf, d)


def _risk_walk(costs, free, risk, start_idx, dws, rws, motions, max_len):
    """Greedy descent of K fields [K, W, H] in lock-step, lane k with its
    own weights dws[k], rws[k]; (indices [K, L, 2] int32, mask [K, L])."""
    f = costs.dtype
    dev = costs.device
    big = _big(f)
    k = costs.shape[0]
    w, h = free.shape
    d = torch.where(torch.isinf(costs), big, costs).reshape(k, -1)
    risk_flat = risk.reshape(-1)
    masks = torch.stack([(free & _shift(free, dx, dy, False)).reshape(-1)
                         for dx, dy, _ in motions])  # [M, W·H]
    deltas = torch.stack([filled([dx for dx, _, _ in motions], torch.int64, dev),
                          filled([dy for _, dy, _ in motions], torch.int64, dev)], -1)
    base = filled([c for *_, c in motions], f, dev)
    dws, rws = dws[:, None], rws[:, None]
    lanes = torch.arange(k, device=dev)

    start = filled([int(start_idx[0]), int(start_idx[1])], torch.int64, dev).expand(k, 2)
    pos = start
    done = torch.zeros(k, dtype=torch.bool, device=dev)
    positions, moved = [start], [torch.ones(k, dtype=torch.bool, device=dev)]
    for _ in range(max_len - 1):
        here_at = pos[:, 0] * h + pos[:, 1]
        here = d[lanes, here_at]
        at_goal = here <= 0.0
        nbrs = pos[:, None, :] + deltas  # [K, M, 2]
        n_at = nbrs[..., 0].clamp(0, w - 1) * h + nbrs[..., 1].clamp(0, h - 1)
        d_n = torch.gather(d, 1, n_at)
        valid = masks[:, here_at].T
        er = 0.5 * (risk_flat[here_at][:, None] + risk_flat[n_at])
        stepc = base * (dws + rws * er)
        cand = torch.where(valid, stepc + d_n, big)
        best = torch.argmin(cand, dim=1)  # the first minimum, as jnp.argmin
        descends = d_n[lanes, best] < here
        move = ~done & ~at_goal & (here < big) & descends
        pos = torch.where(move[:, None], nbrs[lanes, best], pos)
        done = done | at_goal | ~move
        positions.append(pos)
        moved.append(move)
    return torch.stack(positions, 1).to(torch.int32), torch.stack(moved, 1)


def extract_risk_path(costs, free, cell_risk, start_idx, distance_weight=1.0, risk_weight=1.0,
                      allow_diagonal: bool = True, max_len: int = 1024):
    """Greedy descent consistent with the risk edge costs; start_idx host
    integers, weights host numbers. Returns (indices [L, 2], mask,
    total_cost). A walk of `max_len - 1` masked steps with nothing read
    back."""
    motions = MOTIONS_8 if allow_diagonal else MOTIONS_4
    free = free.to(torch.bool)
    risk = _float_on(cell_risk, costs.device, costs.dtype)
    weights = [filled([float(x)], costs.dtype, costs.device)
               for x in (distance_weight, risk_weight)]
    idx, mask = _risk_walk(costs[None], free, risk, start_idx, *weights, motions, max_len)
    return idx[0], mask[0], costs[int(start_idx[0]), int(start_idx[1])]


def plan_risk_path(risk: RiskChannels, start_idx, goal_idx, distance_weight=1.0,
                   risk_weight=1.0, traversability_weight=1.0, stability_weight=1.0,
                   exposure_weight=1.0, allow_diagonal=True):
    """TraversalRiskGraphPlanner::plan equivalent: min distance+risk path
    on the channels' device and dtype. Returns (indices, mask, cost)."""
    free = ~risk.blocked
    cr = combined_cell_risk(risk, traversability_weight, stability_weight, exposure_weight)
    goals = _one_hot(free.shape, goal_idx, free.device)
    costs = risk_wavefront_costs(free, cr, goals, distance_weight, risk_weight,
                                 allow_diagonal=allow_diagonal, dtype=cr.dtype)
    return extract_risk_path(costs, free, cr, start_idx, distance_weight, risk_weight,
                             allow_diagonal=allow_diagonal)


def sweep_risk_weights(risk: RiskChannels, start_idx, goal_idx, risk_weights,
                       allow_diagonal=True, **channel_weights):
    """sweep_traversal_risk_weights (traversal_risk_graph.rs:427): the same
    query under several risk weights — ONE batched relaxation over the
    weight axis, and the K paths walked in lock-step. Returns a list of
    dicts {risk_weight, cost, path_idx, path_mask}."""
    free = ~risk.blocked
    cr = combined_cell_risk(risk, **channel_weights)
    goals = _one_hot(free.shape, goal_idx, free.device)
    rw = _float_on(risk_weights, free.device, cr.dtype)
    costs = risk_wavefront_costs(free, cr, goals, 1.0, rw, allow_diagonal=allow_diagonal,
                                 dtype=cr.dtype)
    motions = MOTIONS_8 if allow_diagonal else MOTIONS_4
    idx, mask = _risk_walk(costs, free, cr, start_idx, torch.ones_like(rw), rw, motions, 1024)
    rw_host = rw.tolist()
    sx, sy = int(start_idx[0]), int(start_idx[1])
    return [{"risk_weight": rw_host[k], "cost": costs[k, sx, sy], "path_idx": idx[k],
             "path_mask": mask[k]} for k in range(len(rw_host))]


# ---------------------------------------------------------------------------
# adaptive movable-obstacle costmap (adaptive_costmap_namo.rs)

NAMO_FREE, NAMO_UNKNOWN, NAMO_STATIC, NAMO_MOVABLE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class NamoConfig:
    """AdaptiveCostmapNamoConfig defaults (adaptive_costmap_namo.rs:54)."""

    unknown_cost: float = 25.0
    movable_initial_cost: float = 20.0
    movable_cost_increment: float = 30.0
    movable_cost_decrement: float = 15.0
    static_obstacle_cost: float = 100.0
    lethal_cost: float = 100.0
    stuck_command_speed: float = 0.05
    stuck_actual_speed_ratio: float = 0.2
    progress_distance: float = 0.05


def namo_new(width: int, height: int, device=None, dtype=torch.float32):
    """All-free costmap: (states [W, H] int32, costs [W, H] in `dtype`) on
    `device` (default cuda)."""
    device = _placement(None, device)
    return (torch.zeros((width, height), dtype=torch.int32, device=device),
            torch.zeros((width, height), dtype=dtype, device=device))


def _cell_index(cells, device):
    cells = torch.as_tensor(cells, device=device).to(torch.int64)
    return cells[:, 0], cells[:, 1]


def namo_set_state(costmap, cells, state: int, cfg: NamoConfig = NamoConfig()):
    """Label cells (array [K, 2]) with a semantic state and its initial
    cost (set_cell_state)."""
    states, costs = costmap
    cost = {
        NAMO_FREE: 0.0,
        NAMO_UNKNOWN: cfg.unknown_cost,
        NAMO_STATIC: cfg.static_obstacle_cost,
        NAMO_MOVABLE: cfg.movable_initial_cost,
    }[state]
    at = _cell_index(cells, states.device)
    states = states.index_put(at, torch.full((), state, dtype=states.dtype,
                                             device=states.device))
    costs = costs.index_put(at, torch.full((), cost, dtype=costs.dtype, device=costs.device))
    return states, costs


def namo_update_movable(costmap, movable_cells, commanded_speed: float, actual_speed: float,
                        odom_delta: float, cfg: NamoConfig = NamoConfig()):
    """update_movable_costs (adaptive_costmap_namo.rs:158): stuck
    observations push movable cost toward lethal; progress decays it toward
    the initial cost. The speeds and odometry are host numbers. Returns
    (costmap, n_changed)."""
    states, costs = costmap
    stuck = (commanded_speed >= cfg.stuck_command_speed) and (
        actual_speed < cfg.stuck_actual_speed_ratio * commanded_speed)
    progressing = odom_delta >= cfg.progress_distance
    at = _cell_index(movable_cells, states.device)
    sel = states[at] == NAMO_MOVABLE
    old = costs[at]
    if stuck:
        new = torch.clamp(old + cfg.movable_cost_increment, max=cfg.lethal_cost)
    elif progressing:
        new = torch.clamp(old - cfg.movable_cost_decrement, min=cfg.movable_initial_cost)
    else:
        new = old
    new = torch.where(sel, new, old)
    costs = costs.index_put(at, new)
    changed = torch.sum(sel & (torch.abs(new - old) > 1e-9))
    return (states, costs), changed


def namo_to_risk(costmap, block_lethal_movable: bool = True, cfg: NamoConfig = NamoConfig()):
    """to_traversal_risk_cells: static obstacles are blocked; movable cells
    at lethal cost are blocked when block_lethal_movable; otherwise the
    adapted cost becomes traversability risk."""
    states, costs = costmap
    blocked = states == NAMO_STATIC
    if block_lethal_movable:
        blocked = blocked | ((states == NAMO_MOVABLE) & (costs >= cfg.lethal_cost - 1e-9))
    trav = torch.where(blocked, 0.0, costs)
    z = torch.zeros_like(trav)
    return RiskChannels(blocked, trav, z, z)
