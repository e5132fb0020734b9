"""Incremental / anytime / bounded grid search on the wavefront engine:
D* / D* Lite / LPA* repair, ARA* anytime schedule, IDA* / fringe
threshold deepening, beam-limited relaxation.

The port of rust_robotics_tpu/planning/incremental.py. Reference:
crates/rust_robotics_planning/src/ — d_star.rs, d_star_lite.rs,
lpa_star.rs (incremental repair of g-values after edge-cost changes),
ara_star.rs (anytime repair with inflated heuristic, monotone cost
improvement), ida_star.rs (iterative-deepening f-bound, per-iteration
stats in plan_with_report), fringe_search.rs (threshold sweep with a cached
frontier), a_star_variants.rs (beam/dynamic/iterative variants).

Priority queues with lazy keys don't vectorize, but every planner in this
family has an observable contract on the value field / returned path, not
on expansion order:

- LPA*/D* Lite repair: after map edits, re-derive the exact cost field
  while reusing unaffected values. A RAISE phase iteratively clears values
  whose downhill support vanished, then a LOWER phase re-relaxes from the
  warm field.
- ARA*: anytime loop with monotone nonincreasing path cost and a final
  optimal solution; per-stage suboptimality bound reported from the
  current field vs the admissible heuristic.
- IDA*: f-bounded relaxation (cells with g + h > threshold stay pruned);
  the next threshold is the min f over pruned cells, iterated until the
  goal is reached.

The fixpoint loops run on the host. `relax_with_stats` reads its
`changed` flag once a block of `block` sweeps, as the JAX `while_loop`
tests it. The one-sweep loops (RAISE, IDA*'s bounded relaxation, the beam)
run `READ_EVERY` sweeps between reads, keeping each sweep's flag on the
device: a sweep that changes nothing is a fixpoint, so the sweeps after it
change nothing either, and the count is the JAX count, up to the first
sweep that changed nothing. Stats counts are Python ints.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.planning.grid import _one_hot
from rust_robotics_tpu_torch.planning.wavefront import (
    MOTIONS_4,
    MOTIONS_8,
    SQRT2,
    _incoming_masks,
    _shift,
)

__all__ = [
    "relax_with_stats",
    "repair_costs",
    "dstar_lite_replan",
    "lpa_star_replan",
    "dstar_replan",
    "ara_star_plan",
    "ida_star_costs",
    "fringe_search_costs",
    "beam_search_costs",
    "octile_heuristic",
]

# one-sweep fixpoint loops read their flags once every this many sweeps
READ_EVERY = 8


def _motions(connectivity, diag_cost=SQRT2):
    m = MOTIONS_8 if connectivity == 8 else MOTIONS_4
    return tuple((dx, dy, diag_cost if (dx != 0 and dy != 0) else c) for dx, dy, c in m)


def _big(dtype):
    return torch.finfo(dtype).max / 4


def _best_incoming(d, motions, masks, big, init):
    """min(init, min over motions of (shifted d + step cost) where allowed)."""
    best = init
    for (dx, dy, c), m in zip(motions, masks):
        best = torch.minimum(best, (_shift(d, dx, dy, big) + c).where(m, big))
    return best


def _fixpoint(step, state, max_iters):
    """Run `step(state) -> (state, changed)` until a step changes nothing or
    `max_iters` steps have run; returns (state, steps as the JAX loop counts
    them). Reads the flags once every READ_EVERY steps."""
    it = 0
    while it < max_iters:
        n = min(READ_EVERY, max_iters - it)
        flags = []
        for _ in range(n):
            state, changed = step(state)
            flags.append(changed)
        unchanged = (~torch.stack(flags)).nonzero()  # one read
        if len(unchanged):
            return state, it + int(unchanged[0, 0]) + 1
        it += n
    return state, it


def octile_heuristic(shape, target_idx, connectivity: int = 8, device=None,
                     dtype=torch.float32):
    """Admissible octile (8-conn) / Manhattan (4-conn) distance raster to
    `target_idx` (host integers) — the reference's euclidean-weighted
    heuristic analog (a_star.rs:189), exact for unobstructed 8-connected
    grids. On `device` (default cuda) in `dtype`."""
    device = resolve_device(device)
    w, h = shape
    gx = torch.arange(w, device=device)[:, None].expand(w, h)
    gy = torch.arange(h, device=device)[None, :].expand(w, h)
    dx = torch.abs(gx - int(target_idx[0])).to(dtype)
    dy = torch.abs(gy - int(target_idx[1])).to(dtype)
    if connectivity == 8:
        return torch.maximum(dx, dy) + (SQRT2 - 1.0) * torch.minimum(dx, dy)
    return dx + dy


def relax_with_stats(d0, free, sources, connectivity: int = 8, corner_cutting: bool = False,
                     max_sweeps: int | None = None, block: int = 8):
    """Min-plus relaxation from a warm-start field `d0` [..., W, H], in its
    dtype; sources are pinned to 0. Returns (costs, sweeps_used) — the sweep
    count is the stats hook the incremental planners report. The batch of
    maps stops together, when no map changed."""
    motions = _motions(connectivity)
    free = free.to(torch.bool)
    masks = _incoming_masks(free, motions, corner_cutting)
    big = _big(d0.dtype)
    pinned = sources & free
    d = d0.where(~torch.isinf(d0), big).where(~pinned, 0.0)
    w, h = free.shape[-2], free.shape[-1]
    if max_sweeps is None:
        max_sweeps = w * h

    sweeps, changed = 0, True
    while changed and sweeps < max_sweeps:
        new = d
        for _ in range(block):
            new = _best_incoming(new, motions, masks, big, new).where(~pinned, 0.0)
        changed = bool(torch.any(new < d))
        d, sweeps = new, sweeps + block
    return d.where(d < big, torch.inf), sweeps


def repair_costs(d_prev, free_new, sources, connectivity: int = 8, corner_cutting: bool = False,
                 max_sweeps: int | None = None, tol: float = 1e-6):
    """Incremental repair of a cost field after map edits (d_star_lite.rs /
    lpa_star.rs contract).

    RAISE: iteratively clear cells whose value lost its downhill support —
    value must equal min over valid incoming neighbors of (nbr + step cost)
    or be a source. LOWER: re-relax from the surviving warm values.
    Returns (costs, raise_sweeps, lower_sweeps)."""
    motions = _motions(connectivity)
    f = d_prev.dtype
    free = free_new.to(torch.bool)
    masks = _incoming_masks(free, motions, corner_cutting)
    big = _big(f)
    pinned = sources & free
    d0 = d_prev.where(~(torch.isinf(d_prev) | ~free), big).where(~pinned, 0.0)
    w, h = free.shape[-2], free.shape[-1]
    if max_sweeps is None:
        max_sweeps = w * h
    full_big = torch.full_like(d0, big)

    def raise_step(d):
        support = _best_incoming(d, motions, masks, big, full_big)
        supported = pinned | (d >= big) | (torch.abs(d - support) <= tol)
        new = d.where(supported, big)
        return new, torch.any(new > d)

    d, raise_sweeps = _fixpoint(raise_step, d0, max_sweeps)
    d = d.where(d < big, torch.inf)
    d, lower_sweeps = relax_with_stats(d, free, sources, connectivity=connectivity,
                                       corner_cutting=corner_cutting, max_sweeps=max_sweeps)
    return d, raise_sweeps, lower_sweeps


def dstar_lite_replan(d_prev, free_new, goals, **kw):
    """D* Lite (d_star_lite.rs): goal-rooted cost-to-go repaired after map
    edits (robot replans toward a fixed goal as the map updates)."""
    return repair_costs(d_prev, free_new, goals, **kw)


def lpa_star_replan(d_prev, free_new, starts, **kw):
    """LPA* (lpa_star.rs): start-rooted g-value repair — the same min-plus
    repair with the start as source (the engine is direction-symmetric)."""
    return repair_costs(d_prev, free_new, starts, **kw)


def dstar_replan(d_prev, free_new, goals, **kw):
    """Original D* (d_star.rs): RAISE/LOWER wave repair — the two phases of
    `repair_costs` are precisely D*'s RAISE and LOWER states."""
    return repair_costs(d_prev, free_new, goals, **kw)


def ara_star_plan(free, start_idx, goal_idx, connectivity: int = 8, corner_cutting: bool = False,
                  stages: int = 4, sweeps_per_stage: int = 16, dtype=torch.float32):
    """ARA* (ara_star.rs): anytime schedule with monotone improvement.

    Each stage spends a bounded relaxation budget and records the current
    start-cell cost and its suboptimality bound ε = cost / h(start)
    (h admissible ⇒ ε ≥ true ratio). Final stage relaxes to convergence, so
    the last answer is optimal — the reference's ε→1 schedule. Returns
    (costs, per-stage costs [stages+1], per-stage bounds [stages+1]).
    start_idx and goal_idx are host integers."""
    free = free.to(torch.bool)
    w, h = free.shape
    dev = free.device
    goals = _one_hot((w, h), goal_idx, dev)
    sx, sy = int(start_idx[0]), int(start_idx[1])
    hstart = octile_heuristic((w, h), goal_idx, connectivity, dev, dtype)[sx, sy]
    d = torch.full((w, h), torch.inf, dtype=dtype, device=dev)

    stage_costs, stage_bounds = [], []
    for _ in range(stages):
        d, _ = relax_with_stats(d, free, goals, connectivity=connectivity,
                                corner_cutting=corner_cutting, max_sweeps=sweeps_per_stage)
        c = d[sx, sy]
        stage_costs.append(c)
        stage_bounds.append(c / torch.clamp(hstart, min=1e-9))
    # final: to convergence (ε = 1)
    d, _ = relax_with_stats(d, free, goals, connectivity=connectivity,
                            corner_cutting=corner_cutting)
    stage_costs.append(d[sx, sy])
    stage_bounds.append(torch.ones((), dtype=dtype, device=dev))
    return d, torch.stack(stage_costs), torch.stack(stage_bounds)


def ida_star_costs(free, start_idx, goal_idx, connectivity: int = 8, corner_cutting: bool = False,
                   max_deepenings: int = 64, dtype=torch.float32):
    """IDA* (ida_star.rs plan_with_report): start-rooted g-field relaxed
    under an f = g + h ≤ threshold bound; when the goal stays unreachable
    the threshold deepens to the minimum f among pruned cells (the exact
    IDA* threshold evolution), until the goal is reached.

    Returns (g_field, path_cost, stats) with stats = dict(deepenings,
    final_threshold, expanded_cells) mirroring IDAStarSearchStats. The
    deepening loop reads the goal's flag and the threshold once a
    deepening."""
    free = free.to(torch.bool)
    w, hh = free.shape
    dev = free.device
    starts = _one_hot((w, hh), start_idx, dev)
    gx, gy = int(goal_idx[0]), int(goal_idx[1])
    hmap = octile_heuristic((w, hh), goal_idx, connectivity, dev, dtype)
    big = _big(dtype)
    motions = _motions(connectivity)
    masks = _incoming_masks(free, motions, corner_cutting)
    d_start = torch.full((w, hh), big, dtype=dtype, device=dev).where(~(starts & free), 0.0)

    def bounded_relax(threshold):
        """Relax g with cells pruned where g + h > threshold; returns
        (g, min f over pruned candidates)."""
        def step(state):
            d, pruned_min = state
            cand = _best_incoming(d, motions, masks, big, d)
            fval = cand + hmap
            ok = fval <= threshold
            over = ~ok & (cand < big)
            # pruned candidates have f strictly > threshold, so the next
            # threshold strictly increases — guaranteed deepening progress
            pruned_min = torch.minimum(pruned_min, torch.amin(fval.where(over, big)))
            new = torch.minimum(d, cand.where(ok, big))
            return (new, pruned_min), torch.any(new < d)

        (d, pruned_min), _ = _fixpoint(step, (d_start, torch.full((), big, dtype=dtype,
                                                                   device=dev)), float("inf"))
        return d, pruned_min

    threshold = hmap[int(start_idx[0]), int(start_idx[1])]
    d = torch.full((w, hh), big, dtype=dtype, device=dev)
    found, k = False, 0
    while not found and k < max_deepenings and bool(threshold < big):
        d, pruned_min = bounded_relax(threshold)
        found = bool(d[gx, gy] < big)
        threshold = threshold if found else pruned_min
        k += 1
    cost = d[gx, gy] if found else torch.full((), torch.inf, dtype=dtype, device=dev)
    stats = {
        "deepenings": k,
        "final_threshold": threshold,
        "expanded_cells": torch.sum(d < big),
    }
    return d.where(d < big, torch.inf), cost, stats


def fringe_search_costs(free, start_idx, goal_idx, **kw):
    """Fringe search (fringe_search.rs): IDA* with a cached frontier — the
    raster field is the cache, so the bounded-deepening engine is shared;
    exposed under the reference's name with the same stats."""
    return ida_star_costs(free, start_idx, goal_idx, **kw)


def beam_search_costs(free, goals, heuristic, beam_width: int = 64, connectivity: int = 8,
                      corner_cutting: bool = False, max_sweeps: int | None = None):
    """Beam-limited relaxation (a_star_variants.rs beam variant): per sweep
    only the `beam_width` cells with the best f = g + h among newly
    improved cells commit their update. Possibly suboptimal (cost ≥
    optimal, = for wide beams) — exactly beam search's contract. Runs in
    the heuristic's dtype. The cut is the beam_width-th smallest f (JAX's
    `top_k(-f)[0][-1]`), a value, whatever the order of ties.

    Returns (costs, sweeps)."""
    motions = _motions(connectivity)
    f = heuristic.dtype
    free = free.to(torch.bool)
    masks = _incoming_masks(free, motions, corner_cutting)
    big = _big(f)
    d0 = torch.full(free.shape, big, dtype=f, device=free.device).where(~(goals & free), 0.0)
    w, h = free.shape
    if max_sweeps is None:
        max_sweeps = w * h

    def step(d):
        best = _best_incoming(d, motions, masks, big, d)
        improved = best < d
        fval = (best + heuristic).where(improved, big)
        # keep only the beam_width best improvements this sweep
        kth = torch.topk(fval.reshape(-1), beam_width, largest=False).values[-1]
        keep = improved & (fval <= kth)
        new = best.where(keep, d)
        return new, torch.any(new < d)

    d, sweeps = _fixpoint(step, d0, max_sweeps)
    return d.where(d < big, torch.inf), sweeps
