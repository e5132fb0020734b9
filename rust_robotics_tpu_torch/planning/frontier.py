"""Frontier-based long-range navigation (exploration past the local map).

The port of rust_robotics_tpu/planning/frontier.py. Reference:
crates/rust_robotics_planning/src/frontier_navigator.rs — Long Range
Navigator-lite: occlusion-aware sensing reveals cells only along clear
lines of sight within sensor range; *frontiers* are known-free cells
bordering unknown space; each frontier is scored by an affordance
combining goal progress, known-free travel cost, direct line of sight, and
information gain; the local handoff follows the gradient of a Dijkstra
field over the known-free map for a bounded step budget before re-sensing.

Sensing is one batched LOS tensor ([W·H rays × S samples] against the
truth raster), frontier detection a 4-neighbor stencil, travel cost the
min-plus wavefront (one B2 launch on the card, two a step), the scores
of ALL frontiers one elementwise pass. The episode loop (sense → pick →
drive) is host-side and reads the device where JAX's does: the goal's
cost, whether a frontier is left, the argmax and the field it descends.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import hypot, linspace
from rust_robotics_tpu_torch.planning.grid import _bool_on, _one_hot
from rust_robotics_tpu_torch.planning.wavefront import _shift, wavefront_costs

__all__ = ["FrontierNavConfig", "sense_reveal", "find_frontiers",
           "score_frontiers", "frontier_navigate"]

UNKNOWN, FREE, OCCUPIED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class FrontierNavConfig:
    """frontier_navigator.rs config surface."""

    sensor_range: float = 6.0
    los_samples: int = 24
    step_budget: int = 6
    max_episodes: int = 200
    w_progress: float = 1.0
    w_travel: float = 0.3
    w_los: float = 2.0
    w_gain: float = 0.5


def _grid(w, h, device, dtype):
    gx = torch.arange(w, device=device)[:, None].expand(w, h).to(dtype)
    gy = torch.arange(h, device=device)[None, :].expand(w, h).to(dtype)
    return gx, gy


def sense_reveal(known, truth_blocked, pos, sensor_range, los_samples: int = 24,
                 dtype=torch.float32):
    """Occlusion-aware reveal from the host cell `pos`: every cell within
    `sensor_range` whose sight line crosses no blocked cell becomes known
    (blocked cells are revealed as OCCUPIED when their own interior ray is
    clear). known [W, H] int32 and truth_blocked [W, H] bool on one device;
    the rays in `dtype`. Returns (known, visible)."""
    w, h = truth_blocked.shape
    dev = truth_blocked.device
    gx, gy = _grid(w, h, dev, dtype)
    px, py = float(pos[0]), float(pos[1])
    dist = hypot(gx - px, gy - py)
    in_range = dist <= sensor_range
    t = linspace(1.0, los_samples, dtype=dtype, device=dev)[:-1]  # interior samples
    rx = px + t * (gx[..., None] - px)
    ry = py + t * (gy[..., None] - py)
    ix = torch.round(rx).to(torch.int64).clamp(0, w - 1)
    iy = torch.round(ry).to(torch.int64).clamp(0, h - 1)
    hit = truth_blocked[ix, iy]
    # a sample "blocks" unless it's the target cell itself
    is_self = (ix == torch.round(gx).to(torch.int64)[..., None]) & (
        iy == torch.round(gy).to(torch.int64)[..., None])
    clear = ~torch.any(hit & ~is_self, dim=-1)
    visible = in_range & clear
    state = torch.where(truth_blocked, OCCUPIED, FREE).to(known.dtype)
    return torch.where(visible & (known == UNKNOWN), state, known), visible


def find_frontiers(known):
    """Known-free cells 4-adjacent to unknown space."""
    unk = known == UNKNOWN
    near_unk = (_shift(unk, 1, 0, False) | _shift(unk, -1, 0, False)
                | _shift(unk, 0, 1, False) | _shift(unk, 0, -1, False))
    return (known == FREE) & near_unk


def score_frontiers(known, frontiers, travel_costs, visible, pos, goal,
                    cfg: FrontierNavConfig):
    """Affordance per frontier cell (frontier_navigator.rs scoring): goal
    progress − travel cost + LOS bonus + unknown-information gain, in
    travel_costs' dtype; pos and goal host numbers."""
    w, h = known.shape
    f = travel_costs.dtype
    dev = known.device
    gx, gy = _grid(w, h, dev, f)
    d_goal = hypot(gx - float(goal[0]), gy - float(goal[1]))
    d_pos_goal = hypot(torch.full((), float(pos[0]), dtype=f, device=dev) - float(goal[0]),
                       torch.full((), float(pos[1]), dtype=f, device=dev) - float(goal[1]))
    progress = d_pos_goal - d_goal
    unk = (known == UNKNOWN).to(f)
    gain = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            gain = gain + _shift(unk, dx, dy, 0.0)
    travel = torch.where(torch.isfinite(travel_costs), travel_costs, 1e9)
    score = (cfg.w_progress * progress - cfg.w_travel * travel
             + cfg.w_los * visible.to(f) + cfg.w_gain * gain)
    return torch.where(frontiers & torch.isfinite(travel_costs), score, -torch.inf)


def _descent_steps(d, p, budget):
    """Walk down the host cost field d for at most `budget` cells."""
    p = p.copy()
    out = []
    moves = [(1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]
    for _ in range(budget):
        if d[p[0], p[1]] <= 0:
            break
        best, bv = None, d[p[0], p[1]]
        for dx, dy in moves:
            q = (p[0] + dx, p[1] + dy)
            if 0 <= q[0] < d.shape[0] and 0 <= q[1] < d.shape[1] and d[q] < bv:
                best, bv = q, d[q]
        if best is None:
            break
        p = np.asarray(best)
        out.append(tuple(p))
    return p, out


def frontier_navigate(truth_blocked, start, goal, cfg: FrontierNavConfig = FrontierNavConfig(),
                      device=None, dtype=torch.float32):
    """Full exploration loop: sense → (goal reachable over known-free?
    drive there) → else drive toward the best frontier for `step_budget`
    cells → repeat. truth_blocked [W, H] (host data goes to `device`,
    default cuda); fields and rays in `dtype`. Returns dict(trajectory
    [K, 2], reached, episodes, revealed_fraction, frontiers_chosen)."""
    truth = _bool_on(truth_blocked, device)
    dev = truth.device
    w, h = truth.shape
    known = torch.zeros((w, h), dtype=torch.int32, device=dev)
    pos = np.asarray(start, np.int64)
    goal = np.asarray(goal, np.int64)
    traj = [tuple(pos)]
    chosen = []
    reached = False

    episodes = 0
    for episodes in range(1, cfg.max_episodes + 1):
        known, visible = sense_reveal(known, truth, pos, cfg.sensor_range, cfg.los_samples,
                                      dtype)
        known_free = known == FREE
        # distance field over known-free space from the CURRENT position
        costs = wavefront_costs(known_free, _one_hot((w, h), pos, dev), dtype=dtype)
        if bool(torch.isfinite(costs[goal[0], goal[1]])):
            # goal visible and reachable: drive all the way
            gcosts = wavefront_costs(known_free, _one_hot((w, h), goal, dev), dtype=dtype)
            pos, steps = _descent_steps(gcosts.cpu().numpy(), pos, 10 * (w + h))
            traj.extend(steps)
            reached = bool((pos == goal).all())
            break
        frontiers = find_frontiers(known)
        scores = score_frontiers(known, frontiers, costs, visible, pos, goal, cfg)
        best = int(torch.argmax(scores.reshape(-1)))
        if not bool(scores.reshape(-1)[best] > -torch.inf):
            break  # nothing reachable left to explore
        target = (best // h, best % h)
        chosen.append(target)
        tcosts = wavefront_costs(known_free, _one_hot((w, h), target, dev), dtype=dtype)
        pos, steps = _descent_steps(tcosts.cpu().numpy(), pos, cfg.step_budget)
        if not steps:
            break  # stuck
        traj.extend(steps)

    revealed = float(torch.mean((known != UNKNOWN).to(dtype)))
    return {
        "trajectory": np.asarray(traj),
        "reached": reached,
        "episodes": episodes,
        "revealed_fraction": revealed,
        "frontiers_chosen": np.asarray(chosen) if chosen else np.zeros((0, 2), int),
    }
