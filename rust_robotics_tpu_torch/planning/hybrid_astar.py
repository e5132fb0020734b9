"""Hybrid A*: kinematically feasible SE(2) planning on an (x, y, θ)
lattice.

The port of rust_robotics_tpu/planning/hybrid_astar.py. Reference:
crates/rust_robotics_planning/src/hybrid_a_star.rs: a search over
continuous states binned into an (x, y, θ) grid, expanding steering-angle
motion primitives.

The cost-to-go field D[θ, x, y] relaxes over the steering primitives, a
min-plus stencil whose offsets depend on the heading bin: each primitive
is one gather through a precomputed index map (the successor (k + dθ,
x + dx[k], y + dy[k]) of every cell, BIG past the border, as JAX's masked
`jnp.roll`s give). Sweeps run in blocks of `block`; the changed flag is
read once a block, as JAX's `while_loop` tests it. The path descent is a
host loop, in JAX too.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import filled
from rust_robotics_tpu_torch.planning.grid import _bool_on

BIG = 1e18


def _motion_primitives(n_theta: int, step: float, steer_angles,
                       wheelbase: float, reverse: bool, reverse_penalty: float):
    """Per-heading-bin lattice displacements.

    For each heading bin k and steering angle δ: advance `step` along the
    arc; quantize (dx, dy) to cells and dθ to bins. Returns list of
    (dtheta_bins, dx[k], dy[k], cost) with dx/dy arrays indexed by source
    bin.
    """
    thetas = 2.0 * np.pi * np.arange(n_theta) / n_theta
    prims = []
    dirs = [1.0, -1.0] if reverse else [1.0]
    for direction in dirs:
        for delta in steer_angles:
            dth = direction * step / wheelbase * np.tan(delta)
            dth_bins = int(round(dth / (2.0 * np.pi / n_theta)))
            # displacement at each source heading (midpoint heading)
            mid = thetas + 0.5 * dth
            dx = np.round(direction * step * np.cos(mid)).astype(int)
            dy = np.round(direction * step * np.sin(mid)).astype(int)
            cost = step * (1.0 if direction > 0 else reverse_penalty)
            cost += 0.3 * abs(delta) * step  # steering penalty
            prims.append((dth_bins, dx, dy, cost))
    return prims


def _successor_maps(prims, n_theta, w, h, device):
    """Per primitive: the flat index of each cell's successor in a [θ, W,
    H] field, whether it lies inside the map, and the cost; built on the
    device from fills."""
    k = torch.arange(n_theta, device=device)[:, None, None]
    x = torch.arange(w, device=device)[None, :, None]
    y = torch.arange(h, device=device)[None, None, :]
    maps = []
    for db, dx_arr, dy_arr, cost in prims:
        nk = torch.remainder(k + db, n_theta)
        nx = x + filled([int(v) for v in dx_arr], torch.int64, device)[:, None, None]
        ny = y + filled([int(v) for v in dy_arr], torch.int64, device)[:, None, None]
        inside = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        flat = (nk * w + torch.clamp(nx, 0, w - 1)) * h + torch.clamp(ny, 0, h - 1)
        maps.append((flat.reshape(-1), inside, float(cost)))
    return maps


def hybrid_astar_costs(free, goal_idx, goal_theta_bin, n_theta: int = 16, step: float = 2.0,
                       steer_angles: tuple = (-0.6, -0.3, 0.0, 0.3, 0.6),
                       wheelbase: float = 2.5, reverse: bool = True,
                       reverse_penalty: float = 2.0, max_iters: int = 4096, block: int = 4,
                       dtype=torch.float32, device=None):
    """Cost-to-go D[θ, x, y] to reach (goal cell, goal heading bin).

    free [W, H] (a host raster goes to `device`, default cuda); the cell
    size is 1 (scale `step`/`wheelbase` into cells); goal_idx and
    goal_theta_bin are host integers. Returns the field in `dtype`, inf
    where the goal is unreachable; descend it with `extract_hybrid_path`.
    """
    free = _bool_on(free, device)
    w, h = free.shape
    dev = free.device
    prims = _motion_primitives(n_theta, step, steer_angles, wheelbase, reverse, reverse_penalty)
    maps = _successor_maps(prims, n_theta, w, h, dev)
    k = torch.arange(n_theta, device=dev)[:, None, None]
    gx = torch.arange(w, device=dev)[None, :, None]
    gy = torch.arange(h, device=dev)[None, None, :]
    goal = (k == int(goal_theta_bin)) & (gx == int(goal_idx[0])) & (gy == int(goal_idx[1]))
    big = torch.full((), BIG, dtype=dtype, device=dev)
    d = torch.where(goal, torch.zeros((), dtype=dtype, device=dev), big)

    def sweep(d):
        flat = d.reshape(-1)
        best = d
        for idx, inside, cost in maps:
            cand = torch.where(inside, flat[idx].reshape(d.shape), big) + cost
            best = torch.minimum(best, torch.where(free, cand, big))
        return best

    it = 0
    while it < max_iters:
        new = d
        for _ in range(block):
            new = sweep(new)
        changed = torch.any(new < d)
        d, it = new, it + block
        if not bool(changed):
            break
    return torch.where(d >= BIG, torch.inf, d)


def extract_hybrid_path(costs, free, start_idx, start_theta_bin,
                        n_theta: int = 16, step: float = 2.0,
                        steer_angles: tuple = (-0.6, -0.3, 0.0, 0.3, 0.6),
                        wheelbase: float = 2.5, reverse: bool = True,
                        reverse_penalty: float = 2.0, max_len: int = 256):
    """Greedy descent over the 3D cost field; returns (states [L, 3]
    (x, y, θbin), mask [L], cost)."""
    prims = _motion_primitives(
        n_theta, step, steer_angles, wheelbase, reverse, reverse_penalty
    )
    w, h = tuple(free.shape)
    d = costs.detach().cpu().numpy() if isinstance(costs, torch.Tensor) else np.asarray(costs)
    cur = (int(start_theta_bin), int(start_idx[0]), int(start_idx[1]))
    out = [cur]
    total = d[cur]
    for _ in range(max_len - 1):
        if d[cur] <= 0.0 or not np.isfinite(d[cur]):
            break
        best_next, best_val = None, d[cur]
        k, x, y = cur
        for db, dx_arr, dy_arr, cost in prims:
            nk = (k + db) % n_theta
            nx, ny = x + int(dx_arr[k]), y + int(dy_arr[k])
            if 0 <= nx < w and 0 <= ny < h:
                val = cost + d[nk, nx, ny]
                if val < best_val + 1e-9 and d[nk, nx, ny] < d[cur]:
                    best_val = val
                    best_next = (nk, nx, ny)
        if best_next is None:
            break
        cur = best_next
        out.append(cur)
    states = np.array([[x, y, k] for k, x, y in out])
    mask = np.ones(len(out), dtype=bool)
    return states, mask, float(total)
