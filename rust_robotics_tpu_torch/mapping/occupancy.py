"""Occupancy-grid mapping: log-odds updates with ray casting.

The port of rust_robotics_tpu/mapping/occupancy.py. Reference:
crates/rust_robotics_mapping/src/occupancy_grid_map.rs (log-odds config
:8-37: occ +0.85, free −0.4, clamp ±5), lidar_to_grid_map.rs (Bresenham
free-space carving per beam), ray_casting_grid_map.rs (free/occupied/
unknown per-beam rasters).

Bresenham's incremental integer walk is replaced by parametric ray
marching: every beam is sampled at S uniform points up to its hit distance
and the visited cells get a scatter-add of free/occupied log-odds, all
beams at once ([B, S]). Duplicate visits within one beam are deduped by
cell, so each beam contributes at most one update per cell. The adds go
through `nlls/solver.py::scatter_add_`, whose sums do not depend on the
order of the threads: two calls give the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import linspace, true_div
from rust_robotics_tpu_torch.nlls.solver import scatter_add_
from rust_robotics_tpu_torch.planning.grid import _placement


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    """occupancy_grid_map.rs:8-37."""

    prior_log_odds: float = 0.0
    occupied_log_odds: float = 0.85
    free_log_odds: float = -0.4
    max_log_odds: float = 5.0
    min_log_odds: float = -5.0


def _cells_along_rays(origin, endpoints, spec, samples):
    """[B, S] flat cell indices marching each ray origin->endpoint, plus a
    dedupe mask (first visit of each cell within the ray)."""
    t = linspace(1.0, samples, dtype=endpoints.dtype, device=endpoints.device)[None, :, None]
    pts = origin[None, None, :] + t * (endpoints[:, None, :] - origin[None, None, :])
    ix = torch.floor(true_div(pts[..., 0] - spec.min_x, spec.resolution)).to(torch.int32)
    iy = torch.floor(true_div(pts[..., 1] - spec.min_y, spec.resolution)).to(torch.int32)
    ix = ix.clamp(0, spec.width - 1).long()
    iy = iy.clamp(0, spec.height - 1).long()
    flat = ix * spec.height + iy
    first = torch.cat([torch.ones_like(flat[:, :1], dtype=torch.bool), flat[:, 1:] != flat[:, :-1]],
                      dim=1)
    return flat, first


def raycast_update(log_odds, origin, endpoints, spec, hit_mask=None,
                   cfg: OccupancyGridConfig = OccupancyGridConfig(), samples: int = 256):
    """One scan update: carve free cells along each beam, mark the endpoint
    cell occupied (lidar_to_grid_map.rs + occupancy_grid_map.rs semantics).

    log_odds [W, H]; origin [2]; endpoints [B, 2]; hit_mask [B] marks beams
    that ended on an obstacle (max-range beams only carve free space).
    """
    w, h = log_odds.shape
    flat, first = _cells_along_rays(origin, endpoints, spec, samples)
    # free updates exclude the final cell of hit beams
    end_flat = flat[:, -1]
    is_end = flat == end_flat[:, None]
    free_updates = first & ~is_end
    f = log_odds.dtype
    delta = torch.zeros(w * h, dtype=f, device=log_odds.device)
    free = torch.full_like(flat, cfg.free_log_odds, dtype=f).where(free_updates, 0.0)
    scatter_add_(delta, (flat.reshape(-1),), free.reshape(-1))
    occ = torch.full_like(end_flat, cfg.occupied_log_odds, dtype=f)
    if hit_mask is not None:
        occ = occ.where(hit_mask, 0.0)
    scatter_add_(delta, (end_flat,), occ)
    out = log_odds + delta.reshape(w, h)
    return torch.clamp(out, cfg.min_log_odds, cfg.max_log_odds)


def lidar_to_grid(origin, angles, ranges, spec, max_range=None,
                  cfg: OccupancyGridConfig = OccupancyGridConfig(), samples: int = 256,
                  device=None, dtype=None):
    """Build a log-odds grid from one polar scan (lidar_to_grid_map.rs):
    returns [W, H] log odds. Beams at max_range carve free space only.

    Host data goes to `device` (default cuda) in `dtype` (default float32);
    tensors keep their device and, unless `dtype` is given, their dtype.
    """
    device = _placement(ranges, device)
    if dtype is None:
        dtype = ranges.dtype if isinstance(ranges, torch.Tensor) else torch.float32
    origin, angles, ranges = (torch.as_tensor(x, dtype=dtype, device=device)
                              for x in (origin, angles, ranges))
    endpoints = origin + torch.stack([ranges * torch.cos(angles), ranges * torch.sin(angles)],
                                     dim=-1)
    hit = None if max_range is None else ranges < max_range
    grid0 = torch.full((spec.width, spec.height), cfg.prior_log_odds, dtype=dtype, device=device)
    return raycast_update(grid0, origin, endpoints, spec, hit, cfg, samples)


def occupancy_probability(log_odds):
    """p = 1 − 1/(1+exp(l))."""
    return 1.0 - 1.0 / (1.0 + torch.exp(log_odds))
