"""Sampling road maps: PRM, visibility road map, Voronoi road map.

The port of rust_robotics_tpu/planning/roadmap.py. Reference
(crates/rust_robotics_planning/src/): prm.rs, prm_star.rs,
visibility_road_map.rs, voronoi_road_map.rs.

All N vertices are sampled at once; the radius graph is the pairwise
distance matrix; edge collision checks are a sampled-segment tensor in row
tiles ([tile, N, S, M] distances); the shortest path over the roadmap is
min-plus matrix squaring (O(log N) steps, each product in row tiles); the
path walk is a loop of masked steps with nothing read back. PRM takes a
`torch.Generator` or the uniform draws themselves (`draws=`) in place of a
JAX key; the Voronoi ridge keeps `lax.top_k`'s order among equal
clearances by a stable descending sort.
"""

from __future__ import annotations

import math

import torch

from rust_robotics_tpu_torch._numeric import filled, linspace, norm2, true_div
from rust_robotics_tpu_torch.mapping.distance import compute_udf
from rust_robotics_tpu_torch.planning.grid import _bool_on, _float_on, _placement
from rust_robotics_tpu_torch.planning.smoothing import line_of_sight_free

BIG = 1e18
# rows of a pairwise edge check or min-plus product computed at once
ROW_TILE = 128


def _edge_free(p0, p1, obstacles, radii, samples):
    """Segments p0 → p1 [..., 2] clear of every obstacle circle (sampled)."""
    t = linspace(1.0, samples, dtype=p1.dtype, device=p1.device)
    pts = p0[..., None, :] + t[:, None] * (p1 - p0)[..., None, :]
    d = norm2(pts[..., None, :] - obstacles)
    return torch.all((d > radii).flatten(-2), dim=-1)


def _pairwise_edge_free(verts, obstacles, radii, samples):
    n = verts.shape[0]
    out = torch.empty((n, n), dtype=torch.bool, device=verts.device)
    for i in range(0, n, ROW_TILE):
        rows = verts[i:i + ROW_TILE]
        out[i:i + ROW_TILE] = _edge_free(rows[:, None, :].expand(-1, n, 2),
                                         verts[None].expand(rows.shape[0], n, 2),
                                         obstacles, radii, samples)
    return out


def build_prm(generator, start, goal, obstacles, radii, num_samples=150, connect_radius=3.0,
              area_min=(0.0, 0.0), area_max=(10.0, 10.0), edge_checks=12, draws=None,
              device=None, dtype=torch.float32):
    """Sample a roadmap; returns (vertices [N+2, 2], weight matrix
    [N+2, N+2]) with start at index 0, goal at index 1. The samples are
    area_min + u·(area_max − area_min), u [N, 2] uniform in [0, 1): `draws`
    when given, else drawn from `generator` (a `torch.Generator` on the
    device, or None). Free-space rejection keeps capacity static (invalid
    samples isolate themselves). On `device` (default cuda; obstacles'
    own when a tensor), in `dtype`."""
    device = _placement(obstacles, device)
    lo = filled([float(v) for v in area_min], dtype, device)
    hi = filled([float(v) for v in area_max], dtype, device)
    if draws is None:
        draws = torch.rand((num_samples, 2), generator=generator, dtype=dtype, device=device)
    samples = lo + _float_on(draws, device, dtype) * (hi - lo)
    obstacles, radii = _float_on(obstacles, device, dtype), _float_on(radii, device, dtype)
    verts = torch.cat([_float_on(start, device, dtype)[None], _float_on(goal, device, dtype)[None],
                       samples])
    d = norm2(verts[:, None, :] - verts[None, :, :])
    free = _pairwise_edge_free(verts, obstacles, radii, edge_checks)
    # vertices inside obstacles disconnect entirely
    v_free = torch.all(norm2(verts[:, None, :] - obstacles) > radii, dim=-1)
    ok = free & (d <= connect_radius) & v_free[:, None] & v_free[None, :]
    w = torch.where(ok, d, BIG)
    w.diagonal().fill_(0.0)
    return verts, w


def roadmap_shortest_path(weights, src=0, dst=1):
    """All-pairs min-plus closure; returns (cost, dist matrix)."""
    n = weights.shape[0]
    dist = weights
    for _ in range((n - 1).bit_length()):
        prod = torch.empty_like(dist)
        for i in range(0, n, ROW_TILE):
            prod[i:i + ROW_TILE] = torch.amin(dist[i:i + ROW_TILE, :, None] + dist[None], dim=1)
        dist = torch.minimum(dist, prod)
    return dist[src, dst], dist


def extract_roadmap_path(verts, weights, dist, src=0, dst=1, max_len=64):
    """Greedy walk along optimal successors; returns (points [L, 2], mask).
    `max_len - 1` masked steps, nothing read back."""
    n = weights.shape[0]
    to_dst = dist[:, dst]
    cur = torch.full((1,), src, dtype=torch.int64, device=dist.device)  # [1]: no read to index
    done = torch.zeros(1, dtype=torch.bool, device=dist.device)
    seq = [cur]
    for _ in range(max_len - 1):
        through = weights.index_select(0, cur)[0] + to_dst
        here = to_dst[cur]
        opt = torch.abs(through - here) < 1e-9
        strictly_closer = to_dst < here
        cand = torch.where(opt & strictly_closer, to_dst, BIG)
        nxt = torch.argmin(cand).reshape(1)
        has = cand[nxt] < BIG
        done = done | (cur == dst) | ~has
        seq.append(torch.where(done, -1, nxt))
        cur = torch.where(done, cur, nxt)
    idxs = torch.cat(seq)
    return verts[idxs.clamp(0, n - 1)], idxs >= 0


def prm_plan(generator, start, goal, obstacles, radii, **kwargs):
    """End-to-end PRM query; returns (points, mask, cost)."""
    verts, w = build_prm(generator, start, goal, obstacles, radii, **kwargs)
    cost, dist = roadmap_shortest_path(w)
    pts, mask = extract_roadmap_path(verts, w, dist)
    return pts, mask, cost


def visibility_roadmap(start, goal, obstacles, radii, inflate=1.2,
                       corners_per_obstacle: int = 8, edge_checks=16, device=None,
                       dtype=torch.float32):
    """Visibility road map (visibility_road_map.rs): vertices are points
    ringed around each (inflated) obstacle circle; edges connect mutually
    visible vertices. Returns (vertices, weights) for
    `roadmap_shortest_path`."""
    device = _placement(obstacles, device)
    obstacles, radii = _float_on(obstacles, device, dtype), _float_on(radii, device, dtype)
    m = obstacles.shape[0]
    th = linspace(2.0 * math.pi, corners_per_obstacle, endpoint=False, dtype=dtype,
                  device=device)
    ring = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)  # [C, 2]
    verts_obs = (obstacles[:, None, :] + (radii[:, None, None] * inflate) * ring[None]
                 ).reshape(m * corners_per_obstacle, 2)
    verts = torch.cat([_float_on(start, device, dtype)[None], _float_on(goal, device, dtype)[None],
                       verts_obs])
    d = norm2(verts[:, None, :] - verts[None, :, :])
    vis = _pairwise_edge_free(verts, obstacles, radii, edge_checks)
    v_free = torch.all(norm2(verts[:, None, :] - obstacles) > radii, dim=-1)
    ok = vis & v_free[:, None] & v_free[None, :]
    w = torch.where(ok, d, BIG)
    w.diagonal().fill_(0.0)
    return verts, w


def voronoi_roadmap(start, goal, blocked, min_x, min_y, resolution, ridge_quantile=0.7,
                    max_vertices: int = 256, connect_radius_cells: float = 6.0, device=None,
                    dtype=torch.float32):
    """Voronoi road map (voronoi_road_map.rs): vertices on the maximal-
    clearance ridge of the obstacle distance field (EDT local maxima, the
    `max_vertices` of highest clearance, lower cell index first among
    equals), connected within a radius when the straight cell-space segment
    stays clear. min_x, min_y and resolution are host numbers. Returns
    (vertices [V, 2] world coords, weights [V, V])."""
    blocked = _bool_on(blocked, device)
    dev = blocked.device
    udf = compute_udf(blocked, dtype)
    w, h = udf.shape
    # ridge cells: distance >= all 4-neighbors (local maxima of clearance)
    pad = torch.nn.functional.pad(udf, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack([pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]])
    is_ridge = (udf >= torch.amax(neigh, dim=0)) & ~blocked
    score = torch.where(is_ridge, udf, -torch.inf).reshape(-1)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_vertices], idx[:max_vertices]
    cells = torch.stack([torch.div(idx, h, rounding_mode="floor"), idx % h], dim=-1).to(dtype)
    mins = filled([float(min_x), float(min_y)], dtype, dev)
    s_cell = true_div(_float_on(start, dev, dtype) - mins, resolution)
    g_cell = true_div(_float_on(goal, dev, dtype) - mins, resolution)
    verts = torch.cat([s_cell[None], g_cell[None], cells])
    valid = torch.cat([torch.ones(2, dtype=torch.bool, device=dev), vals > 0.5])
    n = verts.shape[0]
    d = norm2(verts[:, None, :] - verts[None, :, :])
    world = verts * resolution + mins
    free_seg = line_of_sight_free(world[:, None, :].expand(n, n, 2), world[None].expand(n, n, 2),
                                  blocked, min_x, min_y, resolution, samples=24)
    ok = free_seg & (d <= connect_radius_cells) & valid[:, None] & valid[None, :]
    wmat = torch.where(ok, d * resolution, BIG)
    wmat.diagonal().fill_(0.0)
    return world, wmat
