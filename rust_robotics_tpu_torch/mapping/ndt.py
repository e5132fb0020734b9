"""Normal Distributions Transform (NDT) grid.

The port of rust_robotics_tpu/mapping/ndt.py. Reference:
crates/rust_robotics_mapping/src/ndt.rs — bucket scan points into grid
cells; per cell store mean + covariance of its points (`NDTGrid`/`NDTMap`,
~300 LoC).

Bucketing is a segment sum over flat cell ids: counts, sums and second
moments accumulate through `nlls/solver.py::scatter_add_` (the same sums on
every run); covariance = E[xxᵀ] − μμᵀ with a minimum-point mask, over a
static W·H cell capacity. The count is float32 whatever the points' dtype,
as in the JAX package.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.nlls.solver import scatter_add_
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small


def _cells(points, min_xy, resolution, width, height):
    """(ix, iy) [N] int64 cell indices of points [N, 2], clipped."""
    ix = torch.floor(true_div(points[:, 0] - float(min_xy[0]), resolution)).to(torch.int32)
    iy = torch.floor(true_div(points[:, 1] - float(min_xy[1]), resolution)).to(torch.int32)
    return ix.clamp(0, width - 1).long(), iy.clamp(0, height - 1).long()


def ndt_grid(points, min_xy, resolution, width, height, min_points=3):
    """points [N, 2] -> (mean [W, H, 2], cov [W, H, 2, 2], count [W, H],
    valid [W, H])."""
    ix, iy = _cells(points, min_xy, resolution, width, height)
    flat = ix * height + iy
    n_cells = width * height
    f, dev = points.dtype, points.device

    count = scatter_add_(torch.zeros(n_cells, dtype=torch.float32, device=dev), (flat,),
                         torch.ones(flat.shape, dtype=torch.float32, device=dev))
    s1 = scatter_add_(torch.zeros(n_cells, 2, dtype=f, device=dev), (flat,), points)  # [C, 2]
    s2 = scatter_add_(torch.zeros(n_cells, 2, 2, dtype=f, device=dev), (flat,),
                      points[:, :, None] * points[:, None, :])  # [C, 2, 2]
    denom = torch.clamp(count, min=1.0).to(torch.promote_types(f, torch.float32))
    mean = s1 / denom[:, None]
    cov = s2 / denom[:, None, None] - mean[:, :, None] * mean[:, None, :]
    valid = count >= min_points
    return (
        mean.reshape(width, height, 2),
        cov.reshape(width, height, 2, 2),
        count.reshape(width, height),
        valid.reshape(width, height),
    )


def ndt_score(query_points, mean, cov, valid, min_xy, resolution, eps=1e-3):
    """NDT matching score of query points against the grid: Σ exp(−½ dᵀΣ⁻¹d)
    for the containing cell (ndt.rs scoring)."""
    w, h = valid.shape
    ix, iy = _cells(query_points, min_xy, resolution, w, h)
    mu = mean[ix, iy]
    sig = cov[ix, iy] + eps * torch.eye(2, dtype=cov.dtype, device=cov.device)
    d = query_points - mu
    m = torch.einsum("ni,nij,nj->n", d, inv_spd_small(sig), d)
    ok = valid[ix, iy]
    return torch.sum(torch.where(ok, torch.exp(-0.5 * m), 0.0))
