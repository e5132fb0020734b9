"""Euclidean distance transforms (UDF/SDF).

The port of rust_robotics_tpu/mapping/distance.py. Reference:
crates/rust_robotics_mapping/src/distance_map.rs — Felzenszwalb 1D
lower-envelope passes (dt_1d :15) composed row/column → exact squared EDT;
`compute_udf` (:63) and signed `compute_sdf` (:113, outside positive).

The sequential lower-envelope scan is replaced by the dense min-plus form
of the same 1D transform, d[i] = min_j ((i−j)² + f[j]), an [n, n]
broadcast-min over all rows at once. Separability gives the exact 2D
transform in two passes. Squared distances are integers, exact in float32
up to 2²⁴, so the squared field is exact in either dtype, and its
correctly rounded square root (`_numeric.sqrt_rn`) the same on every
device. The [..., n, n, n] intermediate is cut into row blocks of at most
`_BLOCK_ELEMENTS` elements.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import sqrt_rn

_BIG = 1e12
_BLOCK_ELEMENTS = 1 << 28


def _dt_1d_dense(f):
    """Exact 1D squared distance transform along the last axis.
    f [..., n] -> d [..., n] with d[i] = min_j ((i−j)² + f[j])."""
    n = f.shape[-1]
    i = torch.arange(n, device=f.device)
    cost = ((i[:, None] - i[None, :]) ** 2).to(f.dtype)  # [n, n]
    rows = f.reshape(-1, n)
    step = max(1, _BLOCK_ELEMENTS // (n * n))
    out = [torch.amin(r[:, None, :] + cost, dim=-1) for r in rows.split(step)]
    return torch.cat(out).reshape(f.shape)


def squared_edt(obstacles, dtype=torch.float32):
    """Exact squared EDT of a bool raster [..., W, H] (cell units), in
    `dtype`."""
    f = torch.full(obstacles.shape, _BIG, dtype=dtype, device=obstacles.device).where(
        ~obstacles, 0.0)
    f = _dt_1d_dense(f)  # along H
    return _dt_1d_dense(f.transpose(-1, -2)).transpose(-1, -2)  # along W


def compute_udf(obstacles, dtype=torch.float32):
    """Unsigned distance field (distance_map.rs:63): 0 on obstacle cells."""
    return sqrt_rn(torch.clamp(squared_edt(obstacles, dtype), min=0.0))


def compute_sdf(obstacles, dtype=torch.float32):
    """Signed distance field (distance_map.rs:113): positive outside
    obstacles, negative inside (distance to the complement)."""
    outside = compute_udf(obstacles, dtype)
    inside = compute_udf(~obstacles, dtype)
    return torch.where(obstacles, -inside, outside)
