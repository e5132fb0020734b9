"""Gaussian grid map: distance-based occupancy likelihood raster.

The port of rust_robotics_tpu/mapping/gaussian_map.py. Reference:
crates/rust_robotics_mapping/src/gaussian_grid_map.rs:30-93 — per cell,
probability = 1 − Φ(d_min; 0, σ) (normal CDF of the distance to the
nearest obstacle point). One batched distance-matrix min + CDF.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.planning.grid import _placement


def gaussian_grid_map(ox, oy, resolution, std_dev, extend=10.0, device=None, dtype=None):
    """Returns (prob [W, H], min_x, min_y). Cell value =
    1 − normal_cdf(d_nearest, 0, σ) (gaussian_grid_map.rs:30-68).

    Host data goes to `device` (default cuda) in `dtype` (default float32);
    tensors keep their device and, unless `dtype` is given, their dtype. The
    raster's size is read back to the host (two reads), as the JAX
    package sizes it on the host.
    """
    device = _placement(ox, device)
    if dtype is None:
        dtype = ox.dtype if isinstance(ox, torch.Tensor) else torch.float32
    ox = torch.as_tensor(ox, dtype=dtype, device=device)
    oy = torch.as_tensor(oy, dtype=dtype, device=device)
    min_x = torch.min(ox) - extend
    min_y = torch.min(oy) - extend
    max_x = torch.max(ox) + extend
    max_y = torch.max(oy) + extend
    # half to even, as jnp.round; static shapes: host-side sizing
    w = int(torch.round(true_div(max_x - min_x, resolution)).to(torch.int32))
    h = int(torch.round(true_div(max_y - min_y, resolution)).to(torch.int32))
    xs = min_x + resolution * torch.arange(w, dtype=dtype, device=device)
    ys = min_y + resolution * torch.arange(h, dtype=dtype, device=device)
    cx = xs[:, None, None]
    cy = ys[None, :, None]
    d = torch.sqrt((cx - ox) ** 2 + (cy - oy) ** 2)  # [W, H, N]
    d_min = torch.amin(d, dim=-1)
    prob = 1.0 - torch.special.ndtr(true_div(d_min - 0.0, std_dev))
    return prob, min_x, min_y
