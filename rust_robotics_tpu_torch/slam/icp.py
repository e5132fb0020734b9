"""ICP scan matching: point-to-point with a polar-factor motion estimate.

The port of rust_robotics_tpu/slam/icp.py (reference:
slam/src/icp_matching.rs: the loop (:60-140, EPS = 1e-4, MAX_ITER = 100),
nearest-neighbour association (:164), the SVD motion estimate (:289-340:
centroid shift, W = c̃ p̃ᵀ, R = V Uᵀ, t = p̄ − R c̄), the accumulated
transform (:142-160), convergence once the error drops by at most EPS, and
`ICPResult`'s diagnostics (:30-50: mean, median and p90 error, 5 cm
inlier ratio)).

As the JAX package, not the Rust reference:
- association is a brute-force distance matrix |c|² + |p|² − 2c·p, not a
  KD-tree;
- the rotation is the polar factor: closed form (atan2) in 2-D, twelve
  Newton steps R ← (R + R⁻ᵀ)/2 in 3-D through `ops/smallmat.py`, never a
  generic SVD, whose sign conventions make another function;
- the percentiles are linearly interpolated quantiles (`torch.quantile`,
  as `jnp.quantile`);
- the transform accumulates as h_step · h, so that it maps the ORIGINAL
  current points onto their alignment.

`icp_matching` takes leading batch dims on `cur_pts` (or on both clouds)
and runs the pairs in lock-step: a pair that is done freezes, as under the
JAX package's `jax.vmap` of its `while_loop`; the loop reads back once an
iteration, whether any pair is still running. A pair's arithmetic does not
depend on the batch around it: products over the d coordinates are
explicit multiply-adds (`small_mm`) and sums over the points are halving
adds, where a cuBLAS product or a reduction kernel would pick its rounding
by the batch. That matters in float32: once a pair has converged its error
is the rounding of |c|² + |p|² − 2c·p, and whether that noise rises or
falls decides the last iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch._device import resolve_device, to_tensor
from rust_robotics_tpu_torch.nlls.tridiag import _tree_sum, small_mm
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small

EPS = 1e-4
MAX_ITER = 100
INLIER_DISTANCE_THRESHOLD = 0.05


@dataclasses.dataclass(frozen=True)
class ICPResult:
    """`ICPResult` (icp_matching.rs:30-50); `transform` is the homogeneous
    (d+1)×(d+1) previous-from-current matrix. Every field carries the
    pairs' leading dims."""

    transform: torch.Tensor
    iterations: torch.Tensor
    final_error: torch.Tensor
    final_error_mean: torch.Tensor
    initial_error_mean: torch.Tensor
    final_error_median: torch.Tensor
    final_error_p90: torch.Tensor
    inlier_ratio_5cm: torch.Tensor
    relative_error_reduction: torch.Tensor
    converged: torch.Tensor


def _halving_sum(x, dim):
    """x summed over `dim` by halving adds (`nlls/tridiag.py::_tree_sum`):
    the same bits for a pair whatever batch it sits in."""
    return _tree_sum(x.movedim(dim, -1)[..., None])


def _sq_norm(x):
    """|x|² over the trailing coordinate axis, by explicit adds."""
    out = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i] * x[..., i]
    return out


def nearest_neighbor(prev_pts, cur_pts):
    """For each current point the nearest previous point, by brute force.

    prev_pts [..., N, d], cur_pts [..., M, d] -> (indices [..., M],
    distances [..., M]), from the distance matrix |c|² + |p|² − 2c·p."""
    d2 = (_sq_norm(cur_pts)[..., :, None] + _sq_norm(prev_pts)[..., None, :]
          - 2.0 * small_mm(cur_pts, prev_pts.mT))
    idx = torch.argmin(d2, dim=-1)
    dist = torch.sqrt(torch.clamp(torch.take_along_dim(d2, idx[..., None], dim=-1)[..., 0],
                                  min=0.0))
    return idx, dist


def _polar_rotation_2d(w):
    """The proper-rotation polar factor of Wᵀ in closed form: the
    reference's R = V Uᵀ from the SVD of W (icp_matching.rs:325-333)."""
    m = w.mT
    theta = torch.atan2(m[..., 1, 0] - m[..., 0, 1], m[..., 0, 0] + m[..., 1, 1])
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _polar_rotation_3d(w, iters=12):
    """The polar factor of Wᵀ by the Newton iteration R ← (R + R⁻ᵀ)/2
    (3-D Kabsch without a generic SVD)."""
    m = w.mT
    # normalise the scale for convergence
    scale = torch.clamp(torch.sqrt(true_div(_sq_norm(m.flatten(-2)), 3.0)), min=1e-12)
    r = m / scale[..., None, None]
    for _ in range(iters):
        r = 0.5 * (r + inv_spd_small(r).mT)  # the 3×3 inverse is the adjugate's: general
    return r


def centroid(pts):
    """The mean of pts [..., m, d] over its m points: halving sums, then a
    true division, as `jnp.mean` divides (a CUDA `tensor / number`
    multiplies by the reciprocal)."""
    return true_div(_halving_sum(pts, -2), pts.shape[-2])


def svd_motion_estimation(prev_pts, cur_pts):
    """(R, t) mapping current onto previous (icp_matching.rs:289-345):
    centroids, the cross-covariance W = c̃ᵀ p̃, R its polar factor,
    t = p̄ − R c̄. Over leading dims."""
    pm = centroid(prev_pts)
    cm = centroid(cur_pts)
    c_shift = cur_pts - cm[..., None, :]
    p_shift = prev_pts - pm[..., None, :]
    w = _halving_sum(c_shift[..., :, :, None] * p_shift[..., :, None, :], -3)  # [..., d, d]
    r = _polar_rotation_2d(w) if prev_pts.shape[-1] == 2 else _polar_rotation_3d(w)
    t = pm - small_mm(r, cm[..., None])[..., 0]
    return r, t


def _percentile(x, q):
    return torch.quantile(x, q, dim=-1)


def icp_matching(prev_pts, cur_pts, max_iter: int = MAX_ITER, eps: float = EPS, device=None,
                 dtype=None):
    """The ICP loop (icp_matching.rs:60-140).

    prev_pts [N, d] or [..., N, d], cur_pts [..., M, d] (d = 2 or 3):
    host arrays or tensors, put on `device` (default cuda) in `dtype`
    (default: cur_pts's dtype if a tensor, else float32). Leading dims of
    cur_pts are independent scan pairs, run in lock-step; each freezes when
    done. Returns an ICPResult with the accumulated previous-from-current
    homogeneous transform."""
    device = resolve_device(device)
    if dtype is None:
        dtype = cur_pts.dtype if isinstance(cur_pts, torch.Tensor) else torch.float32
    prev = to_tensor(prev_pts, device, dtype)
    cur0 = to_tensor(cur_pts, device, dtype)
    lead = cur0.shape[:-2]
    m, d = cur0.shape[-2:]
    prev = prev.expand(*lead, *prev.shape[-2:])
    eye = torch.eye(d + 1, dtype=dtype, device=device)
    bottom = eye[d:].expand(*lead, 1, d + 1)

    cur = cur0
    h = eye.expand(*lead, d + 1, d + 1)
    pre_err = torch.full(lead, torch.inf, dtype=dtype, device=device)
    init_err = torch.full(lead, torch.nan, dtype=dtype, device=device)
    count = torch.zeros(lead, dtype=torch.int64, device=device)
    done = torch.zeros(lead, dtype=torch.bool, device=device)
    for _ in range(max_iter):
        if not bool((~done).any()):
            break
        live = ~done
        idx, dist = nearest_neighbor(prev, cur)
        err = _halving_sum(dist, -1)
        init_err = torch.where(live & torch.isnan(init_err), err, init_err)
        r, t = svd_motion_estimation(torch.take_along_dim(prev, idx[..., None], dim=-2), cur)
        d_err = pre_err - err
        diverged = d_err < 0.0
        step = live & ~diverged
        h_step = torch.cat([torch.cat([r, t[..., None]], -1), bottom], -2)
        h = torch.where(step[..., None, None], small_mm(h_step, h), h)
        pre_err = torch.where(step, err, pre_err)
        cur = torch.where(step[..., None, None], small_mm(cur, r.mT) + t[..., None, :], cur)
        count = count + live.to(torch.int64)
        done = done | diverged | (d_err <= eps)

    point_count = max(m, 1)
    _, final_dists = nearest_neighbor(prev, cur)
    final_mean = pre_err / point_count
    init_mean = init_err / point_count
    rel_red = torch.where(torch.isfinite(init_mean) & (init_mean > 0),
                          torch.clamp((init_mean - final_mean) / init_mean, min=0.0),
                          torch.zeros_like(init_mean))
    return ICPResult(
        transform=h,
        iterations=count,
        final_error=pre_err,
        final_error_mean=final_mean,
        initial_error_mean=init_mean,
        final_error_median=_percentile(final_dists, 0.5),
        final_error_p90=_percentile(final_dists, 0.9),
        inlier_ratio_5cm=torch.mean((final_dists <= INLIER_DISTANCE_THRESHOLD).to(dtype), dim=-1),
        relative_error_reduction=rel_red,
        converged=done & (count < max_iter),
    )
