"""η³ spline paths and time-parameterized trajectories.

The port of rust_robotics_tpu/planning/eta3.py. Reference:
crates/rust_robotics_planning/src/eta3_spline.rs — each segment is a
7th-degree parametric polynomial pair (x(u), y(u)), u ∈ [0, 1], between two
poses with shaping parameters η = [η0..η5] and endpoint curvature
parameters κ = [κa, κ̇a, κb, κ̇b] (the closed-form table at :82-:221); arc
length by Gauss–Legendre of ‖(ẋ, ẏ)‖ (:326); Eta3Path chains segments with
a global u ∈ [0, N] (:333-:374); Eta3Trajectory time-parameterizes the
chain with a trapezoidal (max_vel, max_accel) profile (:582-:693).

The coefficients of a whole chain are one [S, 2, 8] tensor built over
leading batch dims; evaluation at any batch of u is an explicit sum over
the 8 powers (no matmul, so no TF32).
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import filled, linspace, norm2, true_div
from rust_robotics_tpu_torch.control._small import as_float, rsum
from rust_robotics_tpu_torch.planning.curves import _index, span

__all__ = [
    "eta3_coefficients",
    "eta3_point",
    "eta3_derivatives",
    "eta3_segment_length",
    "eta3_path_coefficients",
    "eta3_path_sample",
    "eta3_trajectory_sample",
]

# 10-point Gauss–Legendre nodes and weights on [0, 1]
_GL_X = (0.013046735741414, 0.067468316655508, 0.160295215850488, 0.283302302935376,
         0.425562830509184, 0.574437169490816, 0.716697697064624, 0.839704784149512,
         0.932531683344492, 0.986953264258586)
_GL_W = (0.033335672154344, 0.074725674575290, 0.109543181257991, 0.134633359654998,
         0.147762112357376, 0.147762112357376, 0.134633359654998, 0.109543181257991,
         0.074725674575290, 0.033335672154344)


def eta3_coefficients(start, end, eta=None, kappa=None, dtype=None, device=None):
    """[..., 2, 8] polynomial coefficients (x, y) × degree of the segments
    start → end [..., 3] — the closed-form table of eta3_spline.rs:82-221."""
    start = as_float(start, dtype, device)
    end = as_float(end, start.dtype, start.device)
    batch = torch.broadcast_shapes(start.shape[:-1], end.shape[:-1])
    e = (torch.zeros(batch + (6,), dtype=start.dtype, device=start.device) if eta is None
         else as_float(eta, start.dtype, start.device))
    k = (torch.zeros(batch + (4,), dtype=start.dtype, device=start.device) if kappa is None
         else as_float(kappa, start.dtype, start.device))
    e = [e[..., i] for i in range(6)]
    k = [k[..., i] for i in range(4)]
    ca, sa = torch.cos(start[..., 2]), torch.sin(start[..., 2])
    cb, sb = torch.cos(end[..., 2]), torch.sin(end[..., 2])
    dx = end[..., 0] - start[..., 0]
    dy = end[..., 1] - start[..., 1]
    d6 = lambda v: true_div(v, 6.0)  # noqa: E731

    cubic = e[0] ** 3 * k[1] + 3.0 * e[0] * e[2] * k[0]
    a2 = (20.0 * e[0] + 5.0 * e[2] + (2.0 / 3.0) * e[4])
    a3 = (5.0 * e[0] ** 2 * k[0] + (2.0 / 3.0) * e[0] ** 3 * k[1] + 2.0 * e[0] * e[2] * k[0])
    a4 = (15.0 * e[1] - 2.5 * e[3] + d6(e[5]))
    a5 = (2.5 * e[1] ** 2 * k[2] - d6(e[1] ** 3 * k[3]) - 0.5 * e[1] * e[3] * k[2])
    b2 = (45.0 * e[0] + 10.0 * e[2] + e[4])
    b3 = (10.0 * e[0] ** 2 * k[0] + e[0] ** 3 * k[1] + 3.0 * e[0] * e[2] * k[0])
    b4 = (39.0 * e[1] - 7.0 * e[3] + 0.5 * e[5])
    b5 = (7.0 * e[1] ** 2 * k[2] - 0.5 * e[1] ** 3 * k[3] - 1.5 * e[1] * e[3] * k[2])
    d2 = (36.0 * e[0] + 7.5 * e[2] + (2.0 / 3.0) * e[4])
    d3 = (7.5 * e[0] ** 2 * k[0] + (2.0 / 3.0) * e[0] ** 3 * k[1] + 2.0 * e[0] * e[2] * k[0])
    d4 = (34.0 * e[1] - 6.5 * e[3] + 0.5 * e[5])
    d5 = (6.5 * e[1] ** 2 * k[2] - 0.5 * e[1] ** 3 * k[3] - 1.5 * e[1] * e[3] * k[2])
    g2 = (10.0 * e[0] + 2.0 * e[2] + d6(e[4]))
    g3 = (2.0 * e[0] ** 2 * k[0] + d6(e[0] ** 3 * k[1]) + 0.5 * e[0] * e[2] * k[0])
    g4 = (10.0 * e[1] - 2.0 * e[3] + d6(e[5]))
    g5 = (2.0 * e[1] ** 2 * k[2] - d6(e[1] ** 3 * k[3]) - 0.5 * e[1] * e[3] * k[2])
    cx = [start[..., 0], e[0] * ca, 0.5 * e[2] * ca - 0.5 * e[0] ** 2 * k[0] * sa,
          d6(e[4] * ca) - d6(cubic * sa),
          35.0 * dx - a2 * ca + a3 * sa - a4 * cb - a5 * sb,
          -84.0 * dx + b2 * ca - b3 * sa + b4 * cb + b5 * sb,
          70.0 * dx - d2 * ca + d3 * sa - d4 * cb - d5 * sb,
          -20.0 * dx + g2 * ca - g3 * sa + g4 * cb + g5 * sb]
    cy = [start[..., 1], e[0] * sa, 0.5 * e[2] * sa + 0.5 * e[0] ** 2 * k[0] * ca,
          d6(e[4] * sa) + d6(cubic * ca),
          35.0 * dy - a2 * sa - a3 * ca - a4 * sb + a5 * cb,
          -84.0 * dy + b2 * sa + b3 * ca + b4 * sb - b5 * cb,
          70.0 * dy - d2 * sa - d3 * ca - d4 * sb + d5 * cb,
          -20.0 * dy + g2 * sa + g3 * ca + g4 * sb - g5 * cb]
    return torch.stack([torch.stack([v.expand(batch) for v in cx], -1),
                        torch.stack([v.expand(batch) for v in cy], -1)], -2)


def _powers(u, lo):
    """u[..., None] ** (k − lo) for k = 0..7, zero where k < lo."""
    k = torch.arange(8, device=u.device)
    p = u[..., None] ** torch.clamp(k - lo, min=0).to(u.dtype)
    return torch.where(k >= lo, p, torch.zeros_like(p))


def _poly(coeffs, powers):
    """Σ_k coeffs[..., d, k] · powers[..., k] → [..., 2]."""
    return rsum(coeffs * powers[..., None, :], -1)


def eta3_point(coeffs, u):
    """(x, y) at parameter u (broadcasts over u)."""
    u = torch.as_tensor(u, dtype=coeffs.dtype, device=coeffs.device)
    return _poly(coeffs, _powers(u, 0))


def eta3_derivatives(coeffs, u):
    """((ẋ, ẏ), (ẍ, ÿ)) at u."""
    u = torch.as_tensor(u, dtype=coeffs.dtype, device=coeffs.device)
    k = torch.arange(8, device=coeffs.device).to(coeffs.dtype)
    d1 = coeffs * k
    d2 = coeffs * k * torch.clamp(k - 1, min=0)
    return _poly(d1, _powers(u, 1)), _poly(d2, _powers(u, 2))


def _gl(dtype, device):
    return filled(_GL_X, dtype, device), filled(_GL_W, dtype, device)


def eta3_segment_length(coeffs):
    """Gauss–Legendre arc length of segments [..., 2, 8] (eta3_spline.rs:326)."""
    gx, gw = _gl(coeffs.dtype, coeffs.device)
    v, _ = eta3_derivatives(coeffs[..., None, :, :], gx)
    return torch.sum(gw * norm2(v), -1)


def eta3_path_coefficients(poses, etas=None, kappas=None, dtype=None, device=None):
    """Chain coefficients [S, 2, 8] for poses [S+1, 3]."""
    poses = as_float(poses, dtype, device)
    s = poses.shape[0] - 1
    if etas is None:
        # the standard default: η0 = η1 = the segment's chord length
        chords = norm2(torch.diff(poses[:, :2], dim=0))
        zero = torch.zeros((s, 4), dtype=poses.dtype, device=poses.device)
        etas = torch.cat([chords[:, None], chords[:, None], zero], -1)
    return eta3_coefficients(poses[:-1], poses[1:], etas, kappas)


def eta3_path_sample(chain_coeffs, num_points: int = 200):
    """Samples of the whole chain at the global parameter u ∈ [0, S)
    (Eta3Path::sample): points [num_points, 2]."""
    s = chain_coeffs.shape[0]
    u = linspace(s - 1e-9, num_points, dtype=chain_coeffs.dtype, device=chain_coeffs.device)
    seg = torch.clamp(u.to(torch.int32), 0, s - 1).to(torch.int64)
    return eta3_point(_index(chain_coeffs, seg), u - seg.to(u.dtype))


def eta3_trajectory_sample(chain_coeffs, max_vel: float = 1.0, max_accel: float = 0.5,
                           num_points: int = 200):
    """Trapezoidal time parameterization of the chained path
    (Eta3Trajectory): accelerate at max_accel to max_vel, cruise, decelerate
    (a triangular profile when too short). Returns dict(times, states
    [num_points, 5] = (x, y, yaw, v, s), total_time, total_length)."""
    f, dev = chain_coeffs.dtype, chain_coeffs.device
    lengths = eta3_segment_length(chain_coeffs)
    total = torch.sum(lengths)
    t_ramp = max_vel / max_accel
    s_ramp = 0.5 * max_accel * t_ramp ** 2
    tri = 2.0 * s_ramp > total
    t_ramp_tri = torch.sqrt(true_div(total, max_accel))
    v_peak = torch.where(tri, max_accel * t_ramp_tri, max_vel)
    t_total = torch.where(tri, 2.0 * t_ramp_tri, 2.0 * t_ramp + true_div(total - 2.0 * s_ramp,
                                                                           max_vel))
    times = span(t_total, num_points)

    t = times
    t_r = torch.where(tri, t_ramp_tri, t_ramp)
    s_r = 0.5 * max_accel * t_r ** 2
    s_acc = 0.5 * max_accel * t ** 2
    s_cru = s_r + v_peak * (t - t_r)
    td = t_total - t
    s_dec = total - 0.5 * max_accel * td ** 2
    late = t > t_total - t_r
    vvals = torch.where(t < t_r, max_accel * t, torch.where(late, max_accel * td, v_peak))
    svals = torch.where(t < t_r, s_acc, torch.where(late, s_dec, s_cru))
    svals = torch.clamp(svals, min=torch.zeros((), dtype=f, device=dev), max=total)

    # arc length → (segment, local u): the per-segment GL length, then 8
    # Newton steps on u inside the segment
    zero = torch.zeros(1, dtype=f, device=dev)
    cum = torch.cat([zero, torch.cumsum(lengths, 0)])
    seg = torch.clamp(torch.searchsorted(cum, svals.contiguous(), right=True) - 1, 0,
                      chain_coeffs.shape[0] - 1)
    rem = svals - _index(cum, seg)
    c = _index(chain_coeffs, seg)  # [P, 2, 8]
    gx, gw = _gl(f, dev)
    u = torch.clamp(rem / torch.clamp(_index(lengths, seg), min=1e-9), 0.0, 1.0)
    for _ in range(8):
        v, _a = eta3_derivatives(c, u)
        speed = torch.clamp(norm2(v), min=1e-9)
        vv, _aa = eta3_derivatives(c[:, None], u[:, None] * gx)
        alen = u * torch.sum(gw * norm2(vv), -1)
        u = torch.clamp(u - (alen - rem) / speed, 0.0, 1.0)
    pts = eta3_point(c, u)
    vel, _ = eta3_derivatives(c, u)
    yaw = torch.atan2(vel[:, 1], vel[:, 0])
    states = torch.cat([pts, yaw[:, None], vvals[:, None], svals[:, None]], 1)
    return {"times": times, "states": states, "total_time": t_total, "total_length": total}
