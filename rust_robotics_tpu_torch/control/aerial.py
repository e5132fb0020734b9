"""Aerial control: quintic 3D trajectory segments + PD quadrotor tracking,
minimum-snap trajectories.

The port of rust_robotics_tpu/control/aerial.py. Reference
(crates/rust_robotics_control/src/): drone_3d_trajectory.rs (931 LoC:
per-axis quintic segments between waypoints + PD attitude/thrust tracking
of a point-mass quadrotor), minimum_snap_trajectory.rs (318: 7th-order
minimum-snap segment solve).

The per-axis quintic solves batch over (segments × axes) through
`QuinticPolynomial.boundary`; the quadrotor sim is a loop of device steps
that reads nothing, over leading batch dims of the coefficients (a fleet
of flights). A step's segment is ⌊t / segment_time⌋ by a true division
(`_numeric.true_div`: CUDA's division by a number multiplies by its
reciprocal, which puts a step on a segment boundary in the wrong
segment). The products with the power vectors are explicit sums
(`_small`), not matmuls. The minimum-snap system is assembled on the
device from the powers of the segment times and the exact integer
factors k!/(k−order)! (made by products of `arange`s, no host data) and
solved by LU, as `jnp.linalg.solve` does.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import filled, true_div
from rust_robotics_tpu_torch.control._small import as_float, mv, rsum


def quintic_3d_segments(waypoints, segment_time, dtype=None, device=None):
    """Rest-to-rest quintic per segment per axis (drone_3d_trajectory.rs).
    waypoints [..., N, 3] (a tensor's device and dtype, else `device`,
    default cuda, and `dtype`); returns coeffs [..., N-1, 3, 6]."""
    # planning/ imports control/ (curves.py takes `_small`), so the quintic
    # is imported here, at call time, not when the package loads
    from rust_robotics_tpu_torch.planning.curves import QuinticPolynomial

    wp = as_float(waypoints, dtype, device)
    zero = torch.zeros((), dtype=wp.dtype, device=wp.device)
    return QuinticPolynomial.boundary(wp[..., :-1, :], zero, zero, wp[..., 1:, :], zero, zero,
                                      segment_time).coeffs


def _gather_segment(coeffs, seg_idx):
    """coeffs [..., S, 3, c] at seg_idx [...] -> [..., 3, c]."""
    i = seg_idx[..., None, None, None].expand(seg_idx.shape + (1,) + coeffs.shape[-2:])
    return torch.gather(coeffs, -3, i)[..., 0, :, :]


def eval_quintic_3d(coeffs, seg_idx, t):
    """Position/velocity/accel [..., 3] of segment `seg_idx` [...] at local
    time t [...] (coeffs [..., S, 3, 6])."""
    c = _gather_segment(coeffs, torch.as_tensor(seg_idx, device=coeffs.device))
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    powers = torch.stack([one, t, t**2, t**3, t**4, t**5], -1)
    dpow = torch.stack([zero, one, 2 * t, 3 * t**2, 4 * t**3, 5 * t**4], -1)
    ddpow = torch.stack([zero, zero, 2 * one, 6 * t, 12 * t**2, 20 * t**3], -1)
    return mv(c, powers), mv(c, dpow), mv(c, ddpow)


@dataclasses.dataclass(frozen=True)
class QuadPDConfig:
    kp: float = 8.0
    kd: float = 5.0
    mass: float = 1.0
    gravity: float = 9.81


def _up(cfg, like):
    """[0, 0, g] by fills on `like`'s device."""
    return filled((0.0, 0.0, cfg.gravity), like.dtype, like.device)


def quad_pd_accel(pos, vel, pos_ref, vel_ref, acc_ref, cfg: QuadPDConfig = QuadPDConfig()):
    """Desired world acceleration command (PD + feedforward)
    (drone_3d_trajectory.rs PD tracking)."""
    return acc_ref + cfg.kp * (pos_ref - pos) + cfg.kd * (vel_ref - vel) + _up(cfg, pos)


def simulate_quadrotor(coeffs, segment_time, dt=0.02, cfg: QuadPDConfig = QuadPDConfig()):
    """Point-mass quadrotor following the quintic segments coeffs
    [..., S, 3, 6]; returns (positions [..., K, 3], refs [..., K, 3])."""
    n_seg = coeffs.shape[-3]
    total = n_seg * segment_time
    steps = int(total / dt)
    batch = coeffs.shape[:-3]
    up = _up(cfg, coeffs)
    last = torch.full((), n_seg - 1, dtype=torch.int64, device=coeffs.device)
    zero_i = torch.zeros(batch, dtype=torch.int64, device=coeffs.device)
    pos, _, _ = eval_quintic_3d(coeffs, zero_i, torch.zeros(batch, dtype=coeffs.dtype,
                                                            device=coeffs.device))
    vel = torch.zeros_like(pos)
    ks = torch.arange(steps, dtype=coeffs.dtype, device=coeffs.device)
    ps, refs = [], []
    for k in range(steps):
        t = (ks[k] * dt).expand(batch)
        si = torch.minimum(true_div(t, segment_time).to(torch.int64), last)
        tl = t - si.to(coeffs.dtype) * segment_time
        p_ref, v_ref, a_ref = eval_quintic_3d(coeffs, si, tl)
        acc = quad_pd_accel(pos, vel, p_ref, v_ref, a_ref, cfg) - up  # thrust minus g
        vel = vel + acc * dt
        pos = pos + vel * dt
        ps.append(pos)
        refs.append(p_ref)
    return torch.stack(ps, -2), torch.stack(refs, -2)


def _falling(k, order):
    """k!/(k−order)! for k an arange (exact integers; 0 where k < order)."""
    out = torch.ones_like(k)
    for j in range(order):
        out = out * (k - j)
    return out


def _poly_rows(t, order):
    """poly_row(t, order) of each t [m]: [m, 8] with entries
    k!/(k−order)! · t^(k−order) for k >= order, else 0."""
    k = torch.arange(8, dtype=t.dtype, device=t.device)
    return _falling(k, order) * t[:, None] ** torch.clamp(k - order, min=0)


def minimum_snap_coeffs(waypoints_1d, segment_times, dtype=None, device=None):
    """Single-axis minimum-snap through waypoints: 7th-order per segment
    with continuity of derivatives up to snap at interior knots
    (minimum_snap_trajectory.rs). Dense constraint solve by LU. Returns
    [m, 8] coefficients (a tensor's device and dtype, else `device`,
    default cuda, and `dtype`)."""
    w = as_float(waypoints_1d, dtype, device)
    ts = as_float(segment_times, w.dtype, w.device)
    m = w.shape[0] - 1  # segments
    nc = 8 * m
    t0 = torch.zeros(m, dtype=w.dtype, device=w.device)
    mat = torch.zeros((nc, nc), dtype=w.dtype, device=w.device)
    vec = torch.zeros((nc,), dtype=w.dtype, device=w.device)
    start0, end0 = _poly_rows(t0, 0), _poly_rows(ts, 0)
    row = 0
    for i in range(m):
        # endpoint positions
        mat[row, 8 * i: 8 * i + 8] = start0[i]
        vec[row] = w[i]
        mat[row + 1, 8 * i: 8 * i + 8] = end0[i]
        vec[row + 1] = w[i + 1]
        row += 2
    rows_start = {order: _poly_rows(t0, order) for order in range(1, 7)}
    rows_end = {order: _poly_rows(ts, order) for order in range(1, 7)}
    # start/end rest (vel, acc, jerk)
    for order in (1, 2, 3):
        mat[row, 0:8] = rows_start[order][0]
        mat[row + 1, 8 * (m - 1): 8 * m] = rows_end[order][m - 1]
        row += 2
    # interior continuity of derivatives 1..6
    for i in range(m - 1):
        for order in range(1, 7):
            mat[row, 8 * i: 8 * i + 8] = rows_end[order][i]
            mat[row, 8 * (i + 1): 8 * (i + 1) + 8] = -rows_start[order][i + 1]
            row += 1
    assert row == nc, (row, nc)
    sol = torch.linalg.solve_ex(mat, vec[:, None])[0][:, 0]
    return sol.reshape(m, 8)


def eval_poly8(coeffs_seg, t, order=0):
    """Evaluate an 8-coefficient segment coeffs_seg [..., 8] (or its
    derivative) at t [...]."""
    c = coeffs_seg
    t = torch.as_tensor(t, dtype=c.dtype, device=c.device)
    for _ in range(order):
        c = c[..., 1:] * torch.arange(1, c.shape[-1], dtype=c.dtype, device=c.device)
    powers = t[..., None] ** torch.arange(c.shape[-1], dtype=c.dtype, device=c.device)
    return rsum(c * powers, -1)
