"""Frenet optimal trajectory planning.

The port of rust_robotics_tpu/planning/frenet.py. Reference:
crates/rust_robotics_planning/src/frenet_optimal_trajectory.rs: sample
lateral quintics over road widths × horizon times and longitudinal
quartics over target speeds; rank by jerk/time/deviation costs; reject
samples violating speed/accel/curvature limits or colliding with circular
obstacles; convert the winner to global coordinates along a cubic-spline
reference line.

Every (d, T, v) candidate is evaluated at once: the candidates are a
leading axis of the polynomial tensors, validity and cost reduce to a
masked argmin, and nothing is read back. The candidate axes are
`jnp.arange`'s (NumPy's float arange: its count, and start + i·delta).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import hypot, norm2
from rust_robotics_tpu_torch.control._small import as_float
from rust_robotics_tpu_torch.planning.curves import QuinticPolynomial, Spline2D


@dataclasses.dataclass(frozen=True)
class FrenetConfig:
    """frenet_optimal_trajectory.rs:9-29."""

    max_speed: float = 50.0 / 3.6
    max_accel: float = 5.0
    max_curvature: float = 1.0
    max_road_width: float = 7.0
    d_road_w: float = 1.0
    dt: float = 0.2
    max_t: float = 5.0
    min_t: float = 4.0
    target_speed: float = 30.0 / 3.6
    d_t_s: float = 5.0 / 3.6
    n_s_sample: int = 1
    robot_radius: float = 2.0
    k_j: float = 0.1
    k_t: float = 0.1
    k_d: float = 1.0
    k_lat: float = 1.0
    k_lon: float = 1.0


def float_arange(start, stop, step, dtype, device):
    """`np.arange(start, stop, step)` in `dtype` on `device`: NumPy's count
    and its values start + i·delta, delta = (start + step) − start in the
    working precision, built on the device (no host copy)."""
    f = np.float64 if dtype == torch.float64 else np.float32
    count = len(np.arange(start, stop, step, dtype=f))
    first = f(start)
    delta = float(f(first + f(step)) - first)
    return torch.arange(count, device=device).to(dtype) * delta + float(first)


def _quartic_coeffs(xs, vxs, axs, vxe, axe, t):
    """Velocity-keeping quartic (no end-position constraint), over [...]."""
    a0, a1, a2 = xs, vxs, axs / 2.0
    m = torch.stack([torch.stack([3 * t**2, 4 * t**3], -1),
                     torch.stack([6 * t, 12 * t**2], -1)], -2)
    b = torch.stack([vxe - a1 - 2 * a2 * t, axe - 2 * a2], -1)
    a34 = torch.linalg.solve_ex(m, b[..., None])[0][..., 0]
    return torch.stack([a0, a1, a2, a34[..., 0], a34[..., 1]], -1)


def _poly4(c, t):
    c = [c[..., i, None] for i in range(5)]
    return (c[0] + c[1] * t + c[2] * t**2 + c[3] * t**3 + c[4] * t**4,
            c[1] + 2 * c[2] * t + 3 * c[3] * t**2 + 4 * c[4] * t**3,
            2 * c[2] + 6 * c[3] * t + 12 * c[4] * t**2,
            6 * c[3] + 24 * c[4] * t)


def frenet_optimal_plan(csp: Spline2D, s0, c_speed, c_d, c_d_d, c_d_dd, obstacles,
                        cfg: FrenetConfig = FrenetConfig(), num_steps: int = 26):
    """One planning cycle: a dict with the best trajectory's global path
    [K, 2], its s/d profiles, cost, and the validity diagnostics.
    `num_steps` = max_t/dt + 1 samples along each candidate. Tensors
    follow the spline's device and dtype."""
    f, dev = csp.s.dtype, csp.s.device
    obstacles = as_float(obstacles, f, dev)
    di = float_arange(-cfg.max_road_width, cfg.max_road_width + 1e-9, cfg.d_road_w, f, dev)
    ti = float_arange(cfg.min_t, cfg.max_t + 1e-9, cfg.dt, f, dev)
    tv = cfg.target_speed + cfg.d_t_s * (torch.arange(2 * cfg.n_s_sample + 1, device=dev).to(f)
                                         - float(cfg.n_s_sample))
    ts = torch.arange(num_steps, device=dev).to(f) * cfg.dt  # sample grid
    dd, tt_g, vv = torch.meshgrid(di, ti, tv, indexing="ij")
    d_target, t_total, v_target = dd.reshape(-1), tt_g.reshape(-1), vv.reshape(-1)  # [C]
    as_c = lambda v: as_float(v, f, dev).expand(d_target.shape)  # noqa: E731
    zero = torch.zeros_like(d_target)

    lat = QuinticPolynomial.boundary(as_c(c_d), as_c(c_d_d), as_c(c_d_dd), d_target, zero, zero,
                                     t_total)
    lon_c = _quartic_coeffs(as_c(s0), as_c(c_speed), zero, v_target, zero, t_total)
    t_col = t_total[:, None]
    tmask = ts <= t_col + 1e-9  # [C, K]
    tt = torch.minimum(ts, t_col)
    d = lat.calc_point(tt)
    d_ddd = lat.calc_third_derivative(tt)
    s, s_d, s_dd, s_ddd = _poly4(lon_c, tt)

    jp = torch.sum(torch.where(tmask, d_ddd**2, 0.0), -1)
    js = torch.sum(torch.where(tmask, s_ddd**2, 0.0), -1)
    ds_cost = (cfg.target_speed - s_d[:, -1]) ** 2
    cd = cfg.k_j * jp + cfg.k_t * t_total + cfg.k_d * d[:, -1] ** 2
    cv = cfg.k_j * js + cfg.k_t * t_total + cfg.k_d * ds_cost
    cost = cfg.k_lat * cd + cfg.k_lon * cv

    # global conversion along the reference spline
    s_clip = torch.clamp(s, min=torch.zeros((), dtype=f, device=dev), max=csp.length - 1e-6)
    rx, ry = csp.calc_position(s_clip)
    ryaw = csp.calc_yaw(s_clip)
    x = rx - d * torch.sin(ryaw)
    y = ry + d * torch.cos(ryaw)
    dx, dy = torch.diff(x, dim=-1), torch.diff(y, dim=-1)
    yaw = torch.atan2(dy, dx)
    seg = hypot(dx, dy)
    curv = torch.diff(yaw, dim=-1) / torch.clamp(seg[:, :-1], min=1e-9)

    ok_speed = torch.all(torch.where(tmask, s_d, 0.0) <= cfg.max_speed, -1)
    ok_accel = torch.all(torch.where(tmask, torch.abs(s_dd), 0.0) <= cfg.max_accel, -1)
    ok_curv = torch.all(torch.where(tmask[:, 2:], torch.abs(curv), 0.0) <= cfg.max_curvature, -1)
    pts = torch.stack([x, y], -1)
    dobs = norm2(pts[:, :, None, :] - obstacles)
    ok_coll = torch.all((torch.where(tmask[..., None], dobs, math.inf)
                         > cfg.robot_radius).flatten(1), -1)
    valid = ok_speed & ok_accel & ok_curv & ok_coll
    masked = torch.where(valid, cost, math.inf)
    best = torch.argmin(masked)
    pick = lambda v: v.index_select(0, best.reshape(1))[0]  # noqa: E731
    return {
        "path": pick(pts),
        "s": pick(s),
        "d": pick(d),
        "cost": pick(masked),
        "any_valid": torch.any(valid),
        "num_valid": torch.sum(valid),
        "best_index": best,
    }
