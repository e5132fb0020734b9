"""Curve and trajectory primitives: cubic spline, quintic polynomial,
Bézier, Catmull-Rom, uniform B-spline, Dubins paths.

The port of rust_robotics_tpu/planning/curves.py. Reference:
crates/rust_robotics_planning/src/ — cubic_spline_planner.rs (natural
cubic spline, tridiagonal c-system :92-117, Spline2D arc-length
parameterization :131-187, calc_spline_course :189), quintic_polynomials.rs
(boundary-condition 3×3 solve :27-78), bezier_path.rs,
catmull_rom_spline.rs, bspline_path.rs, dubins_path.rs (six word types,
shortest wins).

Splines are coefficient tensors evaluated by segment lookup
(`searchsorted` + gather). The Dubins words are evaluated all six at once
and take leading batch dims (start and goal [..., 3]), so a tree planner
scores every node at once; every op is elementwise or a left-to-right sum
over a small axis, so a lane equals its solo run. The products of the
Bézier and B-spline bases are explicit sums (no matmul, so no TF32).
Functions that take host data create tensors on `device` (default `cuda`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._numeric import filled, hypot, linspace, true_div
from rust_robotics_tpu_torch.control._small import as_float, mm, rsum


def _index(values, idx):
    """values [N, ...] at idx [...] (gathered on the device)."""
    return values.index_select(0, idx.reshape(-1)).reshape(idx.shape + values.shape[1:])


# ---------------------------------------------------------------------------
# Natural cubic spline (cubic_spline_planner.rs:18-129)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CubicSpline1D:
    """Natural cubic spline: y = a + b·dt + c·dt² + d·dt³ per segment."""

    t: torch.Tensor  # knots [N]
    a: torch.Tensor  # [N]
    b: torch.Tensor  # [N-1]
    c: torch.Tensor  # [N]
    d: torch.Tensor  # [N-1]

    @staticmethod
    def fit(t, y, dtype=None, device=None):
        """Natural spline coefficients (cubic_spline_planner.rs:28-61): the
        tridiagonal system for c with free ends, solved by LU."""
        t = as_float(t, dtype, device)
        y = as_float(y, t.dtype, t.device)
        n = t.shape[0]
        h = torch.diff(t)
        ones = torch.ones(1, dtype=t.dtype, device=t.device)
        main = torch.cat([ones, 2.0 * (h[:-1] + h[1:]), ones])
        upper = torch.cat([torch.zeros_like(ones), h[1:]])
        lower = torch.cat([h[:-1], torch.zeros_like(ones)])
        mat = torch.diag_embed(main) + torch.diag_embed(upper, 1) + torch.diag_embed(lower, -1)
        inner = 3.0 * (y[2:] - y[1:-1]) / h[1:] - 3.0 * (y[1:-1] - y[:-2]) / h[:-1]
        zero = torch.zeros_like(ones)
        rhs = torch.cat([zero, inner, zero]) if n > 2 else torch.zeros_like(t)
        c = torch.linalg.solve_ex(mat, rhs[:, None])[0][:, 0]
        b = (y[1:] - y[:-1]) / h - true_div(h * (c[1:] + 2.0 * c[:-1]), 3.0)
        d = (c[1:] - c[:-1]) / (3.0 * h)
        return CubicSpline1D(t, y, b, c, d)

    def _seg(self, q):
        q = torch.as_tensor(q, dtype=self.t.dtype, device=self.t.device)
        i = torch.clamp(torch.searchsorted(self.t, q.contiguous(), right=True) - 1, 0,
                        self.t.shape[0] - 2)
        return i, q - _index(self.t, i)

    def calc(self, q):
        i, dt = self._seg(q)
        return (_index(self.a, i) + _index(self.b, i) * dt + _index(self.c, i) * dt**2
                + _index(self.d, i) * dt**3)

    def calc_d(self, q):
        i, dt = self._seg(q)
        return _index(self.b, i) + 2.0 * _index(self.c, i) * dt + 3.0 * _index(self.d, i) * dt**2

    def calc_dd(self, q):
        i, dt = self._seg(q)
        return 2.0 * _index(self.c, i) + 6.0 * _index(self.d, i) * dt


@dataclasses.dataclass(frozen=True)
class Spline2D:
    """Arc-length parameterized 2D spline (cubic_spline_planner.rs:131)."""

    s: torch.Tensor
    sx: CubicSpline1D
    sy: CubicSpline1D

    @staticmethod
    def fit(x, y, dtype=None, device=None):
        x = as_float(x, dtype, device)
        y = as_float(y, x.dtype, x.device)
        ds = hypot(torch.diff(x), torch.diff(y))
        s = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), torch.cumsum(ds, 0)])
        return Spline2D(s, CubicSpline1D.fit(s, x), CubicSpline1D.fit(s, y))

    @property
    def length(self):
        return self.s[-1]

    def calc_position(self, q):
        return self.sx.calc(q), self.sy.calc(q)

    def calc_yaw(self, q):
        return torch.atan2(self.sy.calc_d(q), self.sx.calc_d(q))

    def calc_curvature(self, q):
        dx, ddx = self.sx.calc_d(q), self.sx.calc_dd(q)
        dy, ddy = self.sy.calc_d(q), self.sy.calc_dd(q)
        return (ddy * dx - ddx * dy) / torch.clamp((dx**2 + dy**2) ** 1.5, min=1e-12)


def calc_spline_course(x, y, ds=0.1, num_points=None, dtype=None, device=None):
    """Sampled course (cubic_spline_planner.rs:189): (x, y, yaw, curvature,
    s). `num_points` fixes the sample count (default int(length/ds) + 1,
    one read of the length)."""
    sp = Spline2D.fit(x, y, dtype, device)
    if num_points is None:
        num_points = int(float(sp.length) / ds) + 1
    s = torch.minimum(torch.arange(num_points, device=sp.s.device).to(sp.s.dtype) * ds, sp.length)
    px, py = sp.calc_position(s)
    return px, py, sp.calc_yaw(s), sp.calc_curvature(s), s


# ---------------------------------------------------------------------------
# Quintic polynomial (quintic_polynomials.rs:17-110)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuinticPolynomial:
    coeffs: torch.Tensor  # [..., 6] a0..a5

    @staticmethod
    def boundary(xs, vxs, axs, xe, vxe, axe, time, dtype=None, device=None):
        """a3..a5 from the 3×3 boundary system (quintic_polynomials.rs:27-78),
        by LU; every argument a tensor or a number, broadcast to the batch
        (numbers alone go to `device` in `dtype`)."""
        args = (time, xs, vxs, axs, xe, vxe, axe)
        ref = next((v for v in args if isinstance(v, torch.Tensor)), None)
        if ref is None:
            ref = as_float(time, dtype, device)
        as_t = lambda v: torch.as_tensor(v, dtype=ref.dtype, device=ref.device)  # noqa: E731
        t, xs, vxs, axs, xe, vxe, axe = map(as_t, (time, xs, vxs, axs, xe, vxe, axe))
        shape = torch.broadcast_shapes(*(v.shape for v in (t, xs, vxs, axs, xe, vxe, axe)))
        t, xs, vxs, axs, xe, vxe, axe = (v.expand(shape) for v in (t, xs, vxs, axs, xe, vxe, axe))
        a0, a1, a2 = xs, vxs, axs / 2.0
        m = torch.stack([
            torch.stack([t**3, t**4, t**5], -1),
            torch.stack([3 * t**2, 4 * t**3, 5 * t**4], -1),
            torch.stack([6 * t, 12 * t**2, 20 * t**3], -1),
        ], -2)
        b = torch.stack([xe - a0 - a1 * t - a2 * t**2, vxe - a1 - 2 * a2 * t, axe - 2 * a2], -1)
        a345 = torch.linalg.solve_ex(m, b[..., None])[0][..., 0]
        return QuinticPolynomial(torch.cat([torch.stack([a0, a1, a2], -1), a345], -1))

    def _p(self, t):
        p = self.coeffs
        return [p[..., i, None] if torch.is_tensor(t) and t.dim() > p.dim() - 1 else p[..., i]
                for i in range(6)]

    def calc_point(self, t):
        p = self._p(t)
        return p[0] + p[1] * t + p[2] * t**2 + p[3] * t**3 + p[4] * t**4 + p[5] * t**5

    def calc_first_derivative(self, t):
        p = self._p(t)
        return p[1] + 2 * p[2] * t + 3 * p[3] * t**2 + 4 * p[4] * t**3 + 5 * p[5] * t**4

    def calc_second_derivative(self, t):
        p = self._p(t)
        return 2 * p[2] + 6 * p[3] * t + 12 * p[4] * t**2 + 20 * p[5] * t**3

    def calc_third_derivative(self, t):
        p = self._p(t)
        return 6 * p[3] + 24 * p[4] * t + 60 * p[5] * t**2


# ---------------------------------------------------------------------------
# Bézier (bezier_path.rs)
# ---------------------------------------------------------------------------

def bezier_point(control_points, t):
    """Bernstein evaluation; control_points [N, d], t [...] in [0, 1]."""
    n = control_points.shape[0] - 1
    f, dev = control_points.dtype, control_points.device
    k = torch.arange(n + 1, device=dev).to(f)
    nn = torch.full((), n + 1.0, dtype=f, device=dev)
    log_binom = torch.lgamma(nn) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
    tt = torch.as_tensor(t, dtype=f, device=dev)[..., None]
    tt = torch.clamp(tt, 1e-12, 1.0 - 1e-12)  # guards 0^0 at the ends
    bern = torch.exp(log_binom + k * torch.log(tt) + (n - k) * torch.log(1.0 - tt))
    return mm(bern, control_points)


def bezier_path(start_pose, goal_pose, offset=3.0, num_points=100, dtype=None, device=None):
    """4-point Bézier between poses (bezier_path.rs): control points along
    the headings; returns (path [num_points, 2], control points [4, 2])."""
    start = as_float(start_pose, dtype, device)
    goal = as_float(goal_pose, start.dtype, start.device)
    sx, sy, syaw = start.unbind(-1)
    gx, gy, gyaw = goal.unbind(-1)
    d = true_div(hypot(gx - sx, gy - sy), offset)
    cp = torch.stack([
        torch.stack([sx, sy]),
        torch.stack([sx + d * torch.cos(syaw), sy + d * torch.sin(syaw)]),
        torch.stack([gx - d * torch.cos(gyaw), gy - d * torch.sin(gyaw)]),
        torch.stack([gx, gy]),
    ])
    t = linspace(1.0, num_points, dtype=start.dtype, device=start.device)
    return bezier_point(cp, t), cp


# ---------------------------------------------------------------------------
# Catmull-Rom (catmull_rom_spline.rs)
# ---------------------------------------------------------------------------

def catmull_rom_point(p0, p1, p2, p3, t):
    """The uniform Catmull-Rom basis."""
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2.0 * p1) + (-p0 + p2) * t + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def catmull_rom_course(points, samples_per_segment: int = 20, dtype=None, device=None):
    """Samples through all interior segments; points [N, 2] (N ≥ 4)."""
    p = as_float(points, dtype, device)
    n = p.shape[0]
    t = linspace(1.0, samples_per_segment, endpoint=False, dtype=p.dtype, device=p.device)
    out = catmull_rom_point(p[:n - 3, None], p[1:n - 2, None], p[2:n - 1, None], p[3:, None],
                            t[None, :, None])
    return torch.cat([out.reshape(-1, p.shape[1]), p[-2][None]], 0)


# ---------------------------------------------------------------------------
# Uniform cubic B-spline (bspline_path.rs)
# ---------------------------------------------------------------------------

def _bspline_m(dtype, device):
    m = filled([-1.0, 3.0, -3.0, 1.0, 3.0, -6.0, 3.0, 0.0, -3.0, 0.0, 3.0, 0.0, 1.0, 4.0, 1.0,
                0.0], dtype, device).reshape(4, 4)
    return true_div(m, 6.0)


def bspline_course(control_points, samples_per_segment: int = 20, dtype=None, device=None):
    """The approximating uniform cubic B-spline of the control polygon."""
    p = as_float(control_points, dtype, device)
    n = p.shape[0]
    t = linspace(1.0, samples_per_segment, endpoint=False, dtype=p.dtype, device=p.device)
    tt = torch.stack([t**3, t**2, t, torch.ones_like(t)], -1)  # [S, 4]
    basis = mm(tt, _bspline_m(p.dtype, p.device))  # [S, 4]
    ctrl = torch.stack([p[i:i + 4] for i in range(n - 3)])  # [n-3, 4, d]
    return mm(basis, ctrl).reshape(-1, p.shape[1])


# ---------------------------------------------------------------------------
# Dubins paths (dubins_path.rs: 6 word types, shortest wins)
# ---------------------------------------------------------------------------

_TWO_PI = 2.0 * math.pi


def _mod2pi(x):
    return x - _TWO_PI * torch.floor(true_div(x, _TWO_PI))


def dubins_path_lengths(start, goal, curvature=1.0):
    """Segment lengths [..., 6, 3] (normalized by curvature) for the words
    [LSL, RSR, LSR, RSL, RLR, LRL] of start → goal [..., 3]; an invalid
    word gets inf lengths. The closed forms of dubins_path.rs's word
    planners, all six evaluated at once."""
    dx = goal[..., 0] - start[..., 0]
    dy = goal[..., 1] - start[..., 1]
    d = hypot(dx, dy) * curvature
    theta = torch.atan2(dy, dx)
    alpha = _mod2pi(start[..., 2] - theta)
    beta = _mod2pi(goal[..., 2] - theta)
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    sb, cb = torch.sin(beta), torch.cos(beta)
    c_ab = torch.cos(alpha - beta)
    inf = torch.full_like(d, math.inf)

    def guard(p_sq, fn):
        val = fn(torch.sqrt(torch.clamp(p_sq, min=0.0)))
        return torch.where((p_sq >= 0)[..., None], val, inf[..., None])

    p_sq = 2 + d * d - 2 * c_ab + 2 * d * (sa - sb)
    tmp = torch.atan2(cb - ca, d + sa - sb)
    lsl = guard(p_sq, lambda p: torch.stack([_mod2pi(-alpha + tmp), p, _mod2pi(beta - tmp)], -1))
    p_sq = 2 + d * d - 2 * c_ab + 2 * d * (sb - sa)
    tmp2 = torch.atan2(ca - cb, d - sa + sb)
    rsr = guard(p_sq, lambda p: torch.stack([_mod2pi(alpha - tmp2), p, _mod2pi(-beta + tmp2)], -1))
    p_sq = -2 + d * d + 2 * c_ab + 2 * d * (sa + sb)

    def lsr_fn(p):
        tmp3 = torch.atan2(-ca - cb, d + sa + sb) - torch.atan2(torch.full_like(p, -2.0), p)
        return torch.stack([_mod2pi(-alpha + tmp3), p, _mod2pi(-_mod2pi(beta) + tmp3)], -1)

    lsr = guard(p_sq, lsr_fn)
    p_sq = -2 + d * d + 2 * c_ab - 2 * d * (sa + sb)

    def rsl_fn(p):
        tmp4 = torch.atan2(ca + cb, d - sa - sb) - torch.atan2(torch.full_like(p, 2.0), p)
        return torch.stack([_mod2pi(alpha - tmp4), p, _mod2pi(beta - tmp4)], -1)

    rsl = guard(p_sq, rsl_fn)

    tmp_rlr = true_div(6.0 - d * d + 2 * c_ab + 2 * d * (sa - sb), 8.0)
    p_rlr = _mod2pi(_TWO_PI - torch.arccos(torch.clamp(tmp_rlr, -1.0, 1.0)))
    t_rlr = _mod2pi(alpha - torch.atan2(ca - cb, d - sa + sb) + _mod2pi(true_div(p_rlr, 2.0)))
    rlr = torch.where((torch.abs(tmp_rlr) <= 1.0)[..., None],
                      torch.stack([t_rlr, p_rlr,
                                   _mod2pi(alpha - beta - t_rlr + _mod2pi(p_rlr))], -1),
                      inf[..., None])
    tmp_lrl = true_div(6.0 - d * d + 2 * c_ab + 2 * d * (sb - sa), 8.0)
    p_lrl = _mod2pi(_TWO_PI - torch.arccos(torch.clamp(tmp_lrl, -1.0, 1.0)))
    t_lrl = _mod2pi(-alpha - torch.atan2(ca - cb, d + sa - sb) + true_div(p_lrl, 2.0))
    lrl = torch.where((torch.abs(tmp_lrl) <= 1.0)[..., None],
                      torch.stack([t_lrl, p_lrl,
                                   _mod2pi(_mod2pi(beta) - alpha - t_lrl + _mod2pi(p_lrl))], -1),
                      inf[..., None])
    return torch.stack([lsl, rsr, lsr, rsl, rlr, lrl], -2)


DUBINS_WORDS = ("LSL", "RSR", "LSR", "RSL", "RLR", "LRL")
# the steer of each segment (1 = L, 0 = S, -1 = R), one row a word
_DUBINS_MODES = (1, 0, 1, -1, 0, -1, 1, 0, -1, -1, 0, 1, -1, 1, -1, 1, -1, 1)


def _arc_step(x, y, yaw, run, m, curvature):
    """The pose after `run` along a segment of steer m (straight when 0)
    from (x, y, yaw), the exact circular arc's centre-offset form."""
    straight = (x + run * torch.cos(yaw), y + run * torch.sin(yaw), yaw)
    r = 1.0 / curvature
    dyaw = m * run * curvature
    turn = (x + m * r * (torch.sin(yaw + dyaw) - torch.sin(yaw)),
            y - m * r * (torch.cos(yaw + dyaw) - torch.cos(yaw)),
            yaw + dyaw)
    s = m == 0
    return tuple(torch.where(s, a, b) for a, b in zip(straight, turn))


def dubins_shortest_path(start, goal, curvature=1.0, num_points=200):
    """The shortest Dubins path of start → goal [..., 3]: (points [...,
    num_points, 3], total length [...], word index [...]), sampled by
    marching arc length through the 3 segments."""
    lengths = dubins_path_lengths(start, goal, curvature)  # [..., 6, 3]
    totals = rsum(lengths, -1)
    best = torch.argmin(totals, dim=-1)
    pick = best[..., None, None].expand(best.shape + (1, 3))
    segs = true_div(torch.gather(lengths, -2, pick)[..., 0, :], curvature)  # world units
    modes = filled(_DUBINS_MODES, segs.dtype, segs.device).reshape(6, 3)
    modes = _index(modes, best)
    total = rsum(segs, -1)
    s = span(total, num_points)
    zero = torch.zeros_like(segs[..., :1])
    c0 = torch.cumsum(torch.cat([zero, segs], -1), -1)[..., :3]
    # the segment holding each sample: searchsorted(c0, s, right) − 1, clipped
    k = torch.clamp(rsum((c0[..., None, :] <= s[..., :, None]).to(torch.int64), -1) - 1, 0, 2)
    x, y, yaw = (start[..., i, None].to(segs.dtype).expand(s.shape) for i in range(3))
    for i in range(3):
        run = torch.where(i < k, segs[..., i, None],
                          torch.where(i == k, s - c0[..., i, None], torch.zeros_like(s)))
        run = torch.clamp(run, min=0.0)
        x, y, yaw = _arc_step(x, y, yaw, run, modes[..., i, None], curvature)
    return torch.stack([x, y, yaw], -1), total, best


def span(stop, num):
    """`jnp.linspace(0.0, stop, num)` for a tensor `stop` [...] → [..., num]:
    jitted XLA computes stop · (iota · (1/div)), the stop itself last."""
    div = num - 1
    if num <= 1:
        return torch.zeros(stop.shape + (num,), dtype=stop.dtype, device=stop.device)
    step = torch.arange(div, device=stop.device).to(stop.dtype)
    step = step * torch.full((), 1.0, dtype=stop.dtype, device=stop.device).div(div)
    return torch.cat([stop[..., None] * step, stop[..., None]], -1)
