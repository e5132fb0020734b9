"""Reeds-Shepp paths: shortest car paths with reverse gear.

The port of rust_robotics_tpu/planning/reeds_shepp.py. Reference:
crates/rust_robotics_planning/src/reeds_shepp_path.rs: the base formulas
LpSpLp, LpSpRp and LpRmL expanded by the timeflip/reflect symmetries.

Every (base formula × symmetry) candidate is evaluated at once over
leading batch dims of start and goal [..., 3] (an invalid word gets
+inf) and endpoint-verified before the argmin. Sampling marches the three
signed segments analytically, as the Dubins sampler does
(`planning/curves.py`).
"""

from __future__ import annotations

import math

import torch

from rust_robotics_tpu_torch._numeric import filled, hypot, true_div
from rust_robotics_tpu_torch.control._small import rsum
from rust_robotics_tpu_torch.planning.curves import _arc_step, span


def _mod2pi(x):
    return x - 2.0 * math.pi * torch.floor(true_div(x + math.pi, 2.0 * math.pi))


def _polar(x, y):
    return hypot(x, y), torch.atan2(y, x)


def _lp_sp_lp(x, y, phi):
    """CSC: L+ S+ L+ (lengths t, u, v; modes L S L)."""
    u, t = _polar(x - torch.sin(phi), y - 1.0 + torch.cos(phi))
    v = _mod2pi(phi - t)
    return (t >= 0.0) & (v >= 0.0), t, u, v


def _lp_sp_rp(x, y, phi):
    """CSC: L+ S+ R+."""
    u1, t1 = _polar(x + torch.sin(phi), y - 1.0 - torch.cos(phi))
    ok0 = u1**2 >= 4.0
    u = torch.sqrt(torch.clamp(u1**2 - 4.0, min=0.0))
    theta = torch.atan2(torch.full_like(u, 2.0), u)
    t = _mod2pi(t1 + theta)
    v = _mod2pi(t - phi)
    return ok0 & (t >= 0.0) & (v >= 0.0), t, u, v


def _lp_rm_l(x, y, phi):
    """CCC: L+ R− L (t, u, v signed; u is the middle arc, negative)."""
    xi = x - torch.sin(phi)
    eta = y - 1.0 + torch.cos(phi)
    u1, theta = _polar(xi, eta)
    alpha = torch.arccos(torch.clamp(true_div(u1, 4.0), -1.0, 1.0))
    t = _mod2pi(math.pi / 2.0 + alpha + theta)
    u = _mod2pi(math.pi - 2.0 * alpha)
    v = _mod2pi(phi - t - u)
    return u1 <= 4.0, t, -u, v


# (base formula, timeflip, reflect, steers), in the reference's order
_BASES = [(fn, timeflip, reflect, modes)
          for fn, modes in ((_lp_sp_lp, (1, 0, 1)), (_lp_sp_rp, (1, 0, -1)),
                            (_lp_rm_l, (1, -1, 1)))
          for timeflip in (False, True) for reflect in (False, True)]


def _candidates(x, y, phi):
    """Every registered word at (x, y, phi) [...]: (ok [..., K], signed
    lengths [..., K, 3], steers [K, 3])."""
    oks, lens, steers = [], [], []
    for fn, timeflip, reflect, modes in _BASES:
        xx, yy, pp = x, y, phi
        if timeflip:
            xx, pp = -xx, -pp
        if reflect:
            yy, pp = -yy, -pp
        ok, t, u, v = fn(xx, yy, pp)
        seg = torch.stack([t, u, v], -1)
        if timeflip:
            seg = -seg
        oks.append(ok)
        lens.append(seg)
        steers.extend(-m if reflect else m for m in modes)  # reflect flips L and R
    st = filled([float(m) for m in steers], x.dtype, x.device).reshape(len(_BASES), 3)
    return torch.stack(oks, -1), torch.stack(lens, -2), st


def _endpoint_normalized(segments, steers):
    """Endpoint (x, y, yaw) [...] of words segments [..., 3] from the
    origin at curvature 1."""
    zero = torch.zeros_like(segments[..., 0])
    x, y, yaw = zero, zero, zero
    for i in range(3):
        dist = segments[..., i]
        m = steers[..., i].expand(dist.shape)
        straight = (x + dist * torch.cos(yaw), y + dist * torch.sin(yaw), yaw)
        dyaw = m * dist
        turn = (x + m * (torch.sin(yaw + dyaw) - torch.sin(yaw)),
                y - m * (torch.cos(yaw + dyaw) - torch.cos(yaw)), yaw + dyaw)
        x, y, yaw = (torch.where(m == 0, a, b) for a, b in zip(straight, turn))
    return x, y, yaw


def reeds_shepp_path(start, goal, curvature=1.0):
    """The shortest Reeds-Shepp path of start → goal [..., 3]: (signed
    segment lengths [..., 3] in world units, steers [..., 3] in {−1, 0,
    1}, total length [...]). Negative lengths are reverse gear; every
    candidate word is endpoint-verified before the argmin."""
    dx = goal[..., 0] - start[..., 0]
    dy = goal[..., 1] - start[..., 1]
    c, s = torch.cos(start[..., 2]), torch.sin(start[..., 2])
    x = (c * dx + s * dy) * curvature
    y = (-s * dx + c * dy) * curvature
    phi = _mod2pi(goal[..., 2] - start[..., 2])
    ok, lens, steers = _candidates(x, y, phi)
    ex, ey, eyaw = _endpoint_normalized(lens, steers)
    hit = ((torch.abs(ex - x[..., None]) < 1e-6) & (torch.abs(ey - y[..., None]) < 1e-6)
           & (torch.abs(_mod2pi(eyaw - phi[..., None])) < 1e-6))
    totals = torch.where(ok & hit, rsum(torch.abs(lens), -1), torch.full_like(ex, math.inf))
    best = torch.argmin(totals, dim=-1)
    seg = torch.gather(lens, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    st = steers.index_select(0, best.reshape(-1)).reshape(best.shape + (3,))
    total = torch.gather(totals, -1, best[..., None])[..., 0]
    return true_div(seg, curvature), st, true_div(total, curvature)


def sample_reeds_shepp(start, segments, steers, curvature=1.0, num_points: int = 200):
    """March the three signed segments [..., 3] from start [..., 3]; poses
    [..., num_points, 3]."""
    seg_abs = torch.abs(segments)
    total = rsum(seg_abs, -1)
    c0 = torch.cumsum(torch.cat([torch.zeros_like(seg_abs[..., :1]), seg_abs], -1), -1)[..., :3]
    svals = span(total, num_points)
    # the segment holding each sample: searchsorted(c0, s, right) − 1, clipped
    k = torch.clamp(rsum((c0[..., None, :] <= svals[..., :, None]).to(torch.int64), -1) - 1, 0, 2)
    x, y, yaw = (start[..., i, None].to(segments.dtype).expand(svals.shape) for i in range(3))
    for i in range(3):
        run = torch.where(i < k, seg_abs[..., i, None],
                          torch.where(i == k, svals - c0[..., i, None], torch.zeros_like(svals)))
        run = torch.clamp(run, min=0.0)
        gear = torch.sign(segments[..., i, None])
        gear = torch.where(gear == 0, torch.ones_like(gear), gear)
        x, y, yaw = _arc_step(x, y, yaw, gear * run, steers[..., i, None].to(segments.dtype),
                              curvature)
    return torch.stack([x, y, yaw], -1)
