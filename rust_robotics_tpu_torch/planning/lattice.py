"""Model-predictive trajectory generation, state-lattice planning and
clothoid paths.

The port of rust_robotics_tpu/planning/lattice.py. Reference
(crates/rust_robotics_planning/src/):
model_predictive_trajectory_generator.rs (optimize the arc length and
curvature-polynomial parameters so the integrated pose hits a target),
state_lattice/ (a lookup table of parameter seeds over a target-pose grid,
the planner), clothoid_path.rs (linear-curvature segments).

Pose integration steps in order (a `lax.scan` in JAX, whose compiled body
fuses each update's multiply-add; the port rounds it once too). The
boundary-value solve is Gauss-Newton over leading batch dims of targets (a
lookup table, the lattice's terminal states) with `_small`'s 3×3 solves,
a lane equal to its solo run; the Jacobian of the endpoint is the closed
form of the integrator's running sums (JAX differentiates the scan; the
two agree to rounding, and the fixed point, set by the residual, is the
same).
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import hypot, norm2, true_div
from rust_robotics_tpu_torch.control._small import as_float, mm, mt, mv, solve_small
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.planning.rrt import mul_add

N_INTEGRATE = 60  # integration samples per trajectory


def integrate_curvature_poly(params, k0, num=N_INTEGRATE):
    """params [..., 3] = [s, km, kf]: the arc length and mid/final
    curvature of a quadratic curvature profile k(t) through (k0, km, kf)
    at t = 0, s/2, s. Returns poses [..., num, 3] from the origin."""
    s, km, kf = params[..., 0], params[..., 1], params[..., 2]
    k0 = torch.as_tensor(k0, dtype=params.dtype, device=params.device)
    ds = true_div(s, float(num))
    t = (torch.arange(num, device=params.device).to(params.dtype) + 0.5) * ds[..., None]
    # the quadratic through (0, k0), (s/2, km), (s, kf)
    a = k0
    b = (4.0 * km - 3.0 * k0 - kf) / torch.clamp(s, min=1e-9)
    c = 2.0 * (k0 + kf - 2.0 * km) / torch.clamp(s * s, min=1e-9)
    k = a[..., None] + b[..., None] * t + c[..., None] * t * t
    x = torch.zeros_like(s)
    y, yaw = x, x
    out = []
    for i in range(num):
        yaw = mul_add(k[..., i], ds, yaw)
        x = mul_add(ds, torch.cos(yaw), x)
        y = mul_add(ds, torch.sin(yaw), y)
        out.append(torch.stack([x, y, yaw], -1))
    return torch.stack(out, -2)


def _endpoint_jacobian(params, k0, num=N_INTEGRATE):
    """d(endpoint)/d(s, km, kf, k0) [..., 3, 4] of `integrate_curvature_poly`
    in closed form: yaw is the running sum of k·ds, x and y the running
    sums of ds·(cos, sin)(yaw), differentiated term by term."""
    s, km, kf = params[..., 0, None], params[..., 1, None], params[..., 2, None]
    k0 = torch.as_tensor(k0, dtype=params.dtype, device=params.device)[..., None]
    i = torch.arange(num, device=params.device).to(params.dtype) + 0.5
    ds = s / num
    t = i * ds
    b = (4.0 * km - 3.0 * k0 - kf) / s
    c = 2.0 * (k0 + kf - 2.0 * km) / (s * s)
    k = k0 + b * t + c * t * t
    yaw = torch.cumsum(k * ds, -1)
    u, u2 = t / s, (t / s) ** 2  # t/s and (t/s)² do not depend on s
    # dk/dp at fixed i: k = k0 + (4km − 3k0 − kf)·u + 2(k0 + kf − 2km)·u²
    dk = torch.stack([torch.zeros_like(k), 4.0 * u - 4.0 * u2, -u + 2.0 * u2,
                      1.0 - 3.0 * u + 2.0 * u2], -1)
    dds = torch.stack([torch.full_like(s, 1.0 / num), torch.zeros_like(s), torch.zeros_like(s),
                       torch.zeros_like(s)], -1)  # [..., 1, 4]
    dyaw = torch.cumsum(dk * ds[..., None] + k[..., None] * dds, -2)  # [..., num, 4]
    cy, sy = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    dx = torch.sum(dds * cy - ds[..., None] * sy * dyaw, -2)
    dy = torch.sum(dds * sy + ds[..., None] * cy * dyaw, -2)
    return torch.stack([dx, dy, dyaw[..., -1, :]], -2)


def _gauss_newton(err_jac, p, iterations, damping):
    """p ← p − (JᵀJ + λI)⁻¹ Jᵀe with p[0] kept >= 0.1, every lane of p
    [..., 3] at once; err_jac(p) gives (e [..., 3], J [..., 3, 3])."""
    eye = damping * torch.eye(3, dtype=p.dtype, device=p.device)
    for _ in range(iterations):
        e, j = err_jac(p)
        p_new = p - solve_small(mm(mt(j), j) + eye, mv(mt(j), e))
        p = torch.cat([torch.clamp(p_new[..., :1], min=0.1), p_new[..., 1:]], -1)
    return p


def _endpoint_error(poses, target):
    e = poses[..., -1, :] - target
    return torch.cat([e[..., :2], normalize_angle(e[..., 2:])], -1)


def _span(start, stop, num, dtype, device):
    """`jnp.linspace(start, stop, num)`: start·(1 − step) + stop·step,
    step = iota · (1/div), the stop itself last."""
    div = num - 1
    step = torch.arange(div, device=device).to(dtype) * torch.full(
        (), 1.0, dtype=dtype, device=device).div(div)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def optimize_trajectory(target_pose, k0=0.0, init_params=None, iterations: int = 30,
                        damping: float = 1e-6, dtype=None, device=None):
    """The boundary-value problem: [s, km, kf] whose integrated endpoint
    hits target_pose [..., 3] = [x, y, yaw] (Gauss-Newton with autodiff
    Jacobians), every target at once. Returns (params, endpoint error
    norm)."""
    target = as_float(target_pose, dtype, device)
    if init_params is None:
        d = hypot(target[..., 0], target[..., 1])
        init_params = torch.stack([d * 1.2 + 1e-3, target[..., 2] * 0.5, target[..., 2] * 0.5],
                                  -1)

    def err_jac(p):
        return (_endpoint_error(integrate_curvature_poly(p, k0), target),
                _endpoint_jacobian(p, k0)[..., :3])

    p = _gauss_newton(err_jac, init_params.expand(target.shape), iterations, damping)
    e = _endpoint_error(integrate_curvature_poly(p, k0), target)
    return p, torch.sqrt(torch.sum(e * e, -1))


def generate_lookup_table(target_xs, target_ys, target_yaws, k0=0.0, dtype=None, device=None):
    """Boundary-value solves over the target grid (state_lattice's
    lookup_table.csv): (params [T, 3], errors [T], targets [T, 3])."""
    xs = as_float(target_xs, dtype, device)
    ys, yaws = (as_float(v, xs.dtype, xs.device) for v in (target_ys, target_yaws))
    tx, ty, tyaw = torch.meshgrid(xs, ys, yaws, indexing="ij")
    targets = torch.stack([tx.reshape(-1), ty.reshape(-1), tyaw.reshape(-1)], -1)
    params, errs = optimize_trajectory(targets, k0)
    return params, errs, targets


def state_lattice_plan(goal_pose, obstacles, radii, k0=0.0, n_lateral: int = 9,
                       lateral_spread: float = 3.0, n_yaw: int = 5, yaw_spread: float = 0.6,
                       dtype=None, device=None):
    """Sample terminal states around the goal, solve every boundary-value
    problem, collision-check every trajectory, keep the best
    (state_lattice/planner.rs). Returns (poses [num, 3], params, cost)."""
    g = as_float(goal_pose, dtype, device)
    f, dev = g.dtype, g.device
    obstacles, radii = as_float(obstacles, f, dev), as_float(radii, f, dev)
    lat = _span(-lateral_spread, lateral_spread, n_lateral, f, dev)
    yaws = g[2] + _span(-yaw_spread, yaw_spread, n_yaw, f, dev)
    nrm = torch.stack([-torch.sin(g[2]), torch.cos(g[2])])
    ll, yy = torch.meshgrid(lat, yaws, indexing="ij")
    targets = torch.stack([g[0] + ll.reshape(-1) * nrm[0], g[1] + ll.reshape(-1) * nrm[1],
                           yy.reshape(-1)], -1)
    params, errs = optimize_trajectory(targets, k0)
    trajs = integrate_curvature_poly(params, k0)
    d = norm2(trajs[..., :, None, :2] - obstacles)
    collides = torch.any((d <= radii).flatten(-2), dim=-1)
    goal_dev = norm2(targets[:, :2] - g[:2])
    cost = torch.where(collides | (errs > 0.1), torch.inf, params[:, 0] + 2.0 * goal_dev)
    best = torch.argmin(cost)
    pick = lambda v: v.index_select(0, best.reshape(1))[0]  # noqa: E731
    return pick(trajs), pick(params), pick(cost)


def clothoid_path(target_pose, iterations: int = 60, dtype=None, device=None):
    """G1 clothoid fit (clothoid_path.rs): ONE linear-curvature segment
    k(t) = k0 + c·t reaching [x, y, yaw] from the origin, unknowns [s, k0,
    kf] (the initial curvature free, as in the reference's G1 solve).
    Returns (poses [num, 3], params [s, k0, kf], error)."""
    target = as_float(target_pose, dtype, device)

    def integrate(p3):
        km = 0.5 * (p3[..., 1] + p3[..., 2])  # the exact midpoint of a linear profile
        return integrate_curvature_poly(torch.stack([p3[..., 0], km, p3[..., 2]], -1), p3[..., 1])

    def err_jac(p3):
        km = 0.5 * (p3[..., 1] + p3[..., 2])
        j = _endpoint_jacobian(torch.stack([p3[..., 0], km, p3[..., 2]], -1), p3[..., 1])
        # (s, k0, kf) → (s, km, kf, k0) with km = (k0 + kf)/2
        j = torch.stack([j[..., 0], j[..., 3] + 0.5 * j[..., 1], j[..., 2] + 0.5 * j[..., 1]], -1)
        return _endpoint_error(integrate(p3), target), j

    d = hypot(target[0], target[1])
    p = torch.stack([d * 1.2 + 1e-3, target[2] * 0.5, target[2] * 0.5])
    p = _gauss_newton(err_jac, p, iterations, 1e-9)
    e = _endpoint_error(integrate(p), target)
    return integrate(p), p, torch.sqrt(torch.sum(e * e))
