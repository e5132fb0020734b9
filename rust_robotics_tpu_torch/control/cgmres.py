"""Continuation/GMRES (C/GMRES) nonlinear MPC.

The port of rust_robotics_tpu/control/cgmres.py. Reference:
crates/rust_robotics_control/src/cgmres_nmpc.rs: solve the receding-horizon
necessary conditions F(U, x, t) = 0 by the continuation method — U̇ from the
GMRES solution of (∂F/∂U) U̇ = −ζ F − (∂F/∂x) ẋ — instead of re-solving the
NLP each step.

F evaluates as a forward state rollout and a backward costate rollout over
the horizon, the dynamics' Jacobians taken at every knot at once
(`vmap(jacrev)`); the products GMRES needs are `torch.func.jvp`s of F.
`gmres` is the port's own copy of JAX's `jax.scipy.sparse.linalg.gmres`
with `solve_method="incremental"` (JAX 0.9.0): `maxiter` restarts of up to
`restart` Arnoldi steps, one classical Gram-Schmidt pass, Givens rotations
built as the Krylov basis grows, the restart's tolerance `ptol` and the
outer one `atol = max(tol·‖b‖, atol)`. The loops stop on residuals read
from the device: once per Arnoldi step and once per restart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad, jacrev, jvp, vmap

from rust_robotics_tpu_torch.control._small import as_float, mt, mv


@dataclasses.dataclass(frozen=True)
class CGMRESConfig:
    horizon: int = 20
    dt_horizon: float = 0.05   # prediction-interval step
    zeta: float = 100.0        # continuation stabilization gain
    gmres_iters: int = 20
    sampling_dt: float = 0.01


def make_optimality_residual(dynamics: Callable, stage_cost_u_grad: Callable,
                             stage_cost_x_grad: Callable, terminal_cost_x_grad: Callable,
                             cfg: CGMRESConfig):
    """Build F(U, x): the stack of ∂H/∂u along the horizon.

    dynamics(x, u) -> ẋ on one state and control; H = l(x, u) + λᵀ f(x, u).
    """
    dfdx = vmap(jacrev(dynamics, argnums=0))
    dfdu = vmap(jacrev(dynamics, argnums=1))
    lx_all, lu_all = vmap(stage_cost_x_grad), vmap(stage_cost_u_grad)

    def residual(u_flat, x0):
        us = u_flat.reshape(cfg.horizon, -1)
        xs = [x0]
        for t in range(cfg.horizon):
            xs.append(xs[-1] + dynamics(xs[-1], us[t]) * cfg.dt_horizon)
        x_end, xs = xs[-1], torch.stack(xs[:-1])
        fx_t, lx = mt(dfdx(xs, us)), lx_all(xs, us)
        lam = terminal_cost_x_grad(x_end)
        lams = [None] * cfg.horizon
        for t in range(cfg.horizon - 1, -1, -1):
            lams[t] = lam
            lam = lam + (lx[t] + mv(fx_t[t], lam)) * cfg.dt_horizon
        lams = torch.stack(lams)
        return (lu_all(xs, us) + mv(mt(dfdu(xs, us)), lams)).reshape(-1)

    return residual


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _safe_normalize(x, thresh=None):
    """(x/‖x‖, ‖x‖), or zeros where ‖x‖ ≤ thresh (default the dtype's eps)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _rotate(h, i, cs, sn):
    """h with its entries i, i+1 rotated by (cs, sn)."""
    x1, y1 = h[i], h[i + 1]
    return torch.cat([h[:i], torch.stack([cs * x1 - sn * y1, sn * x1 + cs * y1]), h[i + 2:]])


def _givens(a, b):
    b_zero = torch.abs(b) == 0
    a_lt_b = torch.abs(a) < torch.abs(b)
    t = -torch.where(a_lt_b, a, b) / torch.where(a_lt_b, b, a)
    r = torch.rsqrt(1 + torch.abs(t) ** 2)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    cs = torch.where(b_zero, one, torch.where(a_lt_b, r * t, r))
    sn = torch.where(b_zero, zero, torch.where(a_lt_b, r, r * t))
    return cs, sn


def _arnoldi_step(k, a_mul, v_basis):
    """The k-th Arnoldi step: the new unit Krylov vector (column k+1) and
    the row of overlaps h [restart+1] (one Gram-Schmidt pass)."""
    eps = torch.finfo(v_basis.dtype).eps
    v = a_mul(v_basis[:, k])
    _, v_norm_0 = _safe_normalize(v)
    h = mv(mt(v_basis), v)
    v = v - mv(v_basis, h)
    unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
    h = torch.cat([h[:k + 1], v_norm_1[None], h[k + 2:]])
    return unit_v, h


def _gmres_restart(a_mul, b, x0, unit_residual, residual_norm, ptol, restart):
    """One restart: builds the Krylov basis with the QR of the Hessenberg
    matrix by Givens rotations while the residual estimate exceeds ptol."""
    n = b.shape[0]
    f, dev = b.dtype, b.device
    v_basis = torch.zeros((n, restart + 1), dtype=f, device=dev)
    v_basis[:, 0] = unit_residual
    r_mat = torch.eye(restart, restart + 1, dtype=f, device=dev)
    givens = torch.zeros((restart, 2), dtype=f, device=dev)
    beta = torch.zeros(restart + 1, dtype=f, device=dev)
    beta[0] = residual_norm
    err = residual_norm
    k = 0
    while k < restart and bool(err > ptol):
        unit_v, h = _arnoldi_step(k, a_mul, v_basis)
        v_basis[:, k + 1] = unit_v
        for i in range(k):
            h = _rotate(h, i, givens[i, 0], givens[i, 1])
        cs, sn = _givens(h[k], h[k + 1])
        givens[k, 0], givens[k, 1] = cs, sn
        r_mat[k] = _rotate(h, k, cs, sn)
        beta = _rotate(beta, k, cs, sn)
        err = torch.abs(beta[k + 1])
        k += 1
    y = torch.linalg.solve_triangular(mt(r_mat[:, :-1]), beta[:-1, None], upper=True)[:, 0]
    x = x0 + mv(v_basis[:, :-1], y)
    unit_residual, residual_norm = _safe_normalize(b - a_mul(x))
    return x, unit_residual, residual_norm


def gmres(a_mul, b, restart=20, maxiter=None):
    """JAX's `gmres(A, b, restart=restart, maxiter=maxiter,
    solve_method="incremental")` from x0 = 0 at its default tolerances
    (tol 1e-5, atol 0), for a vector b [n] and a matrix-free `a_mul`."""
    n = b.shape[0]
    maxiter = 10 * n if maxiter is None else maxiter
    restart = min(restart, n)
    b_norm = _norm(b)
    atol = torch.clamp(1e-5 * b_norm, min=0.0)
    ptol = b_norm * torch.clamp(atol / b_norm, max=1.0)
    x = torch.zeros_like(b)
    unit_residual, residual_norm = _safe_normalize(b - a_mul(x))
    k = 0
    while k < maxiter and bool(residual_norm > atol):
        x, unit_residual, residual_norm = _gmres_restart(a_mul, b, x, unit_residual,
                                                         residual_norm, ptol, restart)
        k += 1
    return x


def cgmres_step(residual, u_flat, x, x_dot, cfg: CGMRESConfig):
    """One continuation update: solve (∂F/∂U) U̇ = −ζF − (∂F/∂x)ẋ with
    matrix-free GMRES, advance U by sampling_dt."""
    f_val, fx_dot = jvp(lambda xx: residual(u_flat, xx), (x,), (x_dot,))
    rhs = -cfg.zeta * f_val - fx_dot

    def a_mul(v):
        return jvp(lambda uu: residual(uu, x), (u_flat,), (v,))[1]

    u_dot = gmres(a_mul, rhs, maxiter=cfg.gmres_iters, restart=cfg.gmres_iters)
    return u_flat + u_dot * cfg.sampling_dt


def run_cgmres(dynamics, stage_cost, terminal_cost, x0, steps, cfg: CGMRESConfig = CGMRESConfig(),
               m_controls: int = 1, dtype=None, device=None):
    """Closed-loop C/GMRES NMPC run (cgmres_nmpc.rs sim shape). Returns
    (states [steps+1, n], controls [steps, m]). x0 on `device` (default
    cuda; x0's own when a tensor), in `dtype` (x0's or torch's default)."""
    x0 = as_float(x0, dtype, device)
    res = make_optimality_residual(dynamics, grad(stage_cost, argnums=1),
                                   grad(stage_cost, argnums=0), grad(terminal_cost), cfg)
    x = x0
    u_flat = torch.zeros(cfg.horizon * m_controls, dtype=x0.dtype, device=x0.device)
    xs, us = [x0], []
    for _ in range(steps):
        u0 = u_flat[:m_controls]
        x_dot = dynamics(x, u0)
        u_flat = cgmres_step(res, u_flat, x, x_dot, cfg)
        x = x + dynamics(x, u0) * cfg.sampling_dt
        xs.append(x)
        us.append(u0)
    return torch.stack(xs), torch.stack(us)

