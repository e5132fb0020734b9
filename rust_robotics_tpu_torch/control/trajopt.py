"""Trajectory optimization: iLQR / DDP and infinite-horizon LQR.

The port of rust_robotics_tpu/control/trajopt.py. Reference:
crates/rust_robotics_control/src/ — ilqr.rs (backward Riccati pass with
regularization + forward line search), ddp.rs (adds second-order dynamics
tensors), lqr_control.rs (discrete Riccati iteration).

Dynamics and costs are user callables on one state [n] and control [m]
(torch ops). Their derivatives come from `torch.func` (`grad`, `jacrev`,
second derivatives as `jacrev` of `jacrev`), taken at every knot of the
horizon at once under `vmap`; the Riccati recursion runs backwards knot by
knot. Leading batch dims of x0 and us_init are problems solved in
lock-step, with `_small`'s explicit products and n×n solves, so a problem
equals its solo solve bit for bit. The line search rolls out all step
sizes at once and takes the first argmin; nothing is read back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.func import grad, jacrev, vmap

from rust_robotics_tpu_torch._numeric import filled
from rust_robotics_tpu_torch.control._small import masked_fixpoint, mm, mt, mv, rsum, solve_small


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 50
    # 1e-3 keeps the DDP second-order terms well-conditioned; iLQR is
    # insensitive to this value
    regularization: float = 1e-3
    line_search_steps: tuple = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01)
    tol: float = 1e-6


def _vx_contract(vx, f2):
    """Σ_i vx_i f2[i] — `einsum("i,ijk->jk")` over leading batch dims."""
    out = vx[..., 0, None, None] * f2[..., 0, :, :]
    for i in range(1, vx.shape[-1]):
        out = out + vx[..., i, None, None] * f2[..., i, :, :]
    return out


def ilqr_solve(dynamics: Callable, stage_cost: Callable, terminal_cost: Callable, x0, us_init,
               dt, cfg: ILQRConfig = ILQRConfig(), use_ddp: bool = False):
    """Returns (xs [..., H+1, n], us [..., H, m], final_cost [...]).

    iLQR (Gauss-Newton on the trajectory); `use_ddp=True` adds the
    second-order dynamics contraction (full DDP, ddp.rs). `dynamics(x, u,
    dt)`, `stage_cost(x, u)` and `terminal_cost(x)` take one state [n]
    and control [m]; x0 [..., n] and us_init [..., H, m] may carry
    leading batch dims (independent problems).
    """
    batch = x0.shape[:-1]
    n = x0.shape[-1]
    h, m = us_init.shape[-2:]
    nb = math.prod(batch)
    f, dev = x0.dtype, x0.device
    x0 = x0.reshape(nb, n)

    def over_knots(fn):
        """fn(x, u) over any leading dims of x [..., n], u [..., m]."""
        flat = vmap(fn)

        def call(x, u):
            lead = x.shape[:-1]
            out = flat(x.reshape(-1, n), u.reshape(-1, m))
            return out.reshape(lead + out.shape[1:])
        return call

    def dyn(x, u):
        return dynamics(x, u, dt)

    step_all = over_knots(dyn)
    stage_all = over_knots(stage_cost)
    term_flat = vmap(terminal_cost)

    def terminal_all(x):
        return term_flat(x.reshape(-1, n)).reshape(x.shape[:-1])

    fx_all = over_knots(jacrev(dyn, argnums=0))
    fu_all = over_knots(jacrev(dyn, argnums=1))
    lx_all = over_knots(grad(stage_cost, argnums=0))
    lu_all = over_knots(grad(stage_cost, argnums=1))
    lxx_all = over_knots(jacrev(jacrev(stage_cost, argnums=0), argnums=0))
    luu_all = over_knots(jacrev(jacrev(stage_cost, argnums=1), argnums=1))
    lux_all = over_knots(jacrev(grad(stage_cost, argnums=1), argnums=0))
    vx_fn = vmap(grad(terminal_cost))
    vxx_fn = vmap(jacrev(jacrev(terminal_cost)))
    if use_ddp:
        fxx_all = over_knots(jacrev(jacrev(dyn, argnums=0), argnums=0))
        fux_all = over_knots(jacrev(jacrev(dyn, argnums=1), argnums=0))
        fuu_all = over_knots(jacrev(jacrev(dyn, argnums=1), argnums=1))
    reg = cfg.regularization * torch.eye(m, dtype=f, device=dev)

    def rollout(x_start, us):
        xs = [x_start]
        for t in range(h):
            xs.append(step_all(xs[-1], us[..., t, :]))
        return torch.stack(xs, dim=-2)

    def total_cost(xs, us):
        return rsum(stage_all(xs[..., :-1, :], us), -1) + terminal_all(xs[..., -1, :])

    def backward(xs, us):
        xk, uk = xs[:, :-1], us
        fx, fu = fx_all(xk, uk), fu_all(xk, uk)
        lx, lu = lx_all(xk, uk), lu_all(xk, uk)
        lxx, luu, lux = lxx_all(xk, uk), luu_all(xk, uk), lux_all(xk, uk)
        if use_ddp:
            fxx, fux, fuu = fxx_all(xk, uk), fux_all(xk, uk), fuu_all(xk, uk)
        vx, vxx = vx_fn(xs[:, -1]), vxx_fn(xs[:, -1])
        kffs, kfbs = [None] * h, [None] * h
        for t in range(h - 1, -1, -1):
            fxt, fut = mt(fx[:, t]), mt(fu[:, t])
            qx = lx[:, t] + mv(fxt, vx)
            qu = lu[:, t] + mv(fut, vx)
            qxx = lxx[:, t] + mm(mm(fxt, vxx), fx[:, t])
            quu = luu[:, t] + mm(mm(fut, vxx), fu[:, t])
            qux = lux[:, t] + mm(mm(fut, vxx), fx[:, t])
            if use_ddp:
                qxx = qxx + _vx_contract(vx, fxx[:, t])
                qux = qux + _vx_contract(vx, fux[:, t])
                quu = quu + _vx_contract(vx, fuu[:, t])
            quu_reg = quu + reg
            kff = -solve_small(quu_reg, qu)
            kfb = -solve_small(quu_reg, qux)
            kfbt, quxt = mt(kfb), mt(qux)
            vx = qx + mv(mm(kfbt, quu), kff) + mv(kfbt, qu) + mv(quxt, kff)
            vxx = qxx + mm(mm(kfbt, quu), kfb) + mm(kfbt, qux) + mm(quxt, kfb)
            vxx = 0.5 * (vxx + mt(vxx))
            kffs[t], kfbs[t] = kff, kfb
        return torch.stack(kffs, 1), torch.stack(kfbs, 1)

    alphas = filled(cfg.line_search_steps, f, dev)  # [S]
    ns = alphas.shape[0]

    def forward(xs, us, kffs, kfbs):
        """Every step size's rollout at once: [nb, S, H+1, n], [nb, S, H, m]."""
        x = x0[:, None, :].expand(nb, ns, n)
        cand_x, cand_u = [x], []
        for t in range(h):
            u = (us[:, None, t] + alphas[:, None] * kffs[:, None, t]
                 + mv(kfbs[:, None, t], x - xs[:, None, t]))
            x = step_all(x, u)
            cand_x.append(x)
            cand_u.append(u)
        return torch.stack(cand_x, -2), torch.stack(cand_u, -2)

    us = us_init.reshape(nb, h, m)
    xs = rollout(x0, us)
    cost = total_cost(xs, us)
    pick = torch.arange(nb, device=dev)
    for _ in range(cfg.iterations):
        kffs, kfbs = backward(xs, us)
        cand_x, cand_u = forward(xs, us, kffs, kfbs)
        costs = total_cost(cand_x, cand_u)  # [nb, S]
        best = torch.argmin(costs, dim=-1)
        best_cost = costs[pick, best]
        improved = best_cost < cost
        xs = torch.where(improved[:, None, None], cand_x[pick, best], xs)
        us = torch.where(improved[:, None, None], cand_u[pick, best], us)
        cost = torch.where(improved, best_cost, cost)
    return (xs.reshape(batch + (h + 1, n)), us.reshape(batch + (h, m)), cost.reshape(batch))


def ddp_solve(dynamics, stage_cost, terminal_cost, x0, us_init, dt,
              cfg: ILQRConfig = ILQRConfig()):
    """Full DDP (ddp.rs): iLQR + second-order dynamics terms."""
    return ilqr_solve(dynamics, stage_cost, terminal_cost, x0, us_init, dt, cfg, use_ddp=True)


def lqr_regulator(a, b, q, r, iterations: int = 200, tol: float = 1e-9):
    """Infinite-horizon discrete LQR gain K (lqr_control.rs Riccati
    iteration): u = −K x. a [..., n, n], b [..., n, m], q, r."""
    at, bt = mt(a), mt(b)

    def step(p):
        atp = mm(at, p)
        btp = mm(bt, p)
        return (mm(atp, a) - mm(mm(atp, b), solve_small(r + mm(btp, b), mm(btp, a))) + q)

    p = masked_fixpoint(step, q.expand(torch.broadcast_shapes(a.shape, q.shape)), iterations, tol)
    btp = mm(bt, p)
    return solve_small(r + mm(btp, b), mm(btp, a))
