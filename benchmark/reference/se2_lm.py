"""A plain Levenberg–Marquardt solver for SE(2) pose graphs (PyTorch only).

The reference that decides `correct`. It works from the raw request, the
initial guesses, the edge list, the measurements and the information, and
imports nothing of the program. Its semantics are the reference crate's
(slam/src/pose_graph_optimization.rs):

- the edge residual r = [R_ijᵀ(R_iᵀ(t_j − t_i) − t_ij); wrap(θ_j − θ_i −
  θ_ij)] (:178-200) with its analytic Jacobians, the first pose fixed;
- the LM of the crate's solver (solver.rs:81-188): damping λ·max(|diag
  H|, 1) added to the diagonal, a step accepted when it lowers the cost
  (λ × 0.3) and rejected otherwise (λ × 10), a graph stopping when its
  gradient's largest entry or its step's norm falls to `tolerance`, when an
  accepted step changes the cost by at most tolerance², or on a step that
  is not finite.

Its linear algebra is its own: the poses are grouped into blocks of `span`
poses, the largest |to − from| of any edge, so that the damped normal
matrix is block tridiagonal, with blocks of 3·span rows, and each step is
one block Cholesky elimination over the blocks. Graphs of one request are
solved side by side, each with its own damping and stopping.

`precision="float64"` is the reference. `precision="tf32"` is the control
that the comparison must reject: float32 storage, every matrix product
computed as TF32 tensor cores compute it (each operand rounded to TF32's 10
mantissa bits, products accumulated in float32), the factorisations and
triangular solves in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

PRECISIONS = ("float64", "tf32")


def round_tf32(x):
    """float32 x rounded to the nearest TF32 value (10 mantissa bits, ties
    away from zero, as the conversion to TF32 rounds)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Arith:
    """The dtype and the matrix product of one precision."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


class Summary(NamedTuple):
    iterations: torch.Tensor   # [G]
    accepted: torch.Tensor     # [G]
    cost: torch.Tensor         # [G], the last accepted cost
    failed: torch.Tensor       # [G] bool: stopped on a step that was not finite


def _wrap(theta):
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor((theta + math.pi) / two_pi)


def _rot_t(theta):
    """R(θ)ᵀ = [[c, s], [−s, c]] over leading axes."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


def _residuals(ar, x, ef, et, meas):
    """r [G, E, 3] for poses x [G, n, 3]."""
    xi, xj = x[:, ef], x[:, et]
    d = (xj[..., :2] - xi[..., :2])[..., None]
    p = ar.mm(_rot_t(xi[..., 2]), d)[..., 0]
    e_t = ar.mm(_rot_t(meas[..., 2]), (p - meas[..., :2])[..., None])[..., 0]
    e_r = _wrap(xj[..., 2] - xi[..., 2] - meas[..., 2])
    return torch.cat([e_t, e_r[..., None]], -1)


def _linearize(ar, x, ef, et, meas):
    """(r [G, E, 3], A = ∂r/∂x_i, B = ∂r/∂x_j [G, E, 3, 3])."""
    xi, xj = x[:, ef], x[:, et]
    d = (xj[..., :2] - xi[..., :2])[..., None]
    rit = _rot_t(xi[..., 2])
    rijt = _rot_t(meas[..., 2]).expand_as(rit)
    c, s = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    drit = torch.stack([torch.stack([-s, c], -1), torch.stack([-c, -s], -1)], -2)
    p = ar.mm(rit, d)[..., 0]
    e_t = ar.mm(rijt, (p - meas[..., :2])[..., None])[..., 0]
    e_r = _wrap(xj[..., 2] - xi[..., 2] - meas[..., 2])
    r = torch.cat([e_t, e_r[..., None]], -1)
    m = ar.mm(rijt, rit)
    v = ar.mm(rijt, ar.mm(drit, d))[..., 0]
    a = x.new_zeros(*r.shape, 3)
    b = x.new_zeros(*r.shape, 3)
    a[..., :2, :2] = -m
    a[..., :2, 2] = v
    a[..., 2, 2] = -1.0
    b[..., :2, :2] = m
    b[..., 2, 2] = 1.0
    return r, a, b


def _half_cost(ar, r, info):
    lr = ar.mm(info, r[..., None])[..., 0]
    return 0.5 * (r * lr).sum(dim=(-2, -1))


def cost(x, ef, et, meas, info):
    """½ Σ rᵀΛr of poses x [G, n, 3] in float64: [G]."""
    ar = Arith("float64")
    x = torch.as_tensor(x).to(torch.float64)
    dev = x.device
    ef = torch.as_tensor(ef, dtype=torch.int64, device=dev)
    et = torch.as_tensor(et, dtype=torch.int64, device=dev)
    meas = torch.as_tensor(meas).to(device=dev, dtype=torch.float64)
    info = torch.as_tensor(info).to(device=dev, dtype=torch.float64)
    return _half_cost(ar, _residuals(ar, x, ef, et, meas), info)


class Layout(NamedTuple):
    """Where each edge's 3×3 blocks land in the block-tridiagonal system."""

    span: int        # poses a block
    blocks: int      # m
    ii: torch.Tensor     # [E, 9] flat index of (i, i)
    jj: torch.Tensor     # [E, 9] flat index of (j, j)
    rc: torch.Tensor     # [E, 9] flat index of (r, c), the cross term, r in the lower block
    cr: torch.Tensor     # [E, 9] flat index of (c, r) where r and c share a block, else rc
    same: torch.Tensor   # [E] bool: i and j in one block
    i_low: torch.Tensor  # [E] bool: r is i (the cross term is A ᵀΛB, else its transpose)


def layout(n, ef, et, device):
    """The block layout of a graph of n poses with edges (ef, et): blocks of
    `span` poses, span the largest |et − ef|, so that every edge lies in
    one block or in two neighbouring ones. The system is stored flat as m
    diagonal blocks then m − 1 upper blocks, each k × k with k = 3·span."""
    ef = torch.as_tensor(ef, dtype=torch.int64, device=device)
    et = torch.as_tensor(et, dtype=torch.int64, device=device)
    span = max(int((et - ef).abs().max()), 1)
    m = -(-n // span)
    k = 3 * span
    ab = torch.arange(3, device=device)

    def flat(p, q, upper):
        bp, lp, lq = p // span, p % span, q % span
        base = bp * k * k + upper * (m * k * k)
        rows = 3 * lp[:, None, None] + ab[None, :, None]
        cols = 3 * lq[:, None, None] + ab[None, None, :]
        return (base[:, None, None] + rows * k + cols).reshape(-1, 9)

    bi, bj = ef // span, et // span
    i_low = bi <= bj
    r = torch.where(i_low, ef, et)
    c = torch.where(i_low, et, ef)
    same = bi == bj
    rc = flat(r, c, (~same).to(torch.int64))
    cr = torch.where(same[:, None], flat(c, r, torch.zeros_like(r)), rc)
    return Layout(span, m, flat(ef, ef, 0), flat(et, et, 0), rc, cr, same, i_low)


def _assemble(ar, lay, r, a, b, info, ef, et, n, fixed):
    """(D [G, m, k, k], U [G, m−1, k, k], g [G, m, k], diag [G, m, k]) of
    the undamped normal equations, fixed poses' rows and columns the
    identity and their gradient zero, padding poses the identity."""
    g_count = r.shape[0]
    span, m = lay.span, lay.blocks
    k = 3 * span
    la, lb = ar.mm(info, a), ar.mm(info, b)
    at, bt = a.transpose(-1, -2), b.transpose(-1, -2)
    hii, hjj, hij = ar.mm(at, la), ar.mm(bt, lb), ar.mm(at, lb)
    hrc = torch.where(lay.i_low[:, None, None], hij, hij.transpose(-1, -2))
    hcr = torch.where(lay.same[:, None, None], hrc.transpose(-1, -2), torch.zeros_like(hrc))
    buf = r.new_zeros(g_count, (2 * m - 1) * k * k)
    idx = torch.cat([lay.ii, lay.jj, lay.rc, lay.cr]).reshape(-1)
    val = torch.cat([hii, hjj, hrc, hcr], dim=1).reshape(g_count, -1)
    buf.index_add_(1, idx, val)
    lr = ar.mm(info, r[..., None])
    gi, gj = ar.mm(at, lr)[..., 0], ar.mm(bt, lr)[..., 0]
    grad = r.new_zeros(g_count, m * k)
    ab = torch.arange(3, device=r.device)
    grad.index_add_(1, (3 * ef[:, None] + ab).reshape(-1), gi.reshape(g_count, -1))
    grad.index_add_(1, (3 * et[:, None] + ab).reshape(-1), gj.reshape(g_count, -1))
    d = buf[:, :m * k * k].reshape(g_count, m, k, k)
    u = buf[:, m * k * k:].reshape(g_count, m - 1, k, k)
    grad = grad.reshape(g_count, m, k)
    # padding poses past n and fixed poses: identity rows, zero gradient
    pinned = torch.zeros(m * span, dtype=torch.bool, device=r.device)
    pinned[n:] = True
    pinned[list(fixed)] = True
    rows = pinned.repeat_interleave(3).reshape(m, k)
    d = torch.where(rows[None, :, :, None] | rows[None, :, None, :], 0.0, d)
    if m > 1:
        u = torch.where(rows[None, :-1, :, None] | rows[None, 1:, None, :], 0.0, u)
    eye = torch.diag_embed(rows.to(d.dtype))
    d = d + eye
    grad = torch.where(rows[None], 0.0, grad)
    return d, u, grad, d.diagonal(dim1=-2, dim2=-1)


def _block_tridiag_solve(ar, d, u, rhs):
    """x of [D U; Uᵀ D ...] x = rhs by block Cholesky over the m blocks;
    NaN rows for a graph whose system is not positive definite."""
    m = d.shape[1]
    ls, ys, zs = [], [], []
    for t in range(m):
        s, b = d[:, t], rhs[:, t]
        if t:
            yt = ys[-1].transpose(-1, -2)
            s = s - ar.mm(yt, ys[-1])
            b = b - ar.mm(yt, zs[-1][..., None])[..., 0]
        low, info = torch.linalg.cholesky_ex(s)
        low = torch.where((info != 0)[:, None, None], torch.nan, low)
        ls.append(low)
        zs.append(torch.linalg.solve_triangular(low, b[..., None], upper=False)[..., 0])
        if t + 1 < m:
            ys.append(torch.linalg.solve_triangular(low, u[:, t], upper=False))
    x = [None] * m
    for t in reversed(range(m)):
        b = zs[t] if t + 1 == m else zs[t] - ar.mm(ys[t], x[t + 1][..., None])[..., 0]
        x[t] = torch.linalg.solve_triangular(ls[t].transpose(-1, -2), b[..., None],
                                             upper=True)[..., 0]
    return torch.stack(x, 1)


def solve(x0, ef, et, meas, info, *, fixed=(0,), max_iterations=50, tolerance=1e-10,
          precision="float64", initial_damping=1e-3):
    """LM from x0 [G, n, 3] (any device; the graphs share the edges ef, et
    [E], measurements [E, 3] and information [E, 3, 3]). Returns (poses [G,
    n, 3] in the precision's dtype, Summary)."""
    ar = Arith(precision)
    x = torch.as_tensor(x0).to(ar.dtype)
    dev = x.device
    g_count, n = x.shape[0], x.shape[1]
    ef = torch.as_tensor(ef, dtype=torch.int64, device=dev)
    et = torch.as_tensor(et, dtype=torch.int64, device=dev)
    meas = torch.as_tensor(meas).to(device=dev, dtype=ar.dtype)
    info = torch.as_tensor(info).to(device=dev, dtype=ar.dtype)
    lay = layout(n, ef, et, dev)
    m, span = lay.blocks, lay.span
    free = torch.ones(n, 1, dtype=ar.dtype, device=dev)
    free[list(fixed)] = 0.0
    cost = _half_cost(ar, _residuals(ar, x, ef, et, meas), info)
    lam = torch.full((g_count,), initial_damping, dtype=ar.dtype, device=dev)
    done = torch.zeros(g_count, dtype=torch.bool, device=dev)
    failed = torch.zeros_like(done)
    iters = torch.zeros(g_count, dtype=torch.int64, device=dev)
    accepted = torch.zeros_like(iters)
    for _ in range(max_iterations):
        if bool(done.all()):
            break
        r, a, b = _linearize(ar, x, ef, et, meas)
        d, u, grad, diag = _assemble(ar, lay, r, a, b, info, ef, et, n, fixed)
        grad_conv = grad.abs().amax(dim=(-2, -1)) <= tolerance
        damp = lam[:, None, None] * torch.clamp(diag.abs(), min=1.0)
        delta = _block_tridiag_solve(ar, d + torch.diag_embed(damp), u, -grad)
        delta = delta.reshape(g_count, m * span, 3)[:, :n] * free
        finite = torch.isfinite(delta).all(dim=-1).all(dim=-1)
        step_conv = torch.linalg.vector_norm(delta, dim=(-2, -1)) <= tolerance
        trial = x + torch.where(finite[:, None, None], delta, 0.0)
        trial[..., 2] = _wrap(trial[..., 2])
        trial_cost = _half_cost(ar, _residuals(ar, trial, ef, et, meas), info)
        accept = ~done & ~grad_conv & ~step_conv & finite & (trial_cost < cost)
        cost_conv = accept & ((cost - trial_cost).abs() <= tolerance * tolerance)
        stop = done | grad_conv | step_conv | ~finite
        lam = torch.where(stop, lam, torch.where(accept, torch.clamp(lam * 0.3, min=1e-15),
                                                 torch.clamp(lam * 10.0, max=1e15)))
        x = torch.where(accept[:, None, None], trial, x)
        cost = torch.where(accept, trial_cost, cost)
        iters += (~done).to(torch.int64)
        accepted += accept.to(torch.int64)
        failed |= ~done & ~finite
        done = stop | cost_conv
    return x, Summary(iters, accepted, cost, failed)
