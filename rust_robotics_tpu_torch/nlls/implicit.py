"""Implicit-function-theorem gradients through the NLLS solve.

The port of rust_robotics_tpu/nlls/implicit.py. At a (local) optimum θ* of
F(θ, m) the stationarity condition g(θ*, m) = ∇_θ F = 0 defines θ*(m), and

    dθ*/dm = -H⁻¹ · ∂g/∂m,      H = ∇²_θ F(θ*, m).

For a loss L(θ*) the vector-Jacobian product is therefore

    dL/dm = -(∂g/∂m)ᵀ · w,      H w = ∇_θ L(θ*),

one extra linear solve with the Hessian the solver builds (Gauss-Newton:
exact at zero residual, standard elsewhere) or, for `implicit_vjp`, the
exact Hessian of the cost. Manifolds are handled by taking gradients with
respect to the retraction's tangent at δ = 0, as the solver linearises.
The forward solve runs as it is; the backward pass needs only the solution.

Each function keeps the JAX package's functional form and returns
(loss, gradients); no `torch.autograd.Function` is involved. Every
derivative is reverse mode (torch's forward mode promotes 0-d float32
tangents to float64, ROADMAP.md C): the exact Hessian is `jacrev` of
`jacrev`, the mixed derivative (∂g/∂m)ᵀ w is `torch.func.vjp` of
`torch.func.grad`, and the banded IFT applies H from the block Jacobians
its linearisation assembles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device, to_tensor
from rust_robotics_tpu_torch.nlls.banded import _banded_ops, banded_problem
from rust_robotics_tpu_torch.nlls.problem import Problem
from rust_robotics_tpu_torch.nlls.solver import (
    SolverConfig,
    _apply_increment,
    _linearize_dense,
    problem_cost,
    solve,
)
from rust_robotics_tpu_torch.nlls.tridiag import (
    _info_vec,
    _jt_vec,
    build_w_inv,
    chain_edge_partition,
    chain_linearize,
    chain_woodbury_solve,
    classify_chain_edges,
    full_fp32_matmul,
    has_full_chain,
    small_mm,
)


def _cost_with_measurements(problem: Problem, values_tuple, meas_list):
    """Total cost with each block's measurement replaced (robust kernels
    included, solver.rs:274 semantics)."""
    blocks = tuple(dataclasses.replace(b, measurement=m)
                   for b, m in zip(problem.factors, meas_list))
    return problem_cost(dataclasses.replace(problem, factors=blocks), values_tuple)


def implicit_vjp(problem: Problem, loss_fn, hessian: str = "exact"):
    """Gradients of `loss_fn(values_tuple)` at the solution with respect to
    each factor block's measurement.

    problem: an ALREADY SOLVED Problem (run `solve` first). loss_fn maps the
    values tuple to a scalar tensor.

    hessian: "exact" (the cost's Hessian, `jacrev` of `jacrev`: the true
    IFT, needed where the residuals at the optimum are not near zero, since
    Gauss-Newton drops the ∂J·r curvature) or "gauss_newton" (the solver's
    JᵀΛJ: cheaper, exact only at zero residual).

    Returns (loss, grads): grads is a list aligned with problem.factors of
    dL/d(measurement), None where a block has no measurement."""
    values = problem.values()
    dtype = values[0].dtype
    _, total = problem.layout()
    meas = [b.measurement for b in problem.factors]
    zero = torch.zeros((total,), dtype=dtype, device=values[0].device)

    # u = tangent-space gradient of the loss at θ*
    u, loss = torch.func.grad_and_value(
        lambda d: loss_fn(_apply_increment(problem, values, d)))(zero)

    def cost_of_delta(delta, meas_list=meas):
        return _cost_with_measurements(problem, _apply_increment(problem, values, delta),
                                       meas_list)

    # H w = u (fixed rows forced to the identity)
    h, _, _, fixed_diag = _linearize_dense(problem, values, dtype)
    if hessian == "exact":
        h = torch.func.jacrev(torch.func.jacrev(cost_of_delta))(zero)
        h = torch.where(fixed_diag[:, None] | fixed_diag[None, :], 0.0, h)
        h = h + torch.diag(fixed_diag.to(dtype))
    w = torch.where(fixed_diag, 0.0, torch.linalg.solve(h, u))

    # dL/dm = -(∂g/∂m)ᵀ w: one vjp of the tangent gradient in m
    present = [k for k, m in enumerate(meas) if m is not None]

    def tangent_grad(*given):
        meas_list = list(meas)
        for k, m in zip(present, given):
            meas_list[k] = m
        return torch.func.grad(lambda d: cost_of_delta(d, meas_list))(zero)

    _, pullback = torch.func.vjp(tangent_grad, *(meas[k] for k in present))
    grads = [None] * len(meas)
    for k, g in zip(present, pullback(-w)):
        grads[k] = g
    return loss, grads


def solve_implicit(problem: Problem, loss_fn, config: SolverConfig = SolverConfig()):
    """Solve, then return (solved problem, summary, loss, measurement
    grads): the one-call form of `solve` + `implicit_vjp`."""
    solved, summary = solve(problem, config)
    loss, grads = implicit_vjp(solved, loss_fn)
    return solved, summary, loss, grads


# ---------------------------------------------------------------------------
# Chain-structured problems (O(n): the chain solver's own linear algebra)
# ---------------------------------------------------------------------------

def _edge_cost_grad(residual_fn, retract_all, zero, edge_sets):
    """tangent_grad(*meas) -> ∇_δ ½Σ rᵀΛr at δ = 0, for edge sets (from [E],
    to [E], info [E, r, r] or None) whose measurements are the arguments."""
    def tangent_grad(*meas):
        def cost_of(delta):
            v = retract_all(delta)
            cost = 0.0
            for (ef, et, info), m in zip(edge_sets, meas):
                if not len(ef):  # vmap takes no empty batch
                    continue
                r = torch.func.vmap(residual_fn)(v[ef], v[et], m)
                cost = cost + 0.5 * torch.sum(r * _info_vec(info, r))
            return cost

        return torch.func.grad(cost_of)(zero)
    return tangent_grad


def _retractor(values, fixed, retract_fn):
    def retract_all(delta):
        return torch.func.vmap(retract_fn)(values, torch.where(fixed[:, None], 0.0, delta))
    return retract_all


@full_fp32_matmul()
def chain_implicit_vjp(values, chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info,
                       fixed_mask, loss_fn, *, residual_fn, retract_fn, tdim):
    """IFT gradients through `solve_chain_lm`'s solution at full scale: H w
    = u is solved by the forward pass's block-tridiagonal ladder and
    streamed Woodbury (O(n) memory), not a dense [D, D] solve.

    values: the SOLVED chain values [n, dim]; loss_fn(values [n, dim]) ->
    scalar; the other arguments as `solve_chain_lm`, on values' device. The
    Gauss-Newton Hessian, undamped; the capacitance system is solved by LU
    (spd=False): f32 assembly of the undamped system can make it
    indefinite, and this one-shot solve has no LM retry.

    Returns (loss, d_chain_meas [n-1, rdim], d_loop_meas [L, rdim])."""
    n = values.shape[0]
    num_l = loop_from.shape[0]
    rdim = chain_meas.shape[-1]
    fixed = fixed_mask
    zero = values.new_zeros((n, tdim))
    retract_all = _retractor(values, fixed, retract_fn)

    # u = tangent-space gradient of the loss at the optimum
    u, loss = torch.func.grad_and_value(lambda d: loss_fn(retract_all(d)))(zero)
    u = torch.where(fixed[:, None], 0.0, u)

    # H w = u with the chain's Gauss-Newton Hessian (fixed rows -> identity)
    _, b, c, jac_loop, _, _ = chain_linearize(
        values, chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info, fixed,
        residual_fn=residual_fn, retract_fn=retract_fn, tdim=tdim)
    bd = torch.where(fixed[:, None, None], torch.eye(tdim, dtype=values.dtype,
                                                     device=values.device), b)
    w_inv = build_w_inv(loop_info, num_l, rdim, values.dtype, values.device) if num_l else None
    w = chain_woodbury_solve(bd, c, jac_loop, loop_from, loop_to, w_inv, u, spd=False)
    w = torch.where(fixed[:, None], 0.0, w)

    # dL/dm = -(∂g/∂m)ᵀ w
    ar = torch.arange(n, device=values.device)
    tangent_grad = _edge_cost_grad(residual_fn, retract_all, zero,
                                   ((ar[:-1], ar[1:], chain_info),
                                    (loop_from, loop_to, loop_info)))
    _, pullback = torch.func.vjp(tangent_grad, chain_meas, loop_meas)
    d_chain, d_loop = pullback(-w)
    return loss, d_chain, d_loop


# ---------------------------------------------------------------------------
# General graphs (the banded supernodal engine)
# ---------------------------------------------------------------------------

@full_fp32_matmul()
def banded_implicit_vjp(values_b, band_from, band_to, band_meas, band_info, loop_from, loop_to,
                        loop_meas, loop_info, fixed_mask, loss_fn, *, residual_fn, retract_fn,
                        tdim, supernode, num_super, fat_solve=None, ift_damping=1e-7,
                        ift_refine=3):
    """IFT gradients through `solve_banded_lm`'s solution on any topology:
    H w = u by the forward pass's fat-block ladder and streamed Woodbury.

    The band-only T may be singular on its own (the in-band subgraph need
    not be connected; the closures make H nonsingular), and the Woodbury
    identity needs T invertible. So the solve runs at a small scaled
    damping `ift_damping` and removes it by `ift_refine` passes of
    iterative refinement, w += M⁻¹(u − H w), with H applied from the fat
    blocks and loop Jacobians the linearisation assembles: the undamped
    Gauss-Newton IFT solution, approached at ~δ·diag/λmin(H) a pass.

    Arguments as `solve_banded_lm` (banded node order); values_b must be
    the SOLVED values; loss_fn(values_b [n, dim]) -> scalar, in banded
    order. Returns (loss, d_band_meas [Eb, rdim], d_loop_meas [L, rdim])."""
    n = values_b.shape[0]
    num_l = loop_from.shape[0]
    f_ = values_b.dtype
    fixed = fixed_mask
    s, t = supernode, tdim
    big, n_pad = s * t, s * num_super
    zero = values_b.new_zeros((n, tdim))
    retract_all = _retractor(values_b, fixed, retract_fn)

    linearize, _, lin_solve, _ = _banded_ops(
        n, band_from, band_to, band_meas, band_info, loop_from, loop_to, loop_meas, loop_info,
        fixed, f_, residual_fn=residual_fn, retract_fn=retract_fn, tdim=tdim,
        supernode=supernode, num_super=num_super, fat_solve=fat_solve)

    # u = tangent-space gradient of the loss at the optimum
    u, loss = torch.func.grad_and_value(lambda d: loss_fn(retract_all(d)))(zero)
    u = torch.where(fixed[:, None], 0.0, u)

    _, d, up_raw, jac_loop, diag_loop, _ = linearize(values_b)
    up = up_raw[:num_super - 1]

    def pad(v):
        return torch.cat([v, v.new_zeros((n_pad - n, t))]) if n_pad > n else v

    def gn_matvec(v):
        """H v = Jᵀ Λ J v: the undamped fat blocks (fixed and padding rows
        are zero there) and the loop edges' Jacobians."""
        v = torch.where(fixed[:, None], 0.0, v)
        vs = pad(v).reshape(num_super, big)
        hv = (d @ vs[..., None])[..., 0]
        hv[:-1] += (up @ vs[1:, :, None])[..., 0]
        hv[1:] += (up.mT @ vs[:-1, :, None])[..., 0]
        hv = hv.reshape(n_pad, t)[:n]
        if num_l:
            ji_l, jj_l = jac_loop
            lam = _info_vec(loop_info, small_mm(ji_l, v[loop_from, :, None])[..., 0]
                            + small_mm(jj_l, v[loop_to, :, None])[..., 0])
            hv = hv.index_add(0, loop_from, _jt_vec(ji_l, lam))
            hv = hv.index_add(0, loop_to, _jt_vec(jj_l, lam))
        return torch.where(fixed[:, None], 0.0, hv)

    # (H + δD) w = u, refined to H w = u: lin_solve solves M delta = -grad
    # with fixed and padding rows as the identity, so pass grad = -rhs
    damp = torch.as_tensor(ift_damping, dtype=f_, device=values_b.device)

    def solve_m(rhs):
        out = lin_solve(-pad(rhs), d, up_raw, jac_loop, diag_loop, damp)
        return torch.where(fixed[:, None], 0.0, out)

    w = solve_m(u)
    for _ in range(ift_refine):
        w = w + solve_m(u - gn_matvec(w))

    # dL/dm = -(∂g/∂m)ᵀ w
    tangent_grad = _edge_cost_grad(residual_fn, retract_all, zero,
                                   ((band_from, band_to, band_info),
                                    (loop_from, loop_to, loop_info)))
    _, pullback = torch.func.vjp(tangent_grad, band_meas, loop_meas)
    d_band, d_loop = pullback(-w)
    return loss, d_band, d_loop


def general_graph_implicit_vjp(values_solution, edges_from, edges_to, measurements, information,
                               fixed_mask, loss_fn, *, residual_fn, retract_fn, tdim,
                               max_supernode=256, fat_solve=None):
    """IFT gradients of `loss_fn(values [N, dim])` (original node order) with
    respect to every edge measurement, for any topology solved by
    `solve_general_graph`: the same deterministic `plan_banded` plan as the
    forward solve, `banded_implicit_vjp` in banded order, and the gradients
    scattered back to the original edge order.

    values_solution: the solution tensor, which sets device and dtype; the
    edge arrays may be numpy or tensors. Returns (loss, d_measurements
    [E, rdim]) on values_solution's device."""
    values = values_solution
    plan, values_b, args = banded_problem(values, edges_from, edges_to, measurements,
                                          information, fixed_mask, tdim=tdim,
                                          max_supernode=max_supernode)
    perm = torch.as_tensor(plan.perm, dtype=torch.int64, device=values.device)
    loss, d_band, d_loop = banded_implicit_vjp(
        values_b, *args, lambda vb: loss_fn(vb[perm]), residual_fn=residual_fn,
        retract_fn=retract_fn, tdim=tdim, supernode=plan.supernode, num_super=plan.num_super,
        fat_solve=fat_solve)
    return loss, _scatter_edges(len(plan.in_band), (np.nonzero(plan.in_band)[0], d_band),
                                (np.nonzero(~plan.in_band)[0], d_loop))


def _scatter_edges(num_e, *parts):
    """[E, rdim] from (edge ids, rows) parts that cover every edge once."""
    first = parts[0][1]
    out = first.new_zeros((num_e, first.shape[-1]))
    for idx, rows in parts:
        out[torch.as_tensor(idx, dtype=torch.int64, device=out.device)] = rows
    return out


def pose_graph_implicit_vjp(poses_solution, edges_from, edges_to, measurements, information,
                            loss_fn, fix_first=True, device=None, dtype=None):
    """SE(2) pose graph: IFT gradients of `loss_fn(poses [N, 3])` with
    respect to EVERY edge measurement, at full scale. Routes as the forward
    `linear_solver="direct"`: the chain IFT when every (i, i+1) pair has an
    edge, the banded general-graph IFT otherwise. `poses_solution` must be
    the optimum; host arrays (or tensors) go to `device` (default cuda) in
    `dtype` (default: a tensor's own dtype, else float32). Returns (loss,
    d_measurements [E, 3] in the original edge order) on that device."""
    from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

    device = resolve_device(device)
    if dtype is None:
        dtype = (poses_solution.dtype if isinstance(poses_solution, torch.Tensor)
                 else torch.float32)
    poses = to_tensor(poses_solution, device, dtype)
    n = poses.shape[0]

    if not has_full_chain(n, edges_from, edges_to):
        fixed = np.zeros((n,), bool)
        fixed[0] = fix_first
        return general_graph_implicit_vjp(poses, edges_from, edges_to, measurements,
                                          information, fixed, loss_fn,
                                          residual_fn=se2_edge_residual, retract_fn=se2_retract,
                                          tdim=3)

    (chain_meas, chain_info, loop_ef, loop_et, loop_meas,
     loop_info) = classify_chain_edges(n, edges_from, edges_to, measurements, information)
    fixed = torch.zeros((n,), dtype=torch.bool, device=device)
    fixed[0] = fix_first
    loss, d_chain, d_loop = chain_implicit_vjp(
        poses, to_tensor(chain_meas, device, dtype),
        None if chain_info is None else to_tensor(chain_info, device, dtype),
        to_tensor(loop_ef, device, torch.int64), to_tensor(loop_et, device, torch.int64),
        to_tensor(loop_meas, device, dtype),
        None if loop_info is None else to_tensor(loop_info, device, dtype),
        fixed, loss_fn, residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3)
    # back to the original edge order, by the forward classification's
    # partition
    first_idx, is_chain = chain_edge_partition(n, edges_from, edges_to)
    return loss, _scatter_edges(len(is_chain), (first_idx, d_chain),
                                (np.nonzero(~is_chain)[0], d_loop))
