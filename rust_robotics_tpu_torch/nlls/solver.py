"""Gauss-Newton / Levenberg-Marquardt solver over factor blocks.

The port of rust_robotics_tpu/nlls/solver.py (reference:
rust_robotics_optimization/src/solver.rs — the LM loop with trial-step
accept/reject and the ×0.3/×10 damping schedule (:81-188), linearisation
into a block Hessian with robust IRLS weights (:216-258), scaled LM damping
diag += λ·max(|d|, 1) (sparse.rs:34-42), cost = Σ ½ρ(rᵀΛr) (:274); linear
solvers dense (sparse.rs:52), block-Jacobi PCG (sparse.rs:115) and Schur
elimination of the trailing group (sparse.rs:160)).

- Linearisation is one `torch.func.vmap` over a block's factors of a
  Jacobian through the groups' retractions at δ=0: J_k = ∂r/∂δ_k,
  [F, rdim, tdim_k]. It is taken in reverse mode (`torch.func.jacrev`),
  where the JAX package takes `jax.jacfwd`: the derivative is the same, but
  PyTorch's forward mode promotes the tangent of a 0-d float32 tensor
  combined with a Python scalar (`x * 0.5`, `x + 1.0`) to float64, and the
  next matmul of a float32 residual then fails; reverse mode keeps float32.
  For BA it also costs rdim = 2 passes instead of tdim = 9.
- Assembly scatters into a dense [D, D] Hessian by `scatter_add_`:
  `index_put_(accumulate=True)` on CUDA (sort-based, the same sums every
  run), a flat `index_add_` on the CPU, where torch's `index_put_` adds
  repeated indices in the order its threads take them, so that a CPU run
  on fixed inputs gave other bits, and once a non-finite f32 BA step, from
  run to run (ROADMAP C8). CUDA and the CPU add in different orders, so
  f32 results differ from the CPU's in the last bits.
- `matfree_pcg` never builds H: H·v streams over the cached factor
  Jacobians; the preconditioner is batched [N, t, t] inverses.
- Schur eliminates the LAST group, whose diagonal blocks are independent
  (the BA landmarks): batched [N, t, t] inverses and two dense products
  (full FP32, as every product here), then the retained system goes
  to `_reduced_solve`, which routes to the blocked-Cholesky kernel
  (`ops/cholesky.py`, kernel B4) as the JAX package routes to its Pallas
  kernel.
- `solve` and `solve_device`'s step run under `full_fp32_matmul`: float32
  products at full precision whatever the caller's
  `torch.set_float32_matmul_precision` (the North star's numerics rule; a
  guard the JAX package's solver does not have, ROADMAP C7).
- `solve` runs the LM loop on the host, with the reference's termination
  semantics; each PCG `while_loop` is a Python loop with the same test.
- `solve_device` keeps the whole LM on the device (dense or matfree_pcg):
  accept, damping and termination are tensors, a solve that is done
  freezes by `torch.where` as the JAX `while_loop`'s carry does, and the
  PCG runs its full budget of masked steps, whose iterates equal the
  stopping loop's. An iteration reads nothing back; the loop reads `done`
  once every `DONE_READ_EVERY` iterations to stop early, and the summary
  comes back in one read at the end. On the card each iteration is one
  replay of a CUDA graph of the step (`_graphed_step`: the same kernels in
  the same order, so bitwise the eager step), with the problem's tensors
  as the graph's inputs, so one graph serves every problem of one shape.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch

from rust_robotics_tpu_torch._graphs import Graphed, kept, meta
from rust_robotics_tpu_torch.nlls.problem import FactorBlock, Problem
from rust_robotics_tpu_torch.nlls.tridiag import TERMINATION_NAMES, full_fp32_matmul
from rust_robotics_tpu_torch.ops.cholesky import cholesky_solve_blocked
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """solver.rs:34-56 defaults."""

    method: str = "lm"  # "gn" | "lm"
    max_iterations: int = 50
    gradient_tolerance: float = 1e-10
    step_tolerance: float = 1e-10
    cost_tolerance: float = 1e-12
    initial_damping: float = 1e-3
    linear_solver: str = "dense"  # "dense" | "pcg" | "matfree_pcg" | "schur"
    pcg_max_iterations: int = 200
    pcg_tolerance: float = 1e-10
    # The retained (camera) system of the Schur path. "pallas_chol" keeps
    # the JAX package's name so that configurations carry across; here it
    # means the port's blocked Cholesky, `ops.cholesky.cholesky_solve_blocked`
    # (kernel B4 on a CUDA tensor, its plain twin on a CPU tensor). "auto"
    # takes that kernel for a CUDA float32 system of n >= 1024, as the JAX
    # package takes its Pallas kernel on a TPU; "dense" (and "auto"
    # otherwise) is `torch.linalg.solve`.
    reduced_solver: str = "auto"  # "auto" | "pallas_chol" | "dense"


@dataclasses.dataclass
class SolverSummary:
    initial_cost: float
    final_cost: float
    iterations: int
    accepted_steps: int
    termination: str
    linear_iterations: int


def _gather(block: FactorBlock, values, k):
    return values[block.indices[:, k].long()]


def _block_eval(block: FactorBlock, group_values: dict):
    """Residuals [F, rdim] for one factor block."""
    vals = [_gather(block, group_values[g], k) for k, g in enumerate(block.groups)]
    if block.measurement is None:
        return torch.func.vmap(block.residual)(*vals)
    return torch.func.vmap(block.residual)(*vals, block.measurement)


def _weighted(block: FactorBlock, r):
    """(Λr, e², robust value, robust weight)."""
    if block.information is None:
        wr = r
    else:
        wr = torch.einsum("fij,fj->fi", block.information, r)
    e2 = torch.sum(r * wr, dim=-1)
    val, w = block.robust.evaluate(e2)
    return wr, e2, val, w


def problem_cost(problem: Problem, values_tuple):
    """Σ ½ ρ(rᵀΛr) (solver.rs:274)."""
    gv = {g.name: v for g, v in zip(problem.groups, values_tuple)}
    cost = 0.0
    for block in problem.factors:
        r = _block_eval(block, gv)
        _, _, val, _ = _weighted(block, r)
        cost = cost + 0.5 * torch.sum(val)
    return cost


def _block_jacobians(problem: Problem, block: FactorBlock, gv: dict):
    """Residuals [F, rdim] and the tangent-space Jacobians per slot, a list
    of [F, rdim, tdim_k]: vmap over factors of jacrev through the
    retractions at δ=0 (see the module's note on forward mode)."""
    groups = {g.name: g for g in problem.groups}
    vals = [_gather(block, gv[g], k) for k, g in enumerate(block.groups)]
    retracts = [groups[g].retract for g in block.groups]
    arity = len(vals)
    zeros = [torch.zeros((groups[g].tdim,), dtype=vals[0].dtype, device=vals[0].device)
             for g in block.groups]
    has_m = block.measurement is not None

    def per_factor(*args):
        vs = args[:arity]
        extra = args[arity:]

        def f(*deltas):
            xs = [ret(v, d) for ret, v, d in zip(retracts, vs, deltas)]
            r = block.residual(*xs, *extra)
            return r, r

        jacs, r = torch.func.jacrev(f, argnums=tuple(range(arity)), has_aux=True)(*zeros)
        return r, jacs

    m_args = (block.measurement,) if has_m else ()
    r, jacs = torch.func.vmap(per_factor)(*vals, *m_args)
    return r, list(jacs)


def scatter_add_(out, index, values):
    """out[index] += values in place, summing repeated indices; index is a
    tuple of index tensors over out's leading dims, as `index_put_` takes
    it. Deterministic on both devices: `index_put_(accumulate=True)` on
    CUDA (sort-based), a flat `index_add_` on the CPU (torch's CPU
    `index_put_` accumulates in thread order). Returns out."""
    if out.is_cuda:
        return out.index_put_(index, values, accumulate=True)
    if len(index) == 1:
        return out.index_add_(0, index[0].reshape(-1), values.reshape(-1, *out.shape[1:]))
    flat = index[0]
    for k in range(1, len(index)):
        flat = flat * out.shape[k] + index[k]
    out.view(-1).index_add_(0, flat.reshape(-1), values.reshape(-1))
    return out


def _tangent_rows(offset, idx, tdim):
    """Global rows [F, tdim] of the variables idx [F] of a group at offset."""
    return (offset + idx.long() * tdim)[:, None] + torch.arange(tdim, device=idx.device)[None, :]


def _fixed_rows(problem: Problem):
    """[D] bool: the tangent rows of fixed variables (groups in layout order)."""
    return torch.cat([g.fixed()[:, None].expand(g.num, g.tdim).reshape(-1) for g in problem.groups])


def _linearize_dense(problem: Problem, values_tuple, dtype):
    """Dense Hessian [D, D], gradient [D], cost — one pass over blocks."""
    gv = {g.name: v for g, v in zip(problem.groups, values_tuple)}
    offsets, total = problem.layout()
    groups = {g.name: g for g in problem.groups}
    device = values_tuple[0].device
    h = torch.zeros((total, total), dtype=dtype, device=device)
    grad = torch.zeros((total,), dtype=dtype, device=device)
    cost = 0.0

    for block in problem.factors:
        r, jacs = _block_jacobians(problem, block, gv)
        wr, e2, val, w = _weighted(block, r)
        cost = cost + 0.5 * torch.sum(val)
        # zero Jacobian columns of fixed variables
        for k, gname in enumerate(block.groups):
            fixed = groups[gname].fixed()[block.indices[:, k].long()]
            jacs[k] = torch.where(fixed[:, None, None], 0.0, jacs[k])
        lam_j = [
            jacs[k] if block.information is None
            else torch.einsum("fij,fjk->fik", block.information, jacs[k])
            for k in range(block.arity)
        ]
        for k_i, gname_i in enumerate(block.groups):
            rows = _tangent_rows(offsets[gname_i], block.indices[:, k_i], groups[gname_i].tdim)
            g_contrib = w[:, None] * torch.einsum("fri,fr->fi", jacs[k_i], wr)
            scatter_add_(grad, (rows,), g_contrib)
            for k_j, gname_j in enumerate(block.groups):
                cols = _tangent_rows(offsets[gname_j], block.indices[:, k_j],
                                     groups[gname_j].tdim)
                blk = w[:, None, None] * torch.einsum("fri,frj->fij", jacs[k_i], lam_j[k_j])
                scatter_add_(h, (rows[:, :, None], cols[:, None, :]), blk)

    # fixed variables: unit diagonal, zero gradient (h is this call's own
    # tensor, so its diagonal is updated in place)
    fixed_diag = _fixed_rows(problem)
    diag = h.diagonal()
    diag.add_(torch.where(fixed_diag & (diag == 0), 1.0, 0.0).to(dtype))
    grad = torch.where(fixed_diag, 0.0, grad)
    return h, grad, cost, fixed_diag


def _add_damping(h, damping):
    """sparse.rs:34-42: diag += λ·max(|diag|, 1), on a copy of h."""
    hd = h.clone()
    d = hd.diagonal()
    d.add_(damping * torch.clamp(torch.abs(d), min=1.0))
    return hd


def _linearize_matfree(problem: Problem, values_tuple, dtype):
    """Linearise WITHOUT assembling H: returns (jac_cache, grad, cost,
    fixed_diag, diag_blocks). jac_cache holds per-block (jacs, w);
    diag_blocks holds per-group [N, t, t] Hessian diagonal blocks (the
    block-Jacobi preconditioner data, sparse.rs:115). Memory is O(edges),
    never O(params²)."""
    gv = {g.name: v for g, v in zip(problem.groups, values_tuple)}
    offsets, total = problem.layout()
    groups = {g.name: g for g in problem.groups}
    device = values_tuple[0].device
    grad = torch.zeros((total,), dtype=dtype, device=device)
    cost = 0.0
    diag_blocks = {g.name: torch.zeros((g.num, g.tdim, g.tdim), dtype=dtype, device=device)
                   for g in problem.groups}
    cache = []
    for block in problem.factors:
        r, jacs = _block_jacobians(problem, block, gv)
        wr, e2, val, w = _weighted(block, r)
        cost = cost + 0.5 * torch.sum(val)
        for k, gname in enumerate(block.groups):
            fixed = groups[gname].fixed()[block.indices[:, k].long()]
            jacs[k] = torch.where(fixed[:, None, None], 0.0, jacs[k])
        cache.append((tuple(jacs), w))
        for k_i, gname_i in enumerate(block.groups):
            rows = _tangent_rows(offsets[gname_i], block.indices[:, k_i], groups[gname_i].tdim)
            scatter_add_(grad, (rows,), w[:, None] * torch.einsum("fri,fr->fi", jacs[k_i], wr))
            lam_jk = (jacs[k_i] if block.information is None
                      else torch.einsum("fij,fjk->fik", block.information, jacs[k_i]))
            contrib = w[:, None, None] * torch.einsum("fri,frj->fij", jacs[k_i], lam_jk)
            scatter_add_(diag_blocks[gname_i], (block.indices[:, k_i].long(),), contrib)

    fixed_diag = _fixed_rows(problem)
    for g in problem.groups:
        # fixed variables get identity diagonal blocks
        eye = torch.eye(g.tdim, dtype=dtype, device=device)
        diag_blocks[g.name] = torch.where(g.fixed()[:, None, None], eye[None], diag_blocks[g.name])
    grad = torch.where(fixed_diag, 0.0, grad)
    return (tuple(cache), grad, cost, fixed_diag,
            tuple(diag_blocks[g.name] for g in problem.groups))


def _pcg(hvp, precond, b, max_iter, tol):
    """Preconditioned CG from x=0 for hvp(x) = b; stops when |r| <= tol or
    after max_iter steps (the JAX while_loop's test, read on the host).
    Returns (x, iterations)."""
    x = torch.zeros_like(b)
    r = b
    z = precond(b)
    p = z
    rz = b @ z
    k = 0
    while float(torch.linalg.norm(r)) > tol and k < max_iter:
        hp = hvp(p)
        alpha = rz / torch.clamp(p @ hp, min=1e-300)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = r @ z
        beta = rz_new / torch.clamp(rz, min=1e-300)
        p = z + beta * p
        k, rz = k + 1, rz_new
    return x, k


def _pcg_masked(hvp, precond, b, max_iter, tol):
    """`_pcg` with no read-back: max_iter steps, each masked by the
    stopping loop's test |r| > tol, so the iterates equal `_pcg`'s and a
    converged solve stands still. Returns (x, iterations as a tensor)."""
    x = torch.zeros_like(b)
    r = b
    z = precond(b)
    p = z
    rz = b @ z
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(max_iter):
        active = torch.linalg.norm(r) > tol
        hp = hvp(p)
        alpha = rz / torch.clamp(p @ hp, min=1e-300)
        r_new = r - alpha * hp
        z = precond(r_new)
        rz_new = r_new @ z
        beta = rz_new / torch.clamp(rz, min=1e-300)
        x = torch.where(active, x + alpha * p, x)
        p = torch.where(active, z + beta * p, p)
        r = torch.where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
        k = k + active.to(torch.int32)
    return x, k


def _solve_matfree_pcg(problem: Problem, cache, grad, fixed_diag, diag_blocks, damping, lm,
                       max_iter, tol, pcg=_pcg):
    """Matrix-free block-Jacobi PCG: H·v streams over the cached factor
    Jacobians (gather → J v → Λ → Jᵀ → scatter-add); the preconditioner is
    batched [N, t, t] SPD inverses of the damped diagonal blocks."""
    offsets, total = problem.layout()

    # damped diagonal: diag += λ·max(|diag|, 1) (sparse.rs:34-42)
    damp_parts = []
    pre_inv = []
    for g, db in zip(problem.groups, diag_blocks):
        d = torch.diagonal(db, dim1=-2, dim2=-1)  # [N, t]
        lam = damping * torch.clamp(torch.abs(d), min=1.0) if lm else torch.zeros_like(d)
        damp_parts.append(lam.reshape(-1))
        pre_inv.append(inv_spd_small(db + torch.diag_embed(lam)))
    damp_vec = torch.cat(damp_parts)
    # fixed rows act as the identity
    damp_vec = torch.where(fixed_diag, 1.0, damp_vec)

    def precond(r):
        outs = []
        for g, inv in zip(problem.groups, pre_inv):
            off = offsets[g.name]
            rg = r[off:off + g.num * g.tdim].reshape(g.num, g.tdim)
            outs.append(torch.einsum("nij,nj->ni", inv, rg).reshape(-1))
        return torch.cat(outs)

    def hvp(v):
        out = damp_vec * v
        for block, (jacs, w) in zip(problem.factors, cache):
            jv = None
            for k, gname in enumerate(block.groups):
                cols = _tangent_rows(offsets[gname], block.indices[:, k], jacs[k].shape[-1])
                term = torch.einsum("frt,ft->fr", jacs[k], v[cols])
                jv = term if jv is None else jv + term
            lam_jv = (jv if block.information is None
                      else torch.einsum("fij,fj->fi", block.information, jv))
            for k, gname in enumerate(block.groups):
                rows = _tangent_rows(offsets[gname], block.indices[:, k], jacs[k].shape[-1])
                scatter_add_(out, (rows,), w[:, None] * torch.einsum("fri,fr->fi", jacs[k], lam_jv))
        return out

    return pcg(hvp, precond, -grad, max_iter, tol)


def _solve_dense(h, grad, damping, lm):
    hd = _add_damping(h, damping) if lm else h
    return torch.linalg.solve(hd, -grad), 1


def _group_rows(off, num, tdim, device):
    """[num, tdim] global rows of a group's variables."""
    ar = torch.arange
    return off + ar(num, device=device)[:, None] * tdim + ar(tdim, device=device)[None, :]


def _solve_pcg(h, grad, damping, lm, groups_meta, max_iter, tol):
    """PCG with a block-Jacobi preconditioner on the (damped) dense H."""
    hd = _add_damping(h, damping) if lm else h
    # block-Jacobi: invert per-variable diagonal blocks
    pre = torch.zeros_like(h)
    for off, num, tdim in groups_meta:
        idx = _group_rows(off, num, tdim, h.device)
        blocks = hd[idx[:, :, None], idx[:, None, :]]  # [N, t, t]
        pre[idx[:, :, None], idx[:, None, :]] = inv_spd_small(blocks)
    return _pcg(lambda p: hd @ p, lambda r: pre @ r, -grad, max_iter, tol)


def _reduced_solve(s, rhs, reduced_solver):
    """Retained-system solve for the Schur path (see `SolverConfig`)."""
    use_kernel = reduced_solver == "pallas_chol" or (
        reduced_solver == "auto"
        and s.is_cuda
        and s.shape[0] >= 1024
        and s.dtype == torch.float32
    )
    if use_kernel:
        return cholesky_solve_blocked(s, rhs)
    return torch.linalg.solve(s, rhs)


def _schur_system(h, grad, damping, lm, retained_dim, elim_meta):
    """Eliminate the trailing group (block-diagonal [N, t, t] inverses):
    returns the retained system (s, rhs) and `back(dx_r)`, which gives the
    eliminated group's increment (sparse.rs:160 semantics)."""
    hd = _add_damping(h, damping) if lm else h
    dr = retained_dim
    num, tdim = elim_meta
    h_rr = hd[:dr, :dr]
    h_rl = hd[:dr, dr:]
    g_r = grad[:dr]
    g_l = grad[dr:]
    idx = _group_rows(dr, num, tdim, h.device)
    inv = inv_spd_small(hd[idx[:, :, None], idx[:, None, :]])  # [N, t, t]

    def ll_inv_mul(v):
        """H_ll⁻¹ v with H_ll taken as its diagonal blocks."""
        return (inv @ v.reshape(num, tdim, -1)).reshape(num * tdim, -1)

    s = h_rr - h_rl @ ll_inv_mul(h_rl.T)
    rhs = -g_r + (h_rl @ ll_inv_mul(g_l[:, None]))[:, 0]

    def back(dx_r):
        return ll_inv_mul((-g_l - h_rl.T @ dx_r)[:, None])[:, 0]

    return s, rhs, back


def _solve_schur(h, grad, damping, lm, retained_dim, elim_meta, reduced_solver="auto"):
    """Eliminate the trailing group, then solve the retained system."""
    s, rhs, back = _schur_system(h, grad, damping, lm, retained_dim, elim_meta)
    dx_r = _reduced_solve(s, rhs, reduced_solver)
    return torch.cat([dx_r, back(dx_r)]), 1


def _apply_increment(problem: Problem, values_tuple, delta):
    offsets, _ = problem.layout()
    new_values = []
    for g, v in zip(problem.groups, values_tuple):
        off = offsets[g.name]
        d = delta[off:off + g.num * g.tdim].reshape(g.num, g.tdim)
        d = torch.where(g.fixed()[:, None], 0.0, d)
        new_values.append(torch.func.vmap(g.retract)(v, d))
    return tuple(new_values)


@full_fp32_matmul()
def solve(problem: Problem, config: SolverConfig = SolverConfig()):
    """Run the solver; returns (solved Problem, SolverSummary).

    The LM loop runs on the host, with the reference's termination
    semantics (solver.rs:81-188); each iteration reads the gradient's max,
    the step's norm and the trial cost back to the host. Every route runs
    with float32 products at full precision (TF32 off), whatever the
    caller's `torch.set_float32_matmul_precision`.
    """
    values = problem.values()
    dtype = values[0].dtype
    offsets, total = problem.layout()
    if total == 0:
        c = float(problem_cost(problem, values))
        return problem, SolverSummary(c, c, 0, 0, "gradient_converged", 0)

    groups_meta = tuple((offsets[g.name], g.num, g.tdim) for g in problem.groups)
    lm = config.method == "lm"
    if config.linear_solver == "schur":
        elim = problem.groups[-1]
        retained_dim = total - elim.num * elim.tdim
        elim_meta = (elim.num, elim.tdim)

    matfree = config.linear_solver == "matfree_pcg"

    def linearize(vals):
        if matfree:
            cache, grad, cost, fixed, diag = _linearize_matfree(problem, vals, dtype)
            return (cache, fixed, diag), grad
        h, grad, _, _ = _linearize_dense(problem, vals, dtype)
        return h, grad

    def lin_solve(lin_state, grad, damping):
        if matfree:
            cache, fixed, diag = lin_state
            return _solve_matfree_pcg(problem, cache, grad, fixed, diag, damping, lm,
                                      config.pcg_max_iterations, config.pcg_tolerance)
        h = lin_state
        if config.linear_solver == "dense":
            return _solve_dense(h, grad, damping, lm)
        if config.linear_solver == "pcg":
            return _solve_pcg(h, grad, damping, lm, groups_meta,
                              config.pcg_max_iterations, config.pcg_tolerance)
        if config.linear_solver == "schur":
            return _solve_schur(h, grad, damping, lm, retained_dim, elim_meta,
                                config.reduced_solver)
        raise ValueError(config.linear_solver)

    initial_cost = float(problem_cost(problem, values))
    current_cost = initial_cost
    damping = config.initial_damping
    accepted = 0
    total_linear = 0
    termination = "max_iterations"
    it = 0

    for it in range(config.max_iterations):
        lin_state, grad = linearize(values)
        if float(torch.max(torch.abs(grad))) <= config.gradient_tolerance:
            termination = "gradient_converged"
            break
        delta, lin_iters = lin_solve(lin_state, grad, damping)
        del lin_state
        total_linear += int(lin_iters)
        if not bool(torch.all(torch.isfinite(delta))):
            raise FloatingPointError("non-finite increment")
        if float(torch.linalg.norm(delta)) <= config.step_tolerance:
            termination = "step_converged"
            it += 1
            break
        trial = _apply_increment(problem, values, delta)
        trial_cost = float(problem_cost(problem, trial))
        if config.method == "gn" or trial_cost < current_cost:
            accepted += 1
            change = abs(current_cost - trial_cost)
            values = trial
            current_cost = trial_cost
            damping = max(damping * 0.3, 1e-15)
            if change <= config.cost_tolerance:
                termination = "cost_converged"
                it += 1
                break
        else:
            damping = min(damping * 10.0, 1e15)
    else:
        it = config.max_iterations

    return problem.with_values(values), SolverSummary(
        initial_cost, current_cost, it, accepted, termination, total_linear
    )


# `solve_device` reads `done` back once every this many iterations to stop
# early; a solve that finished in between runs the rest of the K frozen.
DONE_READ_EVERY = 4


class DeviceLMState(NamedTuple):
    """`solve_device`'s carry: values (a tuple per group), then 0-d tensors."""

    values: tuple
    damping: torch.Tensor
    cost: torch.Tensor
    it: torch.Tensor
    accepted: torch.Tensor
    linear: torch.Tensor
    term: torch.Tensor
    done: torch.Tensor


def device_lm_start(problem: Problem, config: SolverConfig = SolverConfig()):
    """`solve_device`'s first state and its step: step(state) is one LM
    iteration (JAX `solve_device`'s while_loop body) and reads nothing back.
    A state that is done passes through unchanged."""
    values = problem.values()
    dtype = values[0].dtype
    device = values[0].device
    if config.linear_solver not in ("dense", "matfree_pcg"):
        raise ValueError(f"solve_device supports dense|matfree_pcg, got {config.linear_solver!r}")
    zero = torch.zeros((), dtype=torch.int32, device=device)
    cost = torch.as_tensor(problem_cost(problem, values), dtype=dtype, device=device)
    state = DeviceLMState(values, torch.full((), config.initial_damping, dtype=dtype,
                                             device=device),
                          cost, zero, zero, zero, zero,
                          torch.zeros((), dtype=torch.bool, device=device))
    return state, lambda s: _lm_step(problem, config, s)


@full_fp32_matmul()
def _lm_step(problem: Problem, config: SolverConfig, s: DeviceLMState) -> DeviceLMState:
    """One iteration of the device-resident LM on `problem` from state `s`."""
    dtype = s.cost.dtype
    matfree = config.linear_solver == "matfree_pcg"
    lm = config.method == "lm"
    live = ~s.done
    if matfree:
        cache, grad, _, fixed, diag = _linearize_matfree(problem, s.values, dtype)
        delta, lin_iters = _solve_matfree_pcg(problem, cache, grad, fixed, diag, s.damping, lm,
                                              config.pcg_max_iterations, config.pcg_tolerance,
                                              pcg=_pcg_masked)
    else:
        h, grad, _, _ = _linearize_dense(problem, s.values, dtype)
        hd = _add_damping(h, s.damping) if lm else h
        # solve_ex: no error check, so no read-back; a singular system
        # gives a non-finite step, which ends the solve as a failure
        delta = torch.linalg.solve_ex(hd, -grad)[0]
        lin_iters = torch.ones((), dtype=torch.int32, device=s.cost.device)
    grad_conv = torch.max(torch.abs(grad)) <= config.gradient_tolerance
    bad = ~torch.all(torch.isfinite(delta))
    step_conv = torch.linalg.norm(delta) <= config.step_tolerance
    trial = _apply_increment(problem, s.values, delta)
    trial_cost = problem_cost(problem, trial)
    better = trial_cost < s.cost if lm else torch.ones_like(live)
    accept = live & ~grad_conv & ~step_conv & ~bad & better
    cost_conv = accept & (torch.abs(s.cost - trial_cost) <= config.cost_tolerance)
    damping = torch.where(accept, torch.clamp(s.damping * 0.3, min=1e-15),
                          torch.clamp(s.damping * 10.0, max=1e15))
    damping = torch.where(grad_conv | step_conv | bad | s.done, s.damping, damping)
    term = torch.where(grad_conv, 1, torch.where(bad, 4, torch.where(
        step_conv, 2, torch.where(cost_conv, 3, 0)))).to(torch.int32)
    return DeviceLMState(
        tuple(torch.where(accept, t, v) for t, v in zip(trial, s.values)),
        damping,
        torch.where(accept, trial_cost, s.cost),
        s.it + live.to(torch.int32),
        s.accepted + accept.to(torch.int32),
        s.linear + torch.where(live, lin_iters, 0).to(torch.int32),
        torch.where(live, term, s.term),
        s.done | grad_conv | step_conv | cost_conv | bad)


# the CUDA graphs of `_lm_step`, least recently used first
_STEPS = collections.OrderedDict()
STEPS_KEPT = 4


def _graphed_step(problem: Problem, config: SolverConfig, state: DeviceLMState):
    """`_lm_step(problem, config, ·)` as one replay of a CUDA graph. The
    graph's inputs are the state and the problem's tensors (each group's
    fixed mask; each factor's indices, measurement and information), so
    the graph of one key serves every problem of that structure: the
    config, the groups' and factors' functions and names, and the shapes,
    dtypes and devices of their tensors. The last STEPS_KEPT keys' graphs
    are kept. Returns step(state) -> state, whose result is the graph's
    output, rewritten by the next replay; `step.graph` is the `Graphed`."""
    groups = [dataclasses.replace(g, fixed_mask=g.fixed()) for g in problem.groups]
    data = [g.fixed_mask for g in groups]
    for f in problem.factors:
        data += [t for t in (f.indices, f.measurement, f.information) if t is not None]
    key = (config,
           *((g.name, g.retract, g.tangent_dim, meta(g.values), meta(g.fixed_mask))
             for g in groups),
           *((f.name, f.residual, tuple(f.groups), f.robust, meta(f.indices),
              meta(f.measurement), meta(f.information)) for f in problem.factors))
    n_values = len(state.values)

    def rebuild(tensors):
        """The problem with `tensors` (laid out as `data`) as its data."""
        it = iter(tensors)
        gs = tuple(dataclasses.replace(g, fixed_mask=next(it)) for g in groups)
        fs = tuple(dataclasses.replace(
            f, indices=next(it),
            measurement=None if f.measurement is None else next(it),
            information=None if f.information is None else next(it))
            for f in problem.factors)
        return Problem(gs, fs)

    def flat_step(*args):
        s = DeviceLMState(tuple(args[:n_values]), *args[n_values:n_values + 7])
        out = _lm_step(rebuild(args[n_values + 7:]), config, s)
        return (*out.values, *out[1:])

    graph = kept(_STEPS, key, lambda: Graphed(flat_step, *state.values, *state[1:], *data),
                 STEPS_KEPT)

    def step(s: DeviceLMState) -> DeviceLMState:
        out = graph(*s.values, *s[1:], *data)
        return DeviceLMState(tuple(out[:n_values]), *out[n_values:])

    step.graph = graph
    return step


def solve_device(problem: Problem, config: SolverConfig = SolverConfig()):
    """The device-resident LM (JAX `solve_device`): linearise, linear solve
    (dense or matfree_pcg), trial, accept/reject and termination all on
    the device, for at most `config.max_iterations` iterations. No read-back
    inside an iteration; `done` is read once every `DONE_READ_EVERY`
    iterations, and the summary in one read at the end.

    Semantics mirror `solve` (solver.rs:81-188), except that the host's f64
    comparisons become device scalars of the problem's dtype, a solve that
    meets the gradient test counts that iteration, and a non-finite step
    ends the solve with "numerical_failure" rather than raising. Returns
    (solved Problem, SolverSummary of Python scalars)."""
    values = problem.values()
    _, total = problem.layout()
    if total == 0:
        c = float(problem_cost(problem, values))
        return problem, SolverSummary(c, c, 0, 0, "gradient_converged", 0)
    first, step = device_lm_start(problem, config)
    if first.cost.is_cuda:
        step = _graphed_step(problem, config, first)
    state = first
    for k in range(config.max_iterations):
        if k and k % DONE_READ_EVERY == 0 and bool(state.done):
            break
        state = step(state)
    summary = torch.stack([first.cost.double(), state.cost.double(), state.it.double(),
                           state.accepted.double(), state.linear.double(),
                           state.term.double()]).cpu().tolist()
    cost0, cost, it, accepted, linear, term = summary
    # a graph's outputs are rewritten by its next replay: keep copies
    values = tuple(v.clone() for v in state.values) if first.cost.is_cuda else state.values
    return problem.with_values(values), SolverSummary(
        cost0, cost, int(it), int(accepted), TERMINATION_NAMES[int(term)], int(linear))
