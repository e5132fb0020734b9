"""Tensor-parallel matrix-free NLLS: factor shards and one psum per matvec.

The port of rust_robotics_tpu/parallel/sharded_nlls.py. The Hessian is
never built (rust_robotics_optimization/src/sparse.rs:115's PCG, matrix
free); what is split over the mesh's `model` axis are the FACTORS:

- every factor block is padded to a multiple of the shard count (padding
  rows repeat row 0 with valid = False, so their weight and cost are zero:
  exact no-ops) and each rank keeps its contiguous slice;
- the variable (tangent) vector is replicated;
- linearisation computes this rank's gradient, cost and diagonal-block
  sums, combined with one psum each;
- every PCG H·v streams this rank's factor Jacobians (gather → J·v → Λ →
  Jᵀ → scatter-add) and ends in one psum of the [D] vector, the one
  collective of an iteration.

Every rank runs the same LM loop on the same reduced numbers, so the
host's decisions (the PCG's stopping test, accept or reject, termination)
agree without another collective. The termination follows
`nlls.solver.solve` (solver.rs:81-188). Like the port's other solver
paths, it runs with float32 products at full precision (TF32 off).
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch.nlls.problem import FactorBlock, Problem
from rust_robotics_tpu_torch.nlls.solver import (
    SolverConfig,
    SolverSummary,
    _apply_increment,
    _block_eval,
    _block_jacobians,
    _fixed_rows,
    _pcg,
    _tangent_rows,
    _weighted,
    problem_cost,
    scatter_add_,
)
from rust_robotics_tpu_torch.nlls.tridiag import full_fp32_matmul
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small
from rust_robotics_tpu_torch.parallel.mesh import axis_index, axis_size, mesh_device, psum


def _map_rows(fn, x):
    """fn on every tensor of a measurement (a tensor, a dict or a tuple)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_rows(fn, v) for k, v in x.items()}
    return type(x)(_map_rows(fn, v) for v in x)


def _pad_block(block: FactorBlock, n_shards: int):
    """The block padded to a multiple of n_shards factors, and valid [F']:
    padding rows repeat row 0 and carry valid = False."""
    f = block.num
    rem = (-f) % n_shards
    valid = torch.arange(f + rem, device=block.indices.device) < f
    if rem == 0:
        return block, valid

    def padrow(a):
        return torch.cat([a, a[:1].expand(rem, *a.shape[1:])], dim=0)

    return dataclasses.replace(block, indices=padrow(block.indices),
                               measurement=_map_rows(padrow, block.measurement),
                               information=_map_rows(padrow, block.information)), valid


def _shard_block(block: FactorBlock, valid, n_shards: int, shard: int):
    """This rank's contiguous slice of a padded block's factors."""
    c = block.num // n_shards

    def take(a):
        return a[shard * c:(shard + 1) * c]

    return dataclasses.replace(block, indices=take(block.indices),
                               measurement=_map_rows(take, block.measurement),
                               information=_map_rows(take, block.information)), take(valid)


def _local_linearize(problem: Problem, blocks, valids, gv, dtype, mesh, axes):
    """Linearisation over this rank's factor shard: (cache of the local
    Jacobians, never gathered; grad, cost and per-group diagonal blocks,
    summed over the mesh)."""
    offsets, total = problem.layout()
    groups = {g.name: g for g in problem.groups}
    device = problem.groups[0].values.device
    grad = torch.zeros((total,), dtype=dtype, device=device)
    cost = torch.zeros((), dtype=dtype, device=device)
    diag_blocks = {g.name: torch.zeros((g.num, g.tdim, g.tdim), dtype=dtype, device=device)
                   for g in problem.groups}
    cache = []
    for block, valid in zip(blocks, valids):
        r, jacs = _block_jacobians(problem, block, gv)
        wr, _, val, w = _weighted(block, r)
        w = w * valid
        cost = cost + 0.5 * torch.sum(val * valid)
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
    # one psum for the gradient, the cost and every group's diagonal blocks
    sizes = [total, 1] + [diag_blocks[g.name].numel() for g in problem.groups]
    packed = psum(torch.cat([grad, cost[None]] + [diag_blocks[g.name].reshape(-1)
                                                 for g in problem.groups]), mesh, axes)
    parts = torch.split(packed, sizes)
    diag = {g.name: p.reshape(g.num, g.tdim, g.tdim) for g, p in zip(problem.groups, parts[2:])}
    return cache, parts[0], parts[1][0], diag


def _local_cost(problem: Problem, blocks, valids, values_tuple, mesh, axes):
    """Σ ½ρ(rᵀΛr) over the whole problem: this rank's factors, psummed."""
    gv = {g.name: v for g, v in zip(problem.groups, values_tuple)}
    cost = torch.zeros((), dtype=values_tuple[0].dtype, device=values_tuple[0].device)
    for block, valid in zip(blocks, valids):
        _, _, val, _ = _weighted(block, _block_eval(block, gv))
        cost = cost + 0.5 * torch.sum(val * valid)
    return psum(cost, mesh, axes)


def _pcg_system(problem: Problem, blocks, cache, diag_blocks, fixed_diag, damping, lm, mesh, axes):
    """(hvp, precond) of the damped system: the matvec over this rank's
    factors with one psum, the block-Jacobi preconditioner replicated."""
    offsets, total = problem.layout()
    damp_parts, pre_inv = [], []
    for g in problem.groups:
        db = diag_blocks[g.name]
        eye = torch.eye(g.tdim, dtype=db.dtype, device=db.device)
        db = torch.where(g.fixed()[:, None, None], eye[None], db)
        d = torch.diagonal(db, dim1=-2, dim2=-1)
        lam = damping * torch.clamp(torch.abs(d), min=1.0) if lm else torch.zeros_like(d)
        damp_parts.append(lam.reshape(-1))
        pre_inv.append(inv_spd_small(db + torch.diag_embed(lam)))
    damp_vec = torch.where(fixed_diag, 1.0, torch.cat(damp_parts))

    def precond(rv):
        outs = []
        for g, inv in zip(problem.groups, pre_inv):
            off = offsets[g.name]
            rg = rv[off:off + g.num * g.tdim].reshape(g.num, g.tdim)
            outs.append(torch.einsum("nij,nj->ni", inv, rg).reshape(-1))
        return torch.cat(outs)

    def hvp(v):
        local = torch.zeros((total,), dtype=v.dtype, device=v.device)
        for block, (jacs, w) in zip(blocks, cache):
            jv = None
            for k, gname in enumerate(block.groups):
                cols = _tangent_rows(offsets[gname], block.indices[:, k], jacs[k].shape[-1])
                term = torch.einsum("frt,ft->fr", jacs[k], v[cols])
                jv = term if jv is None else jv + term
            lam_jv = (jv if block.information is None
                      else torch.einsum("fij,fj->fi", block.information, jv))
            for k, gname in enumerate(block.groups):
                rows = _tangent_rows(offsets[gname], block.indices[:, k], jacs[k].shape[-1])
                scatter_add_(local, (rows,),
                             w[:, None] * torch.einsum("fri,fr->fi", jacs[k], lam_jv))
        return damp_vec * v + psum(local, mesh, axes)

    return hvp, precond


def solve_sharded(problem: Problem, config: SolverConfig | None = None, mesh=None,
                  axis_names=("model",)):
    """LM/GN solve with the factor blocks split over `axis_names` of
    `mesh`; the linear solver is always the matrix-free block-Jacobi PCG.
    The problem (all of it) is given on every rank, on this rank's device.
    Returns (solved Problem, SolverSummary), the same on every rank."""
    if config is None:
        config = SolverConfig(linear_solver="matfree_pcg")
    if mesh is None:
        raise ValueError("solve_sharded needs a mesh (parallel.mesh.make_mesh)")
    axes = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    n_shards = axis_size(mesh, axes)
    shard = 0
    for a in axes:  # row-major over the named axes, as JAX's P(axes)
        shard = shard * axis_size(mesh, a) + axis_index(mesh, a)

    with full_fp32_matmul():
        values = problem.values()
        dtype = values[0].dtype
        _, total = problem.layout()
        if total == 0:
            c = float(problem_cost(problem, values))
            return problem, SolverSummary(c, c, 0, 0, "gradient_converged", 0)

        blocks, valids = zip(*[_shard_block(*_pad_block(b, n_shards), n_shards, shard)
                               for b in problem.factors])
        lm = config.method == "lm"
        fixed_diag = _fixed_rows(problem)

        initial_cost = float(_local_cost(problem, blocks, valids, values, mesh, axes))
        current_cost = initial_cost
        damping = config.initial_damping
        accepted = 0
        total_linear = 0
        termination = "max_iterations"
        it = 0

        for it in range(config.max_iterations):
            gv = {g.name: v for g, v in zip(problem.groups, values)}
            cache, grad, _, diag = _local_linearize(problem, blocks, valids, gv, dtype, mesh, axes)
            grad = torch.where(fixed_diag, 0.0, grad)
            if float(torch.max(torch.abs(grad))) <= config.gradient_tolerance:
                termination = "gradient_converged"
                break
            hvp, precond = _pcg_system(problem, blocks, cache, diag, fixed_diag, damping, lm,
                                       mesh, axes)
            delta, lin_iters = _pcg(hvp, precond, -grad, config.pcg_max_iterations,
                                    config.pcg_tolerance)
            del cache
            total_linear += int(lin_iters)
            if not bool(torch.all(torch.isfinite(delta))):
                raise FloatingPointError("non-finite increment")
            if float(torch.linalg.norm(delta)) <= config.step_tolerance:
                termination = "step_converged"
                it += 1
                break
            trial = _apply_increment(problem, values, delta)
            trial_cost = float(_local_cost(problem, blocks, valids, trial, mesh, axes))
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
        initial_cost, current_cost, it, accepted, termination, total_linear)


def optimize_pose_graph_2d_sharded(poses, edges_from, edges_to, measurements, information=None,
                                   mesh=None, axis_names=("model",), max_iterations=50,
                                   tolerance=1e-10, pcg_max_iterations=3000, pcg_tolerance=1e-6,
                                   dtype=torch.float32):
    """The model-sharded SE(2) pose-graph solve (slam/pose_graph.py
    semantics, edges split over the mesh). Host arrays (or tensors) go to
    this rank's device in `dtype`. Returns (poses [N, 3], SolverSummary)."""
    from rust_robotics_tpu_torch.convert import pose_graph_from_numpy
    from rust_robotics_tpu_torch.slam.pose_graph import build_pose_graph_2d

    if mesh is None:
        raise ValueError("optimize_pose_graph_2d_sharded needs a mesh (parallel.mesh.make_mesh)")
    prob = build_pose_graph_2d(*pose_graph_from_numpy(poses, edges_from, edges_to, measurements,
                                                      information, device=mesh_device(mesh),
                                                      dtype=dtype))
    cfg = SolverConfig(
        method="lm", max_iterations=max(max_iterations, 1), gradient_tolerance=tolerance,
        step_tolerance=tolerance, cost_tolerance=tolerance * tolerance,
        linear_solver="matfree_pcg", pcg_max_iterations=pcg_max_iterations,
        pcg_tolerance=pcg_tolerance)
    solved, summary = solve_sharded(prob, cfg, mesh, axis_names)
    return solved.groups[0].values, summary
