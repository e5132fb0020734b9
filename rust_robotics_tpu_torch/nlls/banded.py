"""General-graph NLLS: the RCM-banded supernodal direct solve.

The port of rust_robotics_tpu/nlls/banded.py (reference: the
optimize_pose_graph semantics of slam/src/pose_graph_optimization.rs:73-140
on any topology; the 10k benchmark row of README.md:728-730). Sparsity
becomes batched density:

1. Reorder the nodes (natural order or reverse Cuthill-McKee, on the host)
   so every edge spans few positions.
2. Group `s` consecutive positions into a supernode. Every in-band edge
   then couples the same or adjacent supernodes, so the Gauss-Newton
   Hessian is block-tridiagonal with fat (s·tdim)² blocks, which the
   cyclic-reduction ladder of `nlls/tridiag.py` solves (300×300 blocks for
   the 100×100 grid).
3. Edges that span more than one supernode go to the streamed Woodbury
   correction, as the chain solver's loop closures do.
4. The LM loop (solver.rs:81-188, sparse.rs:34-42 damping) is
   `nlls/tridiag.py`'s: one step per iteration that reads nothing back.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from rust_robotics_tpu_torch.nlls.tridiag import (
    _edge_terms,
    _half_cost,
    _host,
    _info_mat,
    _info_vec,
    _jt_mat,
    _jt_vec,
    _map_edges,
    _pow2,
    _residuals,
    _small_sum,
    _step_applier,
    block_tridiag_apply,
    block_tridiag_factor,
    build_w_inv,
    capacitance_solver,
    finish,
    full_fp32_matmul,
    lm_run,
    lm_state,
    lm_step,
    small_mm,
)

# Per-chunk memory budget of the streamed out-of-band Woodbury solve (see
# tridiag.WOODBURY_CHUNK_BYTES; separate, so that a test can force several
# chunks here alone). Read at call time.
WOODBURY_CHUNK_BYTES = 3 * 512 * 1024 * 1024


class BandedPlan(NamedTuple):
    """Host-side structure plan for a general graph."""

    order: np.ndarray      # [n] old node index at each banded position
    perm: np.ndarray       # [n] banded position of each old node
    supernode: int         # nodes per supernode (s)
    num_super: int         # Ns = ceil(n / s)
    bandwidth: int         # the chosen ordering's largest edge span
    in_band: np.ndarray    # [E] bool: edge handled by the tridiagonal part


def plan_banded(n, edges_from, edges_to, max_supernode=256, tdim=3):
    """Ordering and supernode size (host, numpy and scipy).

    Every edge whose endpoints land in the same or adjacent supernodes is
    in-band; the rest go to the Woodbury correction. `max_supernode` caps s.
    Candidate (ordering, supernode) plans are scored by a FLOP model per LM
    iteration (ladder factor 14·n·s²·t³, applies 8·n·s·t²·cols, the K³
    capacitance solve), so a chain with one long closure takes s = 1 and a
    rank-t Woodbury while a grid takes the fat band. Warns when even the
    best plan demotes far more edges than the planner budgets for (the
    matfree-PCG boundary)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ef = _host(edges_from).astype(np.int64)
    et = _host(edges_to).astype(np.int64)
    if len(ef) == 0:
        order = np.arange(n)
        return BandedPlan(order, order.copy(), 1, n, 0, np.zeros((0,), bool))
    adj = sp.coo_matrix((np.ones(len(ef)), (ef, et)), shape=(n, n)).tocsr()
    adj = (adj + adj.T).tocsr()
    # RCM is a heuristic and can lose to the natural order on structured
    # graphs (a 100x100 grid: row-major band 100, RCM 369); the supernode
    # comes from a high quantile of edge spans, so a few long closures go
    # to the Woodbury side instead of inflating the fat blocks
    candidates = [np.arange(n, dtype=np.int64),
                  np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64)]
    num_e = len(ef)
    allowed_out = min(num_e - 1, max(64, num_e // 50))
    best = None
    for order_c in candidates:
        perm_c = np.empty(n, np.int64)
        perm_c[order_c] = np.arange(n)
        spans = np.sort(np.abs(perm_c[ef] - perm_c[et]))
        band_q = int(spans[-(allowed_out + 1)]) if allowed_out else int(spans[-1])
        # per ordering: the high-quantile band, the full span (many
        # same-span closures in band) and s = 1 (tridiagonal + Woodbury)
        for band_c in {band_q, int(spans[-1]), 1}:
            s_c = int(min(max(band_c, 1), max_supernode))
            out_c = int(np.sum(np.abs(perm_c[ef] // s_c - perm_c[et] // s_c) > 1))
            k_w = out_c * tdim
            cost = (14.0 * n * s_c**2 * tdim**3              # ladder factor
                    + 8.0 * n * s_c * tdim**2 * (2 + k_w)     # applies
                    + (2.0 / 3.0) * float(k_w) ** 3)          # capacitance
            if best is None or cost < best[0]:
                best = (cost, order_c, perm_c, s_c, int(spans[-1]), out_c)
    _, order, perm, s, band, out_best = best
    # No ordering bands this graph: far more edges than the planner's own
    # budget (~E/50) demote to the Woodbury correction, and the dense
    # capacitance solve stops scaling like a banded solve. Still exact.
    k_w = out_best * tdim
    if k_w >= 1024 and out_best > 8 * allowed_out:
        warnings.warn(
            f"plan_banded: the best ordering still demotes {out_best} of {num_e} edges to the "
            f"Woodbury correction ({out_best / num_e:.0%}; the planner budgets "
            f"~{allowed_out}). The {k_w}x{k_w} dense capacitance solve plus {k_w} streamed "
            "column applies per LM iteration mean this graph's structure defeats the banded "
            "direct solver — consider linear_solver='matfree_pcg', or raise max_supernode if "
            "memory allows.",
            stacklevel=2)
    in_band = np.abs(perm[ef] // s - perm[et] // s) <= 1
    return BandedPlan(order, perm, s, -(-n // s), band, in_band)


def _banded_ops(n, band_from, band_to, band_meas, band_info, loop_from, loop_to, loop_meas,
                loop_info, fixed_mask, dtype, *, residual_fn: Callable, retract_fn: Callable,
                tdim: int, supernode: int, num_super: int, fat_solve=None):
    """(linearize, cost_only, lin_solve, apply_step) of the banded engine,
    for values [..., n, dim] in banded order.

    linearize(values) -> (grad [..., n_pad, t], diag [..., Ns, big, big],
    upper [..., max(Ns-1, 1), big, big], jac_loop, diag_loop [..., n_pad, t],
    cost). lin_solve(grad, diag, upper, jac_loop, diag_loop, damping [...])
    -> delta [..., n, t] solving (H + damping·scaled diag) delta = −grad
    with fixed rows as the identity."""
    s, ns, t = supernode, num_super, tdim
    big = s * t
    n_pad = ns * s
    num_l = loop_from.shape[0]
    rdim = band_meas.shape[-1]
    k_w = num_l * rdim
    dev = band_meas.device
    fixed = fixed_mask
    t_ar = torch.arange(t, device=dev)
    terms = _edge_terms(residual_fn, retract_fn, t)

    # each edge's place in the fat layout: supernode and row of each end
    sn_f, sn_t = band_from // s, band_to // s
    rows_i = (band_from % s)[:, None] * t + t_ar  # [E, t]
    rows_j = (band_to % s)[:, None] * t + t_ar
    same = (sn_f == sn_t)[:, None, None]
    f_lo = (sn_f <= sn_t)[:, None, None]  # rows of a cross term: the lower supernode
    n_up = max(ns - 1, 1)

    def flat(sn, rows, cols):
        """Flat index into [.., S, big, big] of blocks [E, t, t]."""
        return ((sn[:, None, None] * big + rows[:, :, None]) * big + cols[:, None, :]).reshape(-1)

    idx_ii = flat(sn_f, rows_i, rows_i)
    idx_jj = flat(sn_t, rows_j, rows_j)
    # same-supernode cross terms sit in the diagonal block; the others add
    # zeros there
    idx_ij = flat(sn_f, rows_i, rows_j)
    idx_ji = flat(sn_t, rows_j, rows_i)
    # adjacent-supernode cross terms: C_k = H[k, k+1], rows in the lower
    # supernode; a same-supernode edge adds its zero at a clamped index
    k_sn = torch.minimum(sn_f, sn_t).clamp(max=n_up - 1)
    idx_up = flat(k_sn, torch.where(f_lo[:, :, 0], rows_i, rows_j),
                  torch.where(f_lo[:, :, 0], rows_j, rows_i))

    def scatter(target, idx, blocks):
        lead = blocks.shape[:-3]
        target.view(*lead, -1).index_add_(-1, idx, blocks.reshape(*lead, -1))

    fixed_pad = torch.cat([fixed, torch.ones(n_pad - n, dtype=torch.bool, device=dev)])
    fixed_fat = fixed_pad.repeat_interleave(t).reshape(ns, big)

    def linearize(values):
        lead = values.shape[:-2]
        r_b, ji_b, jj_b = _map_edges(terms, values[..., band_from, :], values[..., band_to, :],
                                     band_meas)
        ji_b = torch.where(fixed[band_from, None, None], 0.0, ji_b)
        jj_b = torch.where(fixed[band_to, None, None], 0.0, jj_b)
        lam_r = _info_vec(band_info, r_b)
        cost = _half_cost(r_b, lam_r)
        lam_ji = _info_mat(band_info, ji_b)
        lam_jj = _info_mat(band_info, jj_b)

        grad = values.new_zeros((*lead, n_pad, t))
        grad.index_add_(-2, band_from, _jt_vec(ji_b, lam_r))
        grad.index_add_(-2, band_to, _jt_vec(jj_b, lam_r))

        hij = _jt_mat(ji_b, lam_jj)
        d = values.new_zeros((*lead, ns, big, big))
        u = values.new_zeros((*lead, n_up, big, big))
        scatter(d, idx_ii, _jt_mat(ji_b, lam_ji))
        scatter(d, idx_jj, _jt_mat(jj_b, lam_jj))
        scatter(d, idx_ij, torch.where(same, hij, 0.0))
        scatter(d, idx_ji, torch.where(same, hij.mT, 0.0))
        scatter(u, idx_up, torch.where(same, 0.0, torch.where(f_lo, hij, hij.mT)))

        diag_loop = values.new_zeros((*lead, n_pad, t))
        jac_loop = None
        if num_l:
            r_l, ji_l, jj_l = _map_edges(terms, values[..., loop_from, :],
                                         values[..., loop_to, :], loop_meas)
            ji_l = torch.where(fixed[loop_from, None, None], 0.0, ji_l)
            jj_l = torch.where(fixed[loop_to, None, None], 0.0, jj_l)
            lam_r_l = _info_vec(loop_info, r_l)
            cost = cost + _half_cost(r_l, lam_r_l)
            grad.index_add_(-2, loop_from, _jt_vec(ji_l, lam_r_l))
            grad.index_add_(-2, loop_to, _jt_vec(jj_l, lam_r_l))
            diag_loop.index_add_(-2, loop_from, _small_sum(ji_l * _info_mat(loop_info, ji_l)))
            diag_loop.index_add_(-2, loop_to, _small_sum(jj_l * _info_mat(loop_info, jj_l)))
            jac_loop = (ji_l, jj_l)
        grad = torch.where(fixed_pad[:, None], 0.0, grad)
        return grad, d, u, jac_loop, diag_loop, cost

    def cost_only(values):
        r_b = _residuals(residual_fn, values[..., band_from, :], values[..., band_to, :],
                         band_meas)
        cost = _half_cost(r_b, _info_vec(band_info, r_b))
        if num_l:
            r_l = _residuals(residual_fn, values[..., loop_from, :], values[..., loop_to, :],
                             loop_meas)
            cost = cost + _half_cost(r_l, _info_vec(loop_info, r_l))
        return cost

    if num_l:
        w_inv = build_w_inv(loop_info, num_l, rdim, dtype, dev)
        sn_lf, sn_lt = loop_from // s, loop_to // s
        rows_lf = (loop_from % s)[:, None] * t + t_ar  # [L, t]
        rows_lt = (loop_to % s)[:, None] * t + t_ar
    # Woodbury edge-chunk sizing (mirrors tridiag.chain_woodbury_solve)
    bytes_per_edge = 3 * (2 * _pow2(ns)) * big * 4 * rdim
    cs_edges = max(1, min(max(num_l, 1), WOODBURY_CHUNK_BYTES // max(bytes_per_edge, 1)))

    def lin_solve(grad, d, u, jac_loop, diag_loop, damping):
        lead = grad.shape[:-2]
        # scaled LM damping of the full diagonal (sparse.rs:34-42); fixed
        # and padding scalars become the identity
        lam = damping[..., None, None] * torch.clamp(
            (d.diagonal(dim1=-2, dim2=-1) + diag_loop.reshape(*lead, ns, big)).abs(), min=1.0)
        dd = d + torch.diag_embed(torch.where(fixed_fat, 1.0, lam))
        upper = u[..., :ns - 1, :, :] if ns > 1 else d.new_zeros((*lead, 0, big, big))
        if fat_solve is None:
            fac = block_tridiag_factor(dd, upper)
            t_apply = lambda rhs: block_tridiag_apply(fac, rhs)  # noqa: E731
        elif isinstance(fat_solve, tuple):
            # (factor, apply): factor once per damped system, reuse across
            # the gradient, Woodbury-chunk and correction applies
            fat_factor, fat_apply = fat_solve
            fac = fat_factor(dd, upper)
            t_apply = lambda rhs: fat_apply(fac, rhs)  # noqa: E731
        else:
            t_apply = lambda rhs: fat_solve(dd, upper, rhs)  # noqa: E731
        y0 = t_apply(-grad.reshape(*lead, ns, big)[..., None])[..., 0]
        if num_l == 0:
            return y0.reshape(*lead, n_pad, t)[..., :n, :]
        ji_l, jj_l = jac_loop

        def ut_apply(z):
            """Uᵀ z for z [..., Ns, big, k] -> [..., K, k] by row gathers."""
            out = (small_mm(ji_l, z[..., sn_lf[:, None], rows_lf, :])
                   + small_mm(jj_l, z[..., sn_lt[:, None], rows_lt, :]))
            return out.reshape(*lead, k_w, -1)

        def s_cols(e):
            """T⁻¹ on U's columns of the edges e, contracted by Uᵀ."""
            cs = e.stop - e.start
            cols = torch.arange(cs * rdim, device=dev).reshape(cs, 1, rdim)
            rhs = d.new_zeros((*lead, ns * big * cs * rdim))
            for sn, rows, jac in ((sn_lf, rows_lf, ji_l), (sn_lt, rows_lt, jj_l)):
                idx = ((sn[e, None, None] * big + rows[e, :, None]) * (cs * rdim) + cols)
                rhs.index_add_(-1, idx.reshape(-1), jac[..., e, :, :].mT.reshape(*lead, -1))
            return ut_apply(t_apply(rhs.reshape(*lead, ns, big, cs * rdim)))

        uty = torch.cat([s_cols(slice(e0, min(e0 + cs_edges, num_l)))
                         for e0 in range(0, num_l, cs_edges)], -1)
        s_solve, failed = capacitance_solver(w_inv + uty)
        coef = s_solve(ut_apply(y0[..., None]))[..., 0].reshape(*lead, num_l, rdim)
        u_coef = d.new_zeros((*lead, ns * big))
        u_coef.index_add_(-1, (sn_lf[:, None] * big + rows_lf).reshape(-1),
                          _jt_vec(ji_l, coef).reshape(*lead, -1))
        u_coef.index_add_(-1, (sn_lt[:, None] * big + rows_lt).reshape(-1),
                          _jt_vec(jj_l, coef).reshape(*lead, -1))
        delta = y0 - t_apply(u_coef.reshape(*lead, ns, big)[..., None])[..., 0]
        delta = torch.where(failed[..., None, None], torch.nan, delta)
        return delta.reshape(*lead, n_pad, t)[..., :n, :]

    return linearize, cost_only, lin_solve, _step_applier(fixed, retract_fn)


def banded_lm_start(values_b, band_from, band_to, band_meas, band_info, loop_from, loop_to,
                    loop_meas, loop_info, fixed_mask, *, residual_fn: Callable,
                    retract_fn: Callable, tdim: int, supernode: int, num_super: int,
                    gradient_tolerance: float = 1e-10, step_tolerance: float = 1e-10,
                    cost_tolerance: float = 1e-12, initial_damping: float = 1e-3,
                    fat_solve=None):
    """The banded LM's first state and its step, for values_b [G, n, dim]
    (arguments as `solve_banded_lm`). Returns (LMState, step)."""
    linearize, cost_only, lin_solve, apply_step = _banded_ops(
        values_b.shape[-2], band_from, band_to, band_meas, band_info, loop_from, loop_to,
        loop_meas, loop_info, fixed_mask, values_b.dtype, residual_fn=residual_fn,
        retract_fn=retract_fn, tdim=tdim, supernode=supernode, num_super=num_super,
        fat_solve=fat_solve)
    with full_fp32_matmul():
        state = lm_state(values_b, cost_only(values_b), initial_damping)
    return state, lm_step(linearize, lin_solve, apply_step, cost_only, gradient_tolerance,
                          step_tolerance, cost_tolerance)


def solve_banded_lm(values_b, band_from, band_to, band_meas, band_info, loop_from, loop_to,
                    loop_meas, loop_info, fixed_mask, *, residual_fn: Callable,
                    retract_fn: Callable, tdim: int, supernode: int, num_super: int,
                    max_iterations: int = 50, gradient_tolerance: float = 1e-10,
                    step_tolerance: float = 1e-10, cost_tolerance: float = 1e-12,
                    initial_damping: float = 1e-3, fat_solve=None):
    """LM over a banded general factor graph, on the device of `values_b`.

    All node arrays are in banded order: values_b [n, dim] (or [G, n, dim],
    G graphs in lock-step sharing the rest); band_* index the in-band edges
    (same or adjacent supernodes); loop_* the out-of-band (Woodbury) edges;
    fixed_mask [n] bool; endpoints as int64 tensors on the same device.
    residual_fn(xi, xj, meas) -> [rdim]; retract_fn(x, delta[tdim]) -> x'.

    fat_solve: an override of the fat-block tridiagonal solve, either
    solve(diag [.., Ns, D, D], upper [.., Ns-1, D, D], rhs [.., Ns, D, r]) ->
    x, or a (factor, apply) pair: factor(diag, upper) -> fac once per LM
    iteration, apply(fac, rhs) -> x. None: the cyclic-reduction ladder.

    Returns (values_b, ChainSummary), with the G axis if values_b had one;
    LM semantics as `solve_chain_lm`. Counts its calls on
    `solve_banded_lm.calls`."""
    solve_banded_lm.calls += 1
    batched = values_b.ndim == 3
    state, step = banded_lm_start(
        values_b if batched else values_b[None], band_from, band_to, band_meas, band_info,
        loop_from, loop_to, loop_meas, loop_info, fixed_mask, residual_fn=residual_fn,
        retract_fn=retract_fn, tdim=tdim, supernode=supernode, num_super=num_super,
        gradient_tolerance=gradient_tolerance, step_tolerance=step_tolerance,
        cost_tolerance=cost_tolerance, initial_damping=initial_damping, fat_solve=fat_solve)
    return finish(state, lm_run(state, step, max_iterations), batched)


solve_banded_lm.calls = 0


def banded_problem(values0, edges_from, edges_to, measurements, information, fixed_mask,
                   *, tdim, max_supernode=256):
    """Plan a general graph and lay its arrays out in banded order on
    values0's device and dtype. Returns (plan, values_b, args) with args
    the positional arguments of `solve_banded_lm` after values_b."""
    n = values0.shape[-2]
    dev, f = values0.device, values0.dtype
    ef, et = _host(edges_from), _host(edges_to)
    meas = _host(measurements)
    info = None if information is None else _host(information)
    plan = plan_banded(n, ef, et, max_supernode, tdim=tdim)
    pf, pt, ib = plan.perm[ef], plan.perm[et], plan.in_band

    def tensor(x, dtype=f):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    args = (tensor(pf[ib], torch.int64), tensor(pt[ib], torch.int64), tensor(meas[ib]),
            None if info is None else tensor(info[ib]),
            tensor(pf[~ib], torch.int64), tensor(pt[~ib], torch.int64), tensor(meas[~ib]),
            None if info is None else tensor(info[~ib]),
            tensor(_host(fixed_mask)[plan.order], torch.bool))
    return plan, values0[..., tensor(plan.order, torch.int64), :], args


def solve_general_graph(values0, edges_from, edges_to, measurements, information, fixed_mask,
                        *, residual_fn, retract_fn, tdim, max_supernode=256, max_iterations=50,
                        tolerance=1e-10, fat_solve=None):
    """Plan a general graph, run the banded LM, undo the permutation.

    values0 [n, dim] (a tensor, in the original node order) sets the
    device and dtype; the edge arrays may be numpy or tensors. Returns
    (values [n, dim] in the original order, ChainSummary, BandedPlan)."""
    plan, values_b, args = banded_problem(values0, edges_from, edges_to, measurements,
                                          information, fixed_mask, tdim=tdim,
                                          max_supernode=max_supernode)
    out_b, summ = solve_banded_lm(
        values_b, *args, residual_fn=residual_fn, retract_fn=retract_fn, tdim=tdim,
        supernode=plan.supernode, num_super=plan.num_super, max_iterations=max_iterations,
        gradient_tolerance=tolerance, step_tolerance=tolerance,
        cost_tolerance=tolerance * tolerance, fat_solve=fat_solve)
    perm = torch.as_tensor(plan.perm, dtype=torch.int64, device=values0.device)
    return out_b[..., perm, :], summ, plan
