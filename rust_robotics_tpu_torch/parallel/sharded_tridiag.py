"""Multi-rank chain solver: SPIKE-partitioned cyclic reduction.

The port of rust_robotics_tpu/parallel/sharded_tridiag.py. It runs the
chain LM of `nlls/tridiag.py::solve_chain_lm` with every O(n) array split
over one mesh axis: each rank holds a contiguous run of m = n/D node rows
and their chain edges.

Partitioned solve (the SPIKE algorithm):
- Each rank factors its local block-tridiagonal T_d by the cyclic-reduction
  ladder (`block_tridiag_factor`) and solves, in one ladder apply, the two
  "spikes" W_d = T_d⁻¹(e_first A_d) and V_d = T_d⁻¹(e_last C_d) of its
  coupling blocks to the neighbouring ranks (a rank with no left or right
  neighbour has no such spike).
- The interface system couples only the 2D chunk-boundary unknowns:
  x_d^top + W_d[0] x_{d-1}^bot + V_d[0] x_{d+1}^top = G_d[0], and the ^bot
  row alike. Its tips are all-gathered and it is solved on every rank:
  dense while 2·D·t ≤ `_DENSE_INTERFACE_MAX`, by block-Thomas elimination
  over the D rank blocks above.
- Back-substitution is local: x_d = G_d − W_d x_{d-1}^bot − V_d x_{d+1}^top.

JAX writes each phase as a `shard_map` body; here every rank runs the body
on its own shard (SPMD) and the collectives are `parallel/mesh.py`'s calls
on the axis's process group. The rank index is a Python int, so JAX's
`where`-guarded dynamic indexing becomes plain indexing and the spikes
that a boundary rank lacks are not computed.

Loop closures are few (99 on the 10k benchmark), so their Jacobians are
computed on every rank from all-gathered values; each rank scatters only
its own rows of U, and the Woodbury capacitance system W⁻¹ + UᵀT⁻¹U
assembles by one psum of the ranks' row contractions.

Collectives of one LM iteration: a ring shift left (the halo row) and one
right (the last edge's terms and coupling block) in the linearisation and
one left in the trial cost (none on a one-rank axis); all-gathers of the
values (linearisation and trial cost, with closures) and of the interface
tips (factor and apply); all-reduces of the capacitance system, the
gradient's largest entry (pmax), the increment's finiteness (pmin), its
squared norm and the trial cost (psum). Every rank makes the same LM
decisions from the same reduced numbers, and reads `done` once an
iteration, as `lm_run` does.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.nlls.implicit import _edge_cost_grad, _retractor
from rust_robotics_tpu_torch.nlls.solver import scatter_add_
from rust_robotics_tpu_torch.nlls.tridiag import (
    _edge_terms,
    _half_cost,
    _info_mat,
    _info_vec,
    _jt_mat,
    _jt_vec,
    _map_edges,
    _mm_for,
    _residuals,
    _small_sum,
    _step_applier,
    block_tridiag_apply,
    block_tridiag_factor,
    build_w_inv,
    finish,
    full_fp32_matmul,
    lm_run,
    lm_state,
    lm_step,
    small_mm,
)
from rust_robotics_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    axis_size,
    gather_shards,
    mesh_device,
    pmax,
    pmin,
    ppermute,
    psum,
)

# The interface system is solved dense up to this total dimension 2·D·t
# (the chain's 2·D·3); above it (the fat supernodal blocks of
# sharded_banded, 2·D·s·t) by block-Thomas elimination over the D rank
# blocks: D·(2t)³ work in place of (2Dt)³.
_DENSE_INTERFACE_MAX = 256


def _shifts(mesh, axis):
    """The ring shifts without wrap-around: `left` sends rank i's data to
    rank i − 1 (so a rank receives its right neighbour's), `right` to
    rank i + 1. An end rank receives zeros."""
    s = axis_size(mesh, axis)
    return [(i, i - 1) for i in range(1, s)], [(i, i + 1) for i in range(s - 1)]


def _ends(x):
    """The first and last rows [..., 2, t, c] of x [..., m, t, c]."""
    return torch.stack([x[..., 0, :, :], x[..., -1, :, :]], -3)


def spike_factor_local(diag_loc, upper_loc, a_left, c_right, mesh, axis):
    """Factor phase of the partitioned block-tridiagonal solve, on this
    rank's rows: the local ladder, the spikes W = T⁻¹(e_first A) and
    V = T⁻¹(e_last C) in one ladder apply, one all-gather of their tips,
    and the interface system's rhs-independent part, shared by every
    later apply.

    diag_loc [..., m, t, t], upper_loc [..., m-1, t, t]; a_left [..., t, t]
    the sub-diagonal coupling to the left neighbour's last row (ignored on
    the first rank), c_right [..., t, t] the super-diagonal coupling to the
    right neighbour's first row (ignored on the last rank). Returns (fac,
    w_loc, v_loc, iface): w_loc [..., m, t, t] (None on the first rank),
    v_loc likewise (None on the last), iface (mat [..., 2Dt, 2Dt],) for the
    dense solve or (l, b_inv, c) lists of D blocks [..., 2t, 2t] for
    block-Thomas."""
    dd, d = axis_size(mesh, axis), axis_index(mesh, axis)
    m, t = diag_loc.shape[-3], diag_loc.shape[-1]
    lead = diag_loc.shape[:-3]
    fac = block_tridiag_factor(diag_loc, upper_loc)

    spikes = []
    if d > 0:
        rhs = diag_loc.new_zeros((*lead, m, t, t))
        rhs[..., 0, :, :] = a_left
        spikes.append(rhs)
    if d < dd - 1:
        rhs = diag_loc.new_zeros((*lead, m, t, t))
        rhs[..., m - 1, :, :] = c_right
        spikes.append(rhs)
    sol = block_tridiag_apply(fac, torch.cat(spikes, -1)) if spikes else None
    w_loc = sol[..., :t] if d > 0 else None
    v_loc = sol[..., -t:] if d < dd - 1 else None

    zero = diag_loc.new_zeros((*lead, 2, t, t))
    tip = lambda s: zero if s is None else _ends(s)  # noqa: E731
    tips = all_gather(torch.cat([tip(w_loc), tip(v_loc)], -1), mesh, axis).movedim(0, -4)
    w0, wm = tips[..., 0, :, :t], tips[..., 1, :, :t]  # [..., D, t, t]
    v0, vm = tips[..., 0, :, t:], tips[..., 1, :, t:]

    eye_t = torch.eye(t, dtype=diag_loc.dtype, device=diag_loc.device)
    if 2 * dd * t <= _DENSE_INTERFACE_MAX:
        mat = diag_loc.new_zeros((*lead, 2 * dd, t, 2 * dd, t))
        for k in range(dd):
            mat[..., 2 * k, :, 2 * k, :] = eye_t
            mat[..., 2 * k + 1, :, 2 * k + 1, :] = eye_t
            if k > 0:
                mat[..., 2 * k, :, 2 * k - 1, :] = w0[..., k, :, :]
                mat[..., 2 * k + 1, :, 2 * k - 1, :] = wm[..., k, :, :]
            if k < dd - 1:
                mat[..., 2 * k, :, 2 * k + 2, :] = v0[..., k, :, :]
                mat[..., 2 * k + 1, :, 2 * k + 2, :] = vm[..., k, :, :]
        return fac, w_loc, v_loc, (mat.reshape(*lead, 2 * dd * t, 2 * dd * t),)

    # block-Thomas over the D rank blocks R_k = [x_k^top; x_k^bot]: B_k = I,
    # A_k = [[0, w0_k], [0, wm_k]] couples to x_{k-1}^bot and
    # C_k = [[v0_k, 0], [vm_k, 0]] to x_{k+1}^top
    zero_t = diag_loc.new_zeros((*lead, t, t))
    zero_2t = diag_loc.new_zeros((*lead, 2 * t, 2 * t))
    eye_2t = torch.eye(2 * t, dtype=diag_loc.dtype, device=diag_loc.device)

    def blocks(top, bot, right):
        cols = lambda x: [zero_t, x] if right else [x, zero_t]  # noqa: E731
        return torch.cat([torch.cat(cols(top), -1), torch.cat(cols(bot), -1)], -2)

    l_list, b_inv, c_list = [], [], []
    for k in range(dd):
        if k == 0:
            l_k, b_prime = zero_2t, eye_2t.expand_as(zero_2t)
        else:
            l_k = blocks(w0[..., k, :, :], wm[..., k, :, :], True) @ b_inv[-1]
            b_prime = eye_2t - l_k @ c_list[-1]
        l_list.append(l_k)
        b_inv.append(torch.linalg.inv_ex(b_prime)[0])
        c_list.append(blocks(v0[..., k, :, :], vm[..., k, :, :], False) if k < dd - 1
                      else zero_2t)
    return fac, w_loc, v_loc, (l_list, b_inv, c_list)


def _interface_solve(iface, rhs_z):
    """z [..., 2D, t, r] of the interface system for its right-hand side
    rhs_z [..., 2D, t, r], from `spike_factor_local`'s iface."""
    lead, (d2, t, r) = rhs_z.shape[:-3], rhs_z.shape[-3:]
    if len(iface) == 1:
        return torch.linalg.solve_ex(iface[0], rhs_z.reshape(*lead, d2 * t, r))[0].reshape(
            rhs_z.shape)
    l_list, b_inv, c_list = iface
    f = rhs_z.reshape(*lead, d2 // 2, 2 * t, r)
    f_prime = [f[..., 0, :, :]]
    for k in range(1, d2 // 2):
        f_prime.append(f[..., k, :, :] - l_list[k] @ f_prime[-1])
    x = [b_inv[-1] @ f_prime[-1]]
    for k in range(d2 // 2 - 2, -1, -1):
        x.insert(0, b_inv[k] @ (f_prime[k] - c_list[k] @ x[0]))
    return torch.stack(x, -3).reshape(rhs_z.shape)


def spike_apply_local(fac, w_loc, v_loc, iface, rhs_loc, mesh, axis):
    """Apply phase: one local ladder apply for G = T⁻¹f, one all-gather of
    G's tips [..., 2, t, r] (the spikes' tips were gathered by the
    factor), the interface solve, and the local spike correction.
    rhs_loc [..., m, t, r] -> x_loc [..., m, t, r]."""
    dd, d = axis_size(mesh, axis), axis_index(mesh, axis)
    t = rhs_loc.shape[-2]
    mm = _mm_for(t)
    g = block_tridiag_apply(fac, rhs_loc)
    tips = all_gather(_ends(g), mesh, axis).movedim(0, -4)
    z = _interface_solve(iface, tips.reshape(*tips.shape[:-4], 2 * dd, *tips.shape[-2:]))
    if d > 0:
        g = g - mm(w_loc, z[..., 2 * d - 1, None, :, :])
    if d < dd - 1:
        g = g - mm(v_loc, z[..., 2 * d + 2, None, :, :])
    return g


def spike_solve_local(diag_loc, upper_loc, a_left, c_right, rhs_loc, mesh, axis):
    """The partitioned block-tridiagonal solve on this rank's rows (factor
    and apply in one call; arguments as `spike_factor_local` and
    `spike_apply_local`). Returns x_loc [..., m, t, r]."""
    return spike_apply_local(*spike_factor_local(diag_loc, upper_loc, a_left, c_right, mesh,
                                                 axis), rhs_loc, mesh, axis)


class _ChainShard:
    """One rank's share of a chain problem, padded to n_pad = D·m nodes:
    pad nodes are fixed at zero, pad edges carry zero information, and the
    last rank's last edge (to a node past the end) is pure padding.
    Global arrays are kept (every rank holds them), local ones sliced."""

    def __init__(self, mesh, axis, values, chain_meas, chain_info, loop_from, loop_to,
                 loop_meas, loop_info, fixed_mask):
        dev = mesh_device(mesh)
        f_ = values.dtype
        self.dd, self.d = axis_size(mesh, axis), axis_index(mesh, axis)
        n, dim = values.shape
        values = values.to(dev)
        rdim = chain_meas.shape[-1]
        self.n, self.rdim = n, rdim
        self.m = -(-n // self.dd)
        self.n_pad = self.m * self.dd
        tensor = lambda x, dtype=f_: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
        if chain_info is None:
            chain_info = torch.eye(rdim, dtype=f_, device=dev).expand(n - 1, rdim, rdim)
        e_pad = self.n_pad - (n - 1)
        self.values = torch.cat([values, values.new_zeros((self.n_pad - n, dim))])
        self.fixed = torch.cat([tensor(fixed_mask, torch.bool),
                                torch.ones(self.n_pad - n, dtype=torch.bool, device=dev)])
        meas = torch.cat([tensor(chain_meas), torch.zeros((e_pad, rdim), dtype=f_, device=dev)])
        info = torch.cat([tensor(chain_info),
                          torch.zeros((e_pad, rdim, rdim), dtype=f_, device=dev)])
        rows = slice(self.d * self.m, (self.d + 1) * self.m)
        self.values_l, self.fixed_l = self.values[rows], self.fixed[rows]
        self.meas_l, self.info_l = meas[rows], info[rows]
        self.lf = tensor(loop_from, torch.int64)
        self.lt = tensor(loop_to, torch.int64)
        self.num_l = int(self.lf.shape[0])
        self.lmeas = tensor(loop_meas) if self.num_l else torch.zeros((0, rdim), dtype=f_,
                                                                       device=dev)
        self.linfo = None if loop_info is None or not self.num_l else tensor(loop_info)
        self.w_inv = build_w_inv(self.linfo, self.num_l, rdim, f_, dev) if self.num_l else None

    def halo_row(self, x):
        """Row 0 of the right neighbour's rows of the global x [n_pad, ...]
        (the first rows of x on the last rank, where only a pad edge
        reads it)."""
        k = (self.d + 1) * self.m if self.d < self.dd - 1 else 0
        return x[k:k + 1]

    def local_rows(self, idx):
        """(rows clamped into this rank's [0, m), owned [L]) of global node
        indices idx [L]."""
        local = idx - self.d * self.m
        return local.clamp(0, self.m - 1), (local >= 0) & (local < self.m)


def _make_local_ops(sh: _ChainShard, mesh, axis, *, tdim, residual_fn, retract_fn):
    """This rank's (linearize, cost_only, lin_solve, apply_step) of the
    SPIKE chain engine, in `lm_step`'s form over values [G, m, dim].
    Shared by the LM (`make_sharded_chain_solver`) and the IFT
    (`make_sharded_chain_ift`), which solves H w = u through the same
    SPIKE factorisation and Woodbury machinery at damping 0."""
    d, dd, m, num_l = sh.d, sh.dd, sh.m, sh.num_l
    left, right = _shifts(mesh, axis)
    terms = _edge_terms(residual_fn, retract_fn, tdim)
    fixed_l = sh.fixed_l
    fixed_j = torch.cat([fixed_l[1:], sh.halo_row(sh.fixed) if d < dd - 1
                         else fixed_l.new_ones(1)])
    eye_t = torch.eye(tdim, dtype=sh.values.dtype, device=sh.values.device)
    if num_l:
        k_w = num_l * sh.rdim
        lf_rows, own_f = sh.local_rows(sh.lf)
        lt_rows, own_t = sh.local_rows(sh.lt)
        fixed_lf, fixed_lt = sh.fixed[sh.lf], sh.fixed[sh.lt]
        cols = (torch.arange(num_l, device=sh.lf.device)[:, None] * sh.rdim
                + torch.arange(sh.rdim, device=sh.lf.device))

    def halo_values(values):
        return torch.cat([values[..., 1:, :], ppermute(values[..., :1, :], mesh, axis, left)], -2)

    def linearize(values):
        g = values.shape[0]
        r_c, ji_c, jj_c = _map_edges(terms, values, halo_values(values), sh.meas_l)
        ji_c = torch.where(fixed_l[:, None, None], 0.0, ji_c)
        jj_c = torch.where(fixed_j[:, None, None], 0.0, jj_c)
        lam_r = _info_vec(sh.info_l, r_c)
        cost = _half_cost(r_c, lam_r)
        lam_jj = _info_mat(sh.info_l, jj_c)
        jj_grad = _jt_vec(jj_c, lam_r)
        jj_b = _jt_mat(jj_c, lam_jj)
        c_full = _jt_mat(ji_c, lam_jj)
        # the last edge's jj terms and coupling block belong to the right
        # neighbour's first row
        sent = ppermute(torch.cat([jj_grad[:, -1], jj_b[:, -1].flatten(1),
                                   c_full[:, -1].flatten(1)], -1), mesh, axis, right)
        grad = _jt_vec(ji_c, lam_r)
        grad[:, 1:] += jj_grad[:, :-1]
        b = _jt_mat(ji_c, _info_mat(sh.info_l, ji_c))
        b[:, 1:] += jj_b[:, :-1]
        a_left = None
        if d > 0:
            grad[:, 0] += sent[:, :tdim]
            b[:, 0] += sent[:, tdim:tdim + tdim * tdim].reshape(g, tdim, tdim)
            a_left = sent[:, tdim + tdim * tdim:].reshape(g, tdim, tdim).mT
        c_right = c_full[:, -1] if d < dd - 1 else None

        diag_loop = values.new_zeros(grad.shape)
        jac_loop = None
        if num_l:
            vf = gather_shards(values, mesh, axis, dim=1)
            r_l, ji_l, jj_l = _map_edges(terms, vf[:, sh.lf], vf[:, sh.lt], sh.lmeas)
            ji_l = torch.where(fixed_lf[:, None, None], 0.0, ji_l)
            jj_l = torch.where(fixed_lt[:, None, None], 0.0, jj_l)
            lam_r_l = _info_vec(sh.linfo, r_l)
            if d == 0:  # the closures' cost is counted once
                cost = cost + _half_cost(r_l, lam_r_l)
            for rows, own, jac in ((lf_rows, own_f, ji_l), (lt_rows, own_t, jj_l)):
                grad.index_add_(-2, rows, torch.where(own[:, None], _jt_vec(jac, lam_r_l), 0.0))
                diag_loop.index_add_(-2, rows, torch.where(
                    own[:, None], _small_sum(jac * _info_mat(sh.linfo, jac)), 0.0))
            jac_loop = (ji_l, jj_l)
        grad = torch.where(fixed_l[:, None], 0.0, grad)
        return grad, b, (c_full[:, :-1], a_left, c_right), jac_loop, diag_loop, cost

    def cost_only(values):
        r_c = _residuals(residual_fn, values, halo_values(values), sh.meas_l)
        cost = _half_cost(r_c, _info_vec(sh.info_l, r_c))
        if num_l:
            vf = gather_shards(values, mesh, axis, dim=1)
            if d == 0:
                r_l = _residuals(residual_fn, vf[:, sh.lf], vf[:, sh.lt], sh.lmeas)
                cost = cost + _half_cost(r_l, _info_vec(sh.linfo, r_l))
        return psum(cost, mesh, axis)

    def u_columns(ji_l, jj_l):
        """This rank's rows of U [G, m, t, K]: column (e, a) holds ji[e, a]
        at row lf[e] and jj[e, a] at row lt[e]."""
        g = ji_l.shape[0]
        rhs = ji_l.new_zeros((g, m, tdim, k_w))
        g_idx = torch.arange(g, device=rhs.device)[:, None, None, None]
        t_idx = torch.arange(tdim, device=rhs.device)
        for rows, own, jac in ((lf_rows, own_f, ji_l), (lt_rows, own_t, jj_l)):
            scatter_add_(rhs, (g_idx, rows[:, None, None], t_idx, cols[:, :, None]),
                         torch.where(own[:, None, None], jac, 0.0))
        return rhs

    def ut_apply(z, ji_l, jj_l):
        """Uᵀ z [G, K, k] for z [G, m, t, k]: local row gathers, one psum."""
        zi = torch.where(own_f[:, None, None], z[:, lf_rows], 0.0)
        zj = torch.where(own_t[:, None, None], z[:, lt_rows], 0.0)
        out = small_mm(ji_l, zi) + small_mm(jj_l, zj)
        return psum(out.reshape(z.shape[0], k_w, z.shape[-1]), mesh, axis)

    def lin_solve(grad, b, c, jac_loop, diag_loop, damping):
        c_int, a_left, c_right = c
        # scaled LM damping of the full diagonal (sparse.rs:34-42)
        lam = damping[:, None, None] * torch.clamp(
            (b.diagonal(dim1=-2, dim2=-1) + diag_loop).abs(), min=1.0)
        bd = torch.where(fixed_l[:, None, None], eye_t, b + torch.diag_embed(lam))
        if jac_loop is None:
            return spike_solve_local(bd, c_int, a_left, c_right, -grad[..., None], mesh,
                                     axis)[..., 0]
        # one SPIKE solve for [-grad | U]; one psum for Uᵀ[y0 | T⁻¹U]
        sol = spike_solve_local(bd, c_int, a_left, c_right,
                                torch.cat([-grad[..., None], u_columns(*jac_loop)], -1),
                                mesh, axis)
        uts = ut_apply(sol, *jac_loop)
        coef = torch.linalg.solve_ex(sh.w_inv + uts[..., 1:], uts[..., :1])[0]
        y0, yu = sol[..., 0], sol[..., 1:]
        return y0 - (yu.flatten(-3, -2) @ coef).reshape(y0.shape)

    return linearize, cost_only, lin_solve, _step_applier(fixed_l, retract_fn)


def _reducer(mesh, axis):
    """`lm_step`'s reduce hook over the axis (finiteness as int32: MIN)."""
    def reduce(x, op):
        if op == "min":
            return pmin(x.to(torch.int32), mesh, axis) > 0
        return (pmax if op == "max" else psum)(x, mesh, axis)
    return reduce


def sharded_chain_lm_start(mesh, axis: str, values0, chain_meas, chain_info, loop_from, loop_to,
                           loop_meas, loop_info, fixed_mask, *, residual_fn, retract_fn,
                           tdim: int, gradient_tolerance: float = 1e-10,
                           step_tolerance: float = 1e-10, cost_tolerance: float = 1e-12,
                           initial_damping: float = 1e-3):
    """The sharded chain LM's first state (this rank's rows, values
    [1, m, dim]) and its step, in `nlls/tridiag.py::chain_lm_start`'s form
    (arguments as `make_sharded_chain_solver` and its solve): step(state)
    is one LM iteration on every rank and reads nothing back."""
    sh = _ChainShard(mesh, axis, values0, chain_meas, chain_info, loop_from, loop_to, loop_meas,
                     loop_info, fixed_mask)
    linearize, cost_only, lin_solve, apply_step = _make_local_ops(
        sh, mesh, axis, tdim=tdim, residual_fn=residual_fn, retract_fn=retract_fn)
    values = sh.values_l[None]
    with full_fp32_matmul():
        state = lm_state(values, cost_only(values), initial_damping)
    return state, lm_step(linearize, lin_solve, apply_step, cost_only, gradient_tolerance,
                          step_tolerance, cost_tolerance, reduce=_reducer(mesh, axis))


def make_sharded_chain_solver(mesh, axis: str, *, residual_fn, retract_fn, tdim: int,
                              max_iterations: int = 50, gradient_tolerance: float = 1e-10,
                              step_tolerance: float = 1e-10, cost_tolerance: float = 1e-12,
                              initial_damping: float = 1e-3):
    """A `solve_chain_lm` whose rows are split over `axis` of `mesh`.

    Returns solve(values0 [n, dim], chain_meas [n-1, rdim], chain_info
    [n-1, rdim, rdim] or None (identity), loop_from, loop_to, loop_meas,
    loop_info (or None), fixed_mask [n]) -> (values [n, dim], ChainSummary
    of device tensors): the arguments global (the same on every rank),
    placed on the mesh's device in values0's dtype; the values come back
    gathered on every rank. n is padded to a multiple of the axis size.
    The LM is `solve_chain_lm`'s, its decisions reduced over the ranks;
    the capacitance system is solved by LU (`solve_ex`), as JAX's
    `jnp.linalg.solve`, where `solve_chain_lm` takes Cholesky."""
    lm_kw = dict(residual_fn=residual_fn, retract_fn=retract_fn, tdim=tdim,
                 gradient_tolerance=gradient_tolerance, step_tolerance=step_tolerance,
                 cost_tolerance=cost_tolerance, initial_damping=initial_damping)

    def solve(values0, chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info,
              fixed_mask):
        state, step = sharded_chain_lm_start(mesh, axis, values0, chain_meas, chain_info,
                                             loop_from, loop_to, loop_meas, loop_info,
                                             fixed_mask, **lm_kw)
        values_l, summary = finish(state, lm_run(state, step, max_iterations), False)
        return gather_shards(values_l, mesh, axis)[:values0.shape[0]], summary

    return solve


def make_sharded_chain_ift(mesh, axis: str, *, residual_fn, retract_fn, tdim: int, loss_fn):
    """IFT gradients through the sharded SPIKE chain solve.

    Returns ift(values_solved [n, dim], chain_meas, chain_info, loop_from,
    loop_to, loop_meas, loop_info, fixed_mask) -> (loss, d_chain_meas
    [n-1, rdim], d_loop_meas [L, rdim]), every argument global as
    `make_sharded_chain_solver`'s, with the semantics of
    `nlls/implicit.py::chain_implicit_vjp`. H w = u is solved by the
    forward pass's SPIKE ladder and Woodbury at damping 0. There is no
    autograd through a collective: each rank computes the loss on the
    (global) values and differentiates it through its own rows only, pulls
    w back through the cost of its own edges (the halo row's w comes by
    one ring shift), and through the closures on the endpoints it owns;
    one psum assembles d_chain_meas and sums the closures' shares."""

    def ift(values, chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info,
            fixed_mask):
        with full_fp32_matmul():
            sh = _ChainShard(mesh, axis, values, chain_meas, chain_info, loop_from, loop_to,
                             loop_meas, loop_info, fixed_mask)
            linearize, _, lin_solve, _ = _make_local_ops(
                sh, mesh, axis, tdim=tdim, residual_fn=residual_fn, retract_fn=retract_fn)
            d, m, num_l = sh.d, sh.m, sh.num_l
            retract_local = _retractor(sh.values_l, sh.fixed_l, retract_fn)

            def loss_of(delta_l):
                full = torch.cat([sh.values[:d * m], retract_local(delta_l),
                                  sh.values[(d + 1) * m:]])
                return loss_fn(full[:sh.n])

            zero_l = sh.values_l.new_zeros((m, tdim))
            u_l, loss = torch.func.grad_and_value(loss_of)(zero_l)
            u_l = torch.where(sh.fixed_l[:, None], 0.0, u_l)

            # H w = u: the forward lin_solve at damping 0 solves H δ = -grad
            _, b, c, jac_loop, diag_loop, _ = linearize(sh.values_l[None])
            w_l = lin_solve(-u_l[None], b, c, jac_loop, diag_loop,
                            u_l.new_zeros((1,)))[0]
            w_l = torch.where(sh.fixed_l[:, None], 0.0, w_l)

            # dL/dm = -(∂g/∂m)ᵀ w over this rank's edges: its m chain edges
            # (the last reaches the halo row) and the closures' endpoints it
            # owns, as rows [local | halo | loop_from | loop_to]
            left, _ = _shifts(mesh, axis)
            w_ext = [w_l, ppermute(w_l[:1], mesh, axis, left)]
            x_ext = [sh.values_l, sh.halo_row(sh.values)]
            fixed_ext = [sh.fixed_l, sh.halo_row(sh.fixed)]
            for idx in (sh.lf, sh.lt):
                rows, own = sh.local_rows(idx)
                w_ext.append(torch.where(own[:, None], w_l[rows], 0.0))
                x_ext.append(sh.values[idx])
                fixed_ext.append(sh.fixed[idx])
            x_ext = torch.cat(x_ext)
            ar_m = torch.arange(m, device=x_ext.device)
            ar_l = torch.arange(num_l, device=x_ext.device) + m + 1
            tangent_grad = _edge_cost_grad(
                residual_fn, _retractor(x_ext, torch.cat(fixed_ext), retract_fn),
                x_ext.new_zeros((x_ext.shape[0], tdim)),
                ((ar_m, ar_m + 1, sh.info_l), (ar_l, ar_l + num_l, sh.linfo)))
            _, pullback = torch.func.vjp(tangent_grad, sh.meas_l, sh.lmeas)
            d_meas_l, d_lmeas = pullback(-torch.cat(w_ext))

            rdim = sh.rdim
            packed = w_l.new_zeros((sh.n_pad + num_l) * rdim)
            packed[d * m * rdim:(d + 1) * m * rdim] = d_meas_l.reshape(-1)
            packed[sh.n_pad * rdim:] = d_lmeas.reshape(-1)
            packed = psum(packed, mesh, axis)
            return (loss, packed[:(sh.n - 1) * rdim].reshape(sh.n - 1, rdim),
                    packed[sh.n_pad * rdim:].reshape(num_l, rdim))

    return ift
