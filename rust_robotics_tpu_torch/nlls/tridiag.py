"""Chain NLLS: cyclic-reduction block-tridiagonal solve, Woodbury
loop-closure correction and a Levenberg-Marquardt loop with no host read
inside an iteration.

The port of rust_robotics_tpu/nlls/tridiag.py (reference: the large
pose-graph benchmark, crates/rust_robotics/examples/
benchmark_large_pose_graph.rs:19-97, and the LM semantics of
rust_robotics_optimization/src/solver.rs:81-188 with the scaled diagonal
damping of sparse.rs:34-42). A sequential pose graph is an odometry chain
plus a few loop closures, so its Gauss-Newton system is

    H = T + U W Uᵀ,   T block-tridiagonal,  rank(U W Uᵀ) = rdim · L.

- T⁻¹ is applied by cyclic reduction (`block_tridiag_factor` /
  `block_tridiag_apply`): pad to a power of two with decoupled identity
  equations, then log2(n) levels of batched d×d block inverses and
  matmuls. Every array carries any number of leading batch dimensions
  (`[..., n, d, d]`), so one ladder serves the single chain, the nested
  solve's segment batch and a batch of graphs. Each level is one Python
  iteration; the JAX package's lane-major (SoA) layouts and its
  unroll-or-scan split exist for XLA on the TPU and are left out.
- Loop closures enter through the Woodbury identity; U's columns are
  streamed through the ladder in edge chunks sized by
  `WOODBURY_CHUNK_BYTES`, and the (L·rdim)² capacitance system is factored
  by `torch.linalg.cholesky_ex`, which does not read back. Where it rejects
  the system (info ≠ 0) the solution is set to NaN, as JAX's `cho_factor`
  yields NaN there, so the LM's finiteness guard marks the graph bad on
  the device.
- `solve_chain_lm` is one LM loop over a leading batch axis of graphs with
  per-graph damping, cost and termination. Its step (linearise, damp,
  solve, trial cost, accept) reads nothing back; the loop reads
  `done.all()` once per iteration. A graph that has finished freezes
  (solver.rs semantics per graph), so a batched solve walks each graph's
  solo trajectory, as the JAX package's vmapped `while_loop` does.
- A graph's arithmetic does not depend on the batch around it: blocks of
  at most `SMALL_BLOCK` rows are multiplied by explicit multiply-adds
  (`small_mm`), sums over a graph are halving adds, and the capacitance
  factor takes one cuSOLVER algorithm per system size. So a lane of a
  lock-step batch equals its solo solve (bitwise on the H100).
- The matmuls run at full float32 precision (TF32 off), as the JAX loop
  runs under `default_matmul_precision("float32")`.

Left out: the SPIKE-chunked ladder (`chunked_tridiag_*`, `ChunkedFactor`;
`chunks > 1` raises) and the host-stepped loop (`host_loop`), which
answer an XLA compile ceiling and a TPU runtime fault (ROADMAP.md A10).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small

# Memory budget for one Woodbury edge chunk's ladder solve (the sizing
# formula counts ~2x the arrays alive). Read at call time: a test may lower
# it, or pass `chunk_bytes`, to force several chunks.
WOODBURY_CHUNK_BYTES = 18 * 512 * 1024 * 1024


def _host(x):
    """A host numpy copy of an array or tensor (a read-back for a CUDA
    tensor: set-up only, never inside an LM iteration)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def full_fp32_matmul():
    """Full-precision float32 matmuls (TF32 off) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# Blocks up to this width (the chain's SE(2) and SE(3) tangents) are
# multiplied by `small_mm`, wider (the banded solver's fat blocks) by
# cuBLAS.
SMALL_BLOCK = 8


def small_mm(a, b):
    """a @ b ([..., m, k] @ [..., k, n]) as k explicit multiply-adds, for a
    small k. Each entry takes the same elementwise operations whatever
    batch it sits in; a cuBLAS product picks its kernel, and with it the
    rounding, by the batch count (seen on the H100 for [., 3, 3] @ [., 3,
    r]), and a lock-step batch of graphs must walk its graphs' solo
    trajectories."""
    out = a[..., :, :1] * b[..., :1, :]
    for i in range(1, a.shape[-1]):
        out = torch.addcmul(out, a[..., :, i:i + 1], b[..., i:i + 1, :])
    return out


def _mm_for(d):
    return small_mm if d <= SMALL_BLOCK else torch.matmul


def _small_sum(x):
    """x summed over axis -2 by explicit adds (batch-invariant, as
    `small_mm`)."""
    out = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        out = out + x[..., i, :]
    return out


def inv_spd(m):
    """Batched SPD inverse [..., d, d]: the closed form for d ≤ 4
    (`ops/smallmat.py`), above that a recursive Schur partition (pure
    batched products down to the closed-form leaves). Cyclic reduction's
    Schur complements of an SPD system stay SPD, so every sub-block the
    recursion inverts is SPD. Its accuracy falls behind a Cholesky inverse
    beyond a condition number of ~1e4 (the JAX package's measured
    envelope); the damped Gauss-Newton blocks sit well inside it."""
    return _inv_spd(m, _mm_for(m.shape[-1]))


def _inv_spd(m, mm):
    d = m.shape[-1]
    if d <= 4:
        return inv_spd_small(m)
    h = d // 2
    a, b, c = m[..., :h, :h], m[..., :h, h:], m[..., h:, h:]
    a_inv = _inv_spd(a, mm)
    ainv_b = mm(a_inv, b)
    s_inv = _inv_spd(c - mm(b.mT, ainv_b), mm)
    tl = a_inv + mm(mm(ainv_b, s_inv), ainv_b.mT)
    tr = -mm(ainv_b, s_inv)
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([tr.mT, s_inv], -1)], -2)


class CRFactor(NamedTuple):
    """Cyclic-reduction factorisation of a symmetric block-tridiagonal T:
    per level (e_inv, ae, ce, g, h), each [..., m_i/2, d, d], and the
    inverse of the last reduced block [..., d, d]."""

    levels: tuple
    root_inv: torch.Tensor


def _pow2(n):
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _zeros_rows(like, rows):
    """Zeros [..., rows, d, c] with the leading dims, trailing dims, dtype
    and device of `like` [..., m, d, c]."""
    return like.new_zeros((*like.shape[:-3], rows, *like.shape[-2:]))


def _reduce_level(b, a, c, eye, mm):
    """One cyclic-reduction level (length 2h -> h) with the block product
    `mm`. Returns (stored level, reduced (b, a, c))."""
    be, bo = b[..., 0::2, :, :], b[..., 1::2, :, :]
    ae, ao = a[..., 0::2, :, :], a[..., 1::2, :, :]
    ce, co = c[..., 0::2, :, :], c[..., 1::2, :, :]
    e_inv = inv_spd(be)
    # the right even neighbour of odd row j is row j + 1 (past the end:
    # identity, no coupling)
    zero = _zeros_rows(ae, 1)
    e_inv_r = torch.cat([e_inv[..., 1:, :, :], eye.expand_as(zero)], -3)
    ae_r = torch.cat([ae[..., 1:, :, :], zero], -3)
    ce_r = torch.cat([ce[..., 1:, :, :], zero], -3)
    g = mm(ao, e_inv)
    h = mm(co, e_inv_r)
    b_new = bo - mm(g, ce) - mm(h, ae_r)
    return (e_inv, ae, ce, g, h), (b_new, -mm(g, ae), -mm(h, ce_r))


def block_tridiag_factor(diag, upper):
    """Factor T (diag [..., n, d, d], upper [..., n-1, d, d]) by cyclic
    reduction: log2(n) levels of batched block inverses and matmuls. The
    factorisation does not depend on the right-hand side; pair it with
    `block_tridiag_apply` to solve for many (or chunked) right-hand sides."""
    n, d = diag.shape[-3], diag.shape[-1]
    m = _pow2(n)
    eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
    b = diag
    if m > n:
        b = torch.cat([diag, eye.expand(*diag.shape[:-3], m - n, d, d)], -3)
    c = torch.cat([upper, _zeros_rows(diag, m - upper.shape[-3])], -3)  # C_{m-1} = 0
    a = torch.cat([_zeros_rows(diag, 1), c[..., :-1, :, :].mT], -3)  # A_i = C_{i-1}ᵀ
    levels = []
    while b.shape[-3] > 1:
        level, (b, a, c) = _reduce_level(b, a, c, eye, _mm_for(d))
        levels.append(level)
    return CRFactor(tuple(levels), inv_spd(b[..., 0, :, :]))


def block_tridiag_apply(factor: CRFactor, rhs):
    """Apply T⁻¹ to rhs [..., n, d, r] with a `block_tridiag_factor`
    result: forward reduction of the right-hand side down the ladder, the
    root solve, then back-substitution level by level."""
    n, d, r = rhs.shape[-3:]
    mm = _mm_for(d)
    m = _pow2(n)
    f = torch.cat([rhs, _zeros_rows(rhs, m - n)], -3) if m > n else rhs
    zero = _zeros_rows(rhs, 1)
    fes = []
    for (_, _, _, g, h) in factor.levels:
        fe, fo = f[..., 0::2, :, :], f[..., 1::2, :, :]
        fes.append(fe)
        f = fo - mm(g, fe) - mm(h, torch.cat([fe[..., 1:, :, :], zero], -3))
    x = mm(factor.root_inv[..., None, :, :], f)
    for (e_inv, ae, ce, _, _), fe in zip(reversed(factor.levels), reversed(fes)):
        xl = torch.cat([zero, x[..., :-1, :, :]], -3)
        x_even = mm(e_inv, fe - mm(ae, xl) - mm(ce, x))
        x = torch.stack([x_even, x], -3).reshape(*x.shape[:-3], 2 * x.shape[-3], -1, r)
    return x[..., :n, :, :]


def block_tridiag_solve(diag, upper, rhs):
    """Solve the symmetric block-tridiagonal system T x = rhs by cyclic
    reduction: diag [..., n, d, d] (SPD after LM damping), upper
    [..., n-1, d, d] (C_i couples rows i and i+1; the lower side is C_iᵀ),
    rhs [..., n, d, r]."""
    return block_tridiag_apply(block_tridiag_factor(diag, upper), rhs)


def _map_edges(fn, xi, xj, meas):
    """fn(xi, xj, meas) over the edges [..., E, dim] of every graph in the
    leading dims; `meas` [E, ...] is shared by the graphs."""
    lead = xi.shape[:-2]
    xi = xi.reshape(-1, *xi.shape[-2:])
    xj = xj.reshape(-1, *xj.shape[-2:])
    out = torch.func.vmap(torch.func.vmap(fn), in_dims=(0, 0, None))(xi, xj, meas)
    return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)


def _edge_terms(residual_fn, retract_fn, tdim):
    """Per edge: residual r0 [rdim] and the tangent Jacobians (ji, jj)
    [rdim, tdim] at δ = 0, in reverse mode (`jacrev`): torch's forward mode
    promotes 0-d float32 tangents to float64 (ROADMAP.md C)."""
    def terms(xi, xj, meas):
        z = torch.zeros(tdim, dtype=xi.dtype, device=xi.device)

        def r_of(di, dj):
            r = residual_fn(retract_fn(xi, di), retract_fn(xj, dj), meas)
            return r, r

        (ji, jj), r0 = torch.func.jacrev(r_of, argnums=(0, 1), has_aux=True)(z, z)
        return r0, ji, jj
    return terms


def _residuals(residual_fn, xi, xj, meas):
    return _map_edges(lambda a, b, m: (residual_fn(a, b, m),), xi, xj, meas)[0]


def _tree_sum(x):
    """Sum over the trailing two axes by halving adds: a graph's sum has
    the same bits whatever batch it sits in (a reduction kernel's order
    changes with the number of outputs), so a batched solve can equal its
    members' solo solves."""
    x = x.flatten(-2)
    n = x.shape[-1]
    if _pow2(n) > n:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], _pow2(n) - n))], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _half_cost(r, lam_r):
    return 0.5 * _tree_sum(r * lam_r)


def chain_linearize(values, chain_meas, chain_info, loop_from, loop_to, loop_meas,
                    loop_info, fixed, *, residual_fn, retract_fn, tdim):
    """Gauss-Newton linearisation of a chain factor graph with loop
    closures at `values` [..., n, dim]. Returns (grad [..., n, t], B
    [..., n, t, t] diagonal blocks, C [..., n-1, t, t] super-diagonal
    blocks, jac_loop (ji_l, jj_l) [..., L, r, t] raw loop Jacobians or
    None, diag_loop [..., n, t] loop Hessian diagonal, cost [...])."""
    num_l = loop_from.shape[0]
    terms = _edge_terms(residual_fn, retract_fn, tdim)

    # chain edges
    r_c, ji_c, jj_c = _map_edges(terms, values[..., :-1, :], values[..., 1:, :], chain_meas)
    ji_c = torch.where(fixed[:-1, None, None], 0.0, ji_c)
    jj_c = torch.where(fixed[1:, None, None], 0.0, jj_c)
    lam_r_c = _info_vec(chain_info, r_c)
    cost = _half_cost(r_c, lam_r_c)
    lam_ji = _info_mat(chain_info, ji_c)
    lam_jj = _info_mat(chain_info, jj_c)

    grad = values.new_zeros((*values.shape[:-1], tdim))
    grad[..., :-1, :] += _jt_vec(ji_c, lam_r_c)
    grad[..., 1:, :] += _jt_vec(jj_c, lam_r_c)
    b = values.new_zeros((*values.shape[:-1], tdim, tdim))
    b[..., :-1, :, :] += _jt_mat(ji_c, lam_ji)
    b[..., 1:, :, :] += _jt_mat(jj_c, lam_jj)
    c = _jt_mat(ji_c, lam_jj)

    diag_loop = values.new_zeros((*values.shape[:-1], tdim))
    jac_loop = None
    if num_l:
        r_l, ji_l, jj_l = _map_edges(terms, values[..., loop_from, :], values[..., loop_to, :],
                                     loop_meas)
        ji_l = torch.where(fixed[loop_from, None, None], 0.0, ji_l)
        jj_l = torch.where(fixed[loop_to, None, None], 0.0, jj_l)
        lam_r_l = _info_vec(loop_info, r_l)
        cost = cost + _half_cost(r_l, lam_r_l)
        grad.index_add_(-2, loop_from, _jt_vec(ji_l, lam_r_l))
        grad.index_add_(-2, loop_to, _jt_vec(jj_l, lam_r_l))
        # U W Uᵀ's diagonal, for the damping magnitude (sparse.rs:34-42
        # damps the full H diagonal)
        diag_loop.index_add_(-2, loop_from, _small_sum(ji_l * _info_mat(loop_info, ji_l)))
        diag_loop.index_add_(-2, loop_to, _small_sum(jj_l * _info_mat(loop_info, jj_l)))
        # the raw loop Jacobians are the Woodbury factor; U itself ([n, t,
        # K]) is never built
        jac_loop = (ji_l, jj_l)
    grad = torch.where(fixed[:, None], 0.0, grad)
    return grad, b, c, jac_loop, diag_loop, cost


def _info_vec(info, v):
    """Λ_e v_e: info [E, r, r] or None (identity), v [..., E, r]."""
    return v if info is None else small_mm(info, v[..., None])[..., 0]


def _info_mat(info, v):
    """Λ_e V_e: info [E, r, r] or None (identity), V [..., E, r, k]."""
    return v if info is None else small_mm(info, v)


def _jt_vec(j, v):
    """J_eᵀ v_e: J [..., E, r, t], v [..., E, r] -> [..., E, t]."""
    return small_mm(j.mT, v[..., None])[..., 0]


def _jt_mat(j, m):
    """J_eᵀ M_e: J [..., E, r, t], M [..., E, r, k] -> [..., E, t, k]."""
    return small_mm(j.mT, m)


def build_w_inv(loop_info, num_l, rdim, dtype, device=None):
    """Block-diagonal W⁻¹ [K, K] of the loop-edge information blocks
    (identity blocks when `loop_info` is None), on `loop_info`'s device or
    `device`."""
    if loop_info is not None:
        device = loop_info.device
    device = resolve_device(device)
    blocks = (torch.eye(rdim, dtype=dtype, device=device).expand(num_l, rdim, rdim)
              if loop_info is None else inv_spd(loop_info.to(dtype)))
    w_inv = torch.zeros((num_l, rdim, num_l, rdim), dtype=dtype, device=device)
    el = torch.arange(num_l, device=device)
    w_inv[el, :, el, :] = blocks
    return w_inv.reshape(num_l * rdim, num_l * rdim)


def _t_matvec(bd, c, v):
    """T v for the block-tridiagonal T (diag bd, upper c) and v [..., n, t]."""
    tv = small_mm(bd, v[..., None])[..., 0]
    tv[..., :-1, :] += small_mm(c, v[..., 1:, :, None])[..., 0]
    tv[..., 1:, :] += _jt_vec(c, v[..., :-1, :])
    return tv


# cuSOLVER factors a batch of matrices by another algorithm than a single
# matrix, and the two round differently (seen on the H100). A graph's
# capacitance factor must not depend on the batch around it, or a lock-step
# batch would not walk its graphs' solo trajectories; so systems of at most
# this size always take the batched algorithm (a single one padded with an
# identity), larger ones always the single-matrix one, graph by graph.
BATCHED_CHOLESKY_MAX = 32


def _cholesky_ex(s):
    """`torch.linalg.cholesky_ex` of s [..., K, K], the same algorithm for
    a graph whatever the batch around it. Returns (L, info [...])."""
    k = s.shape[-1]
    flat = s.reshape(-1, k, k)
    if k <= BATCHED_CHOLESKY_MAX:
        g = flat.shape[0]
        if g == 1:
            flat = torch.cat([flat, torch.eye(k, dtype=s.dtype, device=s.device)[None]])
        low, info = torch.linalg.cholesky_ex(flat)
        low, info = low[:g], info[:g]
    else:
        low, info = map(torch.stack, zip(*(torch.linalg.cholesky_ex(m) for m in flat)))
    return low.reshape(s.shape), info.reshape(s.shape[:-2])


def capacitance_solver(s, spd=True):
    """Factor the capacitance system s [..., K, K] without reading back.
    Returns (solve, failed): solve(r [..., K, k]) -> s⁻¹ r, and failed
    [...] true where the factorisation was rejected (info ≠ 0).

    spd: Cholesky (`cholesky_ex`, the same algorithm for a graph whatever
    its batch, and two triangular solves); else LU
    (`lu_factor_ex` + `lu_solve`), the robust choice for a nearly-SPD
    indefinite s, which f32 assembly error can produce on an undamped
    system."""
    if spd:
        low, info = _cholesky_ex(s)

        def solve(r):
            y = torch.linalg.solve_triangular(low, r, upper=False)
            return torch.linalg.solve_triangular(low.mT, y, upper=True)
    else:
        lu, piv, info = torch.linalg.lu_factor_ex(s)

        def solve(r):
            return torch.linalg.lu_solve(lu, piv, r)
    return solve, info != 0


def _u_columns(n, ji, jj, ef, et):
    """U's columns of a chunk of cs edges as a right-hand side [..., n, t,
    cs·r]: column (e, a) holds ji[e, a] at row block ef[e] and jj[e, a] at
    row block et[e]."""
    cs, r, t = ji.shape[-3:]
    u = ji.new_zeros((*ji.shape[:-3], n * cs, r, t))
    ar = torch.arange(cs, device=ji.device)
    u.index_add_(-3, ef * cs + ar, ji)
    u.index_add_(-3, et * cs + ar, jj)
    u = u.reshape(*ji.shape[:-3], n, cs, r, t).movedim(-1, -3)
    return u.reshape(*ji.shape[:-3], n, t, cs * r)


def chain_woodbury_solve(bd, c, jac_loop, loop_from, loop_to, w_inv, rhs_vec, w_blocks=None,
                         refine=0, chunk_bytes=None, chunks=0, spd=True):
    """x = (T + U W Uᵀ)⁻¹ rhs_vec for an assembled chain system.

    bd [..., n, t, t] damped diagonal blocks, c [..., n-1, t, t]
    super-diagonal, jac_loop = (ji_l, jj_l) [..., L, r, t] raw loop
    Jacobians (or None), w_inv [K, K], rhs_vec [..., n, t]. U's columns
    are streamed through the ladder in edge chunks sized by `chunk_bytes`
    (default `WOODBURY_CHUNK_BYTES`): no O(n·K) array beyond one chunk.

    refine: iterative-refinement passes x += H⁻¹(b − Hx), which need the
    loop information blocks `w_blocks` [L, r, r] when loops are present.
    spd: see `capacitance_solver`. A graph whose capacitance factorisation
    is rejected gets a NaN solution."""
    if chunks and chunks > 1:
        raise NotImplementedError(
            "chunks > 1 (the SPIKE-chunked ladder) is not ported; ROADMAP.md A10 "
            "leaves it out: the plain ladder serves every n on the GPU")
    n, tdim = bd.shape[-3], bd.shape[-1]
    fac = block_tridiag_factor(bd, c)

    def t_apply(v):
        return block_tridiag_apply(fac, v[..., None])[..., 0]

    if jac_loop is None:
        x = t_apply(rhs_vec)
        for _ in range(refine):
            x = x + t_apply(rhs_vec - _t_matvec(bd, c, x))
        return x
    ji_l, jj_l = jac_loop
    num_l, rdim = loop_from.shape[0], ji_l.shape[-2]
    k_w = num_l * rdim
    bytes_per_edge = 3 * 2 * _pow2(n) * 8 * 4 * rdim
    budget = WOODBURY_CHUNK_BYTES if chunk_bytes is None else chunk_bytes
    cs = max(1, min(num_l, budget // bytes_per_edge))

    def ut_apply(z):
        """Uᵀ z for z [..., n, t, k] -> [..., K, k] (U's only non-zero rows
        are the loop endpoints)."""
        out = small_mm(ji_l, z[..., loop_from, :, :]) + small_mm(jj_l, z[..., loop_to, :, :])
        return out.reshape(*out.shape[:-3], k_w, out.shape[-1])

    def u_scatter(cb):
        """U v: per-edge coefficients [..., L, r] -> [..., n, t]."""
        out = rhs_vec.new_zeros(rhs_vec.shape)
        out.index_add_(-2, loop_from, _jt_vec(ji_l, cb))
        out.index_add_(-2, loop_to, _jt_vec(jj_l, cb))
        return out

    # S = W⁻¹ + Uᵀ T⁻¹ U, its columns chunk by chunk of edges
    uty = torch.cat([
        ut_apply(block_tridiag_apply(fac, _u_columns(
            n, ji_l[..., e0:e0 + cs, :, :], jj_l[..., e0:e0 + cs, :, :],
            loop_from[e0:e0 + cs], loop_to[e0:e0 + cs])))
        for e0 in range(0, num_l, cs)], -1)
    s_solve, failed = capacitance_solver(w_inv + uty, spd)

    def solve_once(b_vec):
        y0 = t_apply(b_vec)
        coef = s_solve(ut_apply(y0[..., None]))[..., 0]
        return y0 - t_apply(u_scatter(coef.reshape(*coef.shape[:-1], num_l, rdim)))

    x = solve_once(rhs_vec)
    if refine:
        if w_blocks is None:
            raise ValueError("refine needs the loop information blocks w_blocks")

        def h_apply(v):
            utv = ut_apply(v[..., None])[..., 0].reshape(*v.shape[:-2], num_l, rdim)
            return _t_matvec(bd, c, v) + u_scatter(_info_vec(w_blocks, utv))

        for _ in range(refine):
            x = x + solve_once(rhs_vec - h_apply(x))
    return torch.where(failed[..., None, None], torch.nan, x)


class NestedPartition(NamedTuple):
    """Two-level partition of a chain with loop closures: every closure
    endpoint is a separator; the chain intervals between consecutive
    separators are eliminated as one batch (padded to one length), leaving
    a block-tridiagonal system over the separators whose Woodbury rides a
    ~2L-row ladder. Built on the host by `nested_partition`."""

    bounds: torch.Tensor    # [nb] separator pose ids (includes 0, n-1)
    seg_idx: torch.Tensor   # [ns, m] interior pose ids; sentinel n invalid
    seg_mask: torch.Tensor  # [ns, m] valid interior rows
    cmask: torch.Tensor     # [ns, m-1] valid interior couplings
    last_pos: torch.Tensor  # [ns] index of the last valid interior row
    left_c: torch.Tensor    # [ns] c index coupling bounds[k] -> interior
    right_c: torch.Tensor   # [ns] c index coupling interior -> bounds[k+1]
    direct: torch.Tensor    # [ns] empty interior: bounds adjacent in T
    loop_kf: torch.Tensor   # [L] closure endpoints in separator coordinates
    loop_kt: torch.Tensor


def nested_partition(n, loop_from, loop_to, device=None):
    """Build the NestedPartition for `chain_nested_solve` on the host
    (numpy), then place it on `loop_from`'s device if it is a tensor, else
    on `device` (default cuda)."""
    if n < 2:
        raise ValueError("nested solve needs n >= 2")
    if isinstance(loop_from, torch.Tensor) and device is None:
        device = loop_from.device
    device = resolve_device(device)
    lf = _host(loop_from).astype(np.int64)
    lt = _host(loop_to).astype(np.int64)
    bounds = np.unique(np.concatenate([np.array([0, n - 1], np.int64), lf, lt]))
    seg_len = bounds[1:] - bounds[:-1] - 1
    m = max(int(seg_len.max(initial=0)), 1)
    ar = np.arange(m)
    mask = ar[None, :] < seg_len[:, None]
    idx = np.where(mask, bounds[:-1, None] + 1 + ar[None, :], n)
    cmask = ar[None, :max(m - 1, 0)] < (seg_len - 1)[:, None]
    fields = (bounds, idx, mask, cmask, np.maximum(seg_len - 1, 0), bounds[:-1],
              bounds[1:] - 1, seg_len == 0, np.searchsorted(bounds, lf),
              np.searchsorted(bounds, lt))
    return NestedPartition(*(torch.as_tensor(np.asarray(f), device=device) for f in fields))


def chain_nested_solve(bd, c, jac_loop, w_inv, rhs_vec, part, w_blocks=None):
    """x = (T + U W Uᵀ)⁻¹ rhs by two-level block elimination (exact).

    Closure endpoints are separators, so U is zero on every interior row
    and eliminating the interiors commutes with the Woodbury term. The
    segment interiors are factored and solved as one batch, each against
    2t+1 columns (the left and right boundary couplings and the rhs); the
    Schur system over the nb separators goes to `chain_woodbury_solve`,
    whose ladder is then nb rows long instead of n. Arrays as in
    `chain_woodbury_solve`, with any leading batch dims; `part` from
    `nested_partition`. Counts its calls on `chain_nested_solve.calls`."""
    chain_nested_solve.calls += 1
    n, tdim = bd.shape[-3], bd.shape[-1]
    lead = bd.shape[:-3]
    ns, m = part.seg_idx.shape
    t2 = 2 * tdim
    eye = torch.eye(tdim, dtype=bd.dtype, device=bd.device)

    gather_rows = part.seg_idx.clamp(max=n - 1)
    bdi = torch.where(part.seg_mask[:, :, None, None], bd[..., gather_rows, :, :], eye)
    if m > 1:
        ci = torch.where(part.cmask[:, :, None, None],
                         c[..., part.seg_idx[:, :-1].clamp(max=n - 2), :, :], 0.0)
    else:
        ci = bd.new_zeros((*lead, ns, 0, tdim, tdim))
    fac = block_tridiag_factor(bdi, ci)

    nonempty = part.seg_mask[:, 0, None, None]
    cl = torch.where(nonempty, c[..., part.left_c, :, :], 0.0)
    cr = torch.where(nonempty, c[..., part.right_c.clamp(max=max(n - 2, 0)), :, :], 0.0)
    rhs_i = torch.where(part.seg_mask[:, :, None], rhs_vec[..., gather_rows, :], 0.0)
    last_oh = (torch.arange(m, device=bd.device)[None, :] == part.last_pos[:, None]).to(bd.dtype)

    # 2t+1 columns per segment: T_I⁻¹ [e₀ clᵀ | e_last cr | rhs_I]
    cols = bd.new_zeros((*lead, ns, m, tdim, t2 + 1))
    cols[..., 0, :, :tdim] = cl.mT
    cols[..., tdim:t2] += last_oh[:, :, None, None] * cr[..., None, :, :]
    cols[..., t2] = rhs_i
    g = block_tridiag_apply(fac, cols)  # [..., ns, m, t, 2t+1]
    g0 = g[..., 0, :, :]
    gl = (last_oh[:, :, None, None] * g).sum(-3)

    # Schur corrections onto the separators (T_I⁻¹ is symmetric, so the
    # coarse system stays symmetric with upper-only storage)
    bdc = bd[..., part.bounds, :, :].clone()
    bdc[..., :-1, :, :] -= small_mm(cl, g0[..., :tdim])
    bdc[..., 1:, :, :] -= small_mm(cr.mT, gl[..., tdim:t2])
    cc = -small_mm(cl, g0[..., tdim:t2]) + torch.where(part.direct[:, None, None],
                                                 c[..., part.left_c, :, :], 0.0)
    rc = rhs_vec[..., part.bounds, :].clone()
    rc[..., :-1, :] -= small_mm(cl, g0[..., t2:])[..., 0]
    rc[..., 1:, :] -= small_mm(cr.mT, gl[..., t2:])[..., 0]

    xc = chain_woodbury_solve(bdc, cc, jac_loop, part.loop_kf, part.loop_kt, w_inv, rc,
                              w_blocks=w_blocks)

    # back-substitution: x_I = G_rhs − G_A x_left − G_B x_right
    xi = (g[..., t2]
          - small_mm(g[..., :tdim], xc[..., :-1, None, :, None])[..., 0]
          - small_mm(g[..., tdim:t2], xc[..., 1:, None, :, None])[..., 0])
    x = bd.new_zeros((*lead, n + 1, tdim))  # row n catches the sentinel's writes
    x[..., part.seg_idx, :] = xi
    x[..., part.bounds, :] = xc
    return x[..., :n, :]


chain_nested_solve.calls = 0


class ChainSummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    accepted_steps: torch.Tensor
    termination_code: torch.Tensor  # 0 max_iter 1 grad 2 step 3 cost 4 fail


TERMINATION_NAMES = {0: "max_iterations", 1: "gradient_converged",
                     2: "step_converged", 3: "cost_converged",
                     4: "numerical_failure"}


class LMState(NamedTuple):
    """The LM's state per graph: values [G, n, dim]; the rest [G]."""

    values: torch.Tensor
    damping: torch.Tensor
    cost: torch.Tensor
    it: torch.Tensor
    accepted: torch.Tensor
    term: torch.Tensor
    done: torch.Tensor


def lm_state(values, cost, initial_damping):
    """The LM's first state for values [G, n, dim] at cost [G]."""
    g = values.shape[0]
    zeros = torch.zeros(g, dtype=torch.int32, device=values.device)
    return LMState(values, torch.full_like(cost, initial_damping), cost, zeros, zeros, zeros,
                   torch.zeros(g, dtype=torch.bool, device=values.device))


def lm_step(linearize, lin_solve, apply_step, cost_only, gradient_tolerance, step_tolerance,
            cost_tolerance):
    """One LM iteration per graph (solver.rs:81-188): linearise, gradient
    check, solve, step check, trial, accept (damping ×0.3, cost-change
    check) or reject (damping ×10). A graph that is done freezes. Reads
    nothing back from the device."""
    def step(s: LMState) -> LMState:
        with full_fp32_matmul():
            grad, b, c, jac_loop, diag_loop, _ = linearize(s.values)
            grad_conv = grad.abs().amax(dim=(-2, -1)) <= gradient_tolerance
            delta = lin_solve(grad, b, c, jac_loop, diag_loop, s.damping)
            bad = ~torch.isfinite(delta).all(dim=-1).all(dim=-1)
            step_conv = torch.sqrt(_tree_sum(delta * delta)) <= step_tolerance
            trial = apply_step(s.values, delta)
            trial_cost = cost_only(trial)
        # ~done: a graph that has finished freezes, so each graph of a
        # batch walks its solo trajectory
        accept = ~s.done & ~grad_conv & ~step_conv & ~bad & (trial_cost < s.cost)
        cost_conv = accept & ((s.cost - trial_cost).abs() <= cost_tolerance)
        damping = torch.where(accept, torch.clamp(s.damping * 0.3, min=1e-15),
                              torch.clamp(s.damping * 10.0, max=1e15))
        stop = s.done | grad_conv | step_conv | bad
        term = torch.where(grad_conv, 1, torch.where(bad, 4, torch.where(
            step_conv, 2, torch.where(cost_conv, 3, 0)))).to(torch.int32)
        return LMState(
            torch.where(accept[:, None, None], trial, s.values),
            torch.where(stop, s.damping, damping),
            torch.where(accept, trial_cost, s.cost),
            s.it + (~s.done).to(torch.int32),
            s.accepted + accept.to(torch.int32),
            torch.where(s.done, s.term, term),
            stop | cost_conv)
    return step


def lm_run(state: LMState, step, max_iterations):
    """Run `step` until every graph is done or `max_iterations` steps. The
    one read-back per iteration is `done.all()`."""
    for k in range(max_iterations):
        if k and bool(state.done.all()):
            break
        state = step(state)
    return state


def _chain_lm_ops(chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info, fixed, *,
                  residual_fn, retract_fn, tdim, refine, woodbury_chunk_bytes, rdim,
                  nested_part=None):
    """(linearize, lin_solve, apply_step, cost_only) of a chain problem for
    values [G, n, dim]."""
    num_l = loop_from.shape[0]
    rdim = chain_meas.shape[-1] if rdim is None else rdim
    f_ = chain_meas.dtype
    dev = chain_meas.device
    w_inv = build_w_inv(loop_info, num_l, rdim, f_, dev) if num_l else None
    w_blocks = None
    if num_l:
        w_blocks = (torch.eye(rdim, dtype=f_, device=dev).expand(num_l, rdim, rdim)
                    if loop_info is None else loop_info)
    eye_t = torch.eye(tdim, dtype=f_, device=dev)

    def linearize(values):
        return chain_linearize(values, chain_meas, chain_info, loop_from, loop_to, loop_meas,
                               loop_info, fixed, residual_fn=residual_fn,
                               retract_fn=retract_fn, tdim=tdim)

    def cost_only(values):
        r_c = _residuals(residual_fn, values[..., :-1, :], values[..., 1:, :], chain_meas)
        cost = _half_cost(r_c, _info_vec(chain_info, r_c))
        if num_l:
            r_l = _residuals(residual_fn, values[..., loop_from, :], values[..., loop_to, :],
                             loop_meas)
            cost = cost + _half_cost(r_l, _info_vec(loop_info, r_l))
        return cost

    def lin_solve(grad, b, c, jac_loop, diag_loop, damping):
        # scaled LM damping of the full diagonal (sparse.rs:34-42)
        diag_t = b.diagonal(dim1=-2, dim2=-1)
        lam = damping[..., None, None] * torch.clamp((diag_t + diag_loop).abs(), min=1.0)
        bd = torch.where(fixed[:, None, None], eye_t, b + torch.diag_embed(lam))
        if nested_part is not None:
            return chain_nested_solve(bd, c, jac_loop, w_inv, -grad, nested_part,
                                      w_blocks=w_blocks)
        return chain_woodbury_solve(bd, c, jac_loop, loop_from, loop_to, w_inv, -grad,
                                    w_blocks=w_blocks, refine=refine,
                                    chunk_bytes=woodbury_chunk_bytes)

    return linearize, lin_solve, _step_applier(fixed, retract_fn), cost_only


def _step_applier(fixed, retract_fn):
    """apply_step(values [G, n, dim], delta [G, n, t]): retract every node,
    fixed nodes by a zero increment."""
    def apply_step(values, delta):
        delta = torch.where(fixed[:, None], 0.0, delta)
        return torch.func.vmap(torch.func.vmap(retract_fn))(values, delta)
    return apply_step


def _use_nested(n, loop_from, loop_to, nested, chunked):
    """The auto rule of the JAX package (tridiag.py:1194-1205): nested for
    n >= 50 000, at least 64 closures and a separator set of at most n/8."""
    num_l = int(loop_from.shape[0])
    if nested is None:
        nested = False
        if num_l >= 64 and n >= 50_000 and not chunked:
            nb = len(np.unique(np.concatenate(
                [np.array([0, n - 1]), _host(loop_from), _host(loop_to)])))
            nested = nb <= n // 8
    if nested and chunked:
        raise ValueError("nested=True is mutually exclusive with chunks > 1 (no full-n "
                         "ladder exists to chunk)")
    return bool(nested) and num_l > 0


def chain_lm_start(values0, chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info,
                   fixed_mask, *, residual_fn: Callable, retract_fn: Callable, tdim: int,
                   gradient_tolerance: float = 1e-10, step_tolerance: float = 1e-10,
                   cost_tolerance: float = 1e-12, initial_damping: float = 1e-3,
                   refine: int = 0, woodbury_chunk_bytes: int | None = None, chunks: int = 0,
                   rdim: int | None = None, nested: bool | None = None):
    """The chain LM's first state and its step, for values0 [G, n, dim]
    (arguments as `solve_chain_lm`). Returns (LMState, step): step(state)
    is one LM iteration of every graph and reads nothing back."""
    chunked = bool(chunks and chunks > 1)
    n = values0.shape[-2]
    part = None
    if _use_nested(n, loop_from, loop_to, nested, chunked):
        part = nested_partition(n, loop_from, loop_to, device=values0.device)
    if chunked:
        raise NotImplementedError(
            "chunks > 1 (the SPIKE-chunked ladder) is not ported; ROADMAP.md A10 leaves it "
            "out: the plain ladder serves every n on the GPU")
    linearize, lin_solve, apply_step, cost_only = _chain_lm_ops(
        chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info, fixed_mask,
        residual_fn=residual_fn, retract_fn=retract_fn, tdim=tdim, refine=refine,
        woodbury_chunk_bytes=woodbury_chunk_bytes, rdim=rdim, nested_part=part)
    with full_fp32_matmul():
        state = lm_state(values0, cost_only(values0), initial_damping)
    return state, lm_step(linearize, lin_solve, apply_step, cost_only, gradient_tolerance,
                          step_tolerance, cost_tolerance)


def solve_chain_lm(values0, chain_meas, chain_info, loop_from, loop_to, loop_meas, loop_info,
                   fixed_mask, *, residual_fn: Callable, retract_fn: Callable, tdim: int,
                   max_iterations: int = 50, gradient_tolerance: float = 1e-10,
                   step_tolerance: float = 1e-10, cost_tolerance: float = 1e-12,
                   initial_damping: float = 1e-3, refine: int = 0,
                   woodbury_chunk_bytes: int | None = None, chunks: int = 0,
                   rdim: int | None = None, nested: bool | None = None):
    """LM over a chain factor graph with loop closures, on the device of
    `values0`.

    values0:    [n, dim] node values, or [G, n, dim] for G graphs solved in
                lock-step that share every other argument
    chain_meas: [n-1, rdim] measurement of edge (i, i+1)
    chain_info: [n-1, rdim, rdim] information (or None: identity)
    loop_*:     [L] / [L, rdim] / [L, rdim, rdim] extra edges (L may be 0),
                endpoints as int64 tensors on the same device
    fixed_mask: [n] bool: fixed nodes take no increment

    residual_fn(xi, xj, meas) -> [rdim]; retract_fn(x, delta[tdim]) -> x'.
    woodbury_chunk_bytes: per-chunk budget of the streamed loop-closure
    columns (default `WOODBURY_CHUNK_BYTES`). chunks > 1 raises
    NotImplementedError (the SPIKE-chunked ladder is not ported). rdim: the
    residual dimension where it differs from the measurement width.
    nested: route the inner solve through `chain_nested_solve`; None
    engages it for n >= 50 000, >= 64 closures and a separator set <= n/8
    (the JAX package's rule). `refine` does not apply to the nested path.

    Returns (values, ChainSummary of device tensors), each with the
    leading G axis if values0 had one. Counts its calls on
    `solve_chain_lm.calls`."""
    solve_chain_lm.calls += 1
    batched = values0.ndim == 3
    state, step = chain_lm_start(
        values0 if batched else values0[None], chain_meas, chain_info, loop_from, loop_to,
        loop_meas, loop_info, fixed_mask, residual_fn=residual_fn, retract_fn=retract_fn,
        tdim=tdim, gradient_tolerance=gradient_tolerance, step_tolerance=step_tolerance,
        cost_tolerance=cost_tolerance, initial_damping=initial_damping, refine=refine,
        woodbury_chunk_bytes=woodbury_chunk_bytes, chunks=chunks, rdim=rdim, nested=nested)
    return finish(state, lm_run(state, step, max_iterations), batched)


solve_chain_lm.calls = 0


def finish(first: LMState, last: LMState, batched: bool):
    """(values, ChainSummary) of a run, without the G axis unless batched."""
    out = (last.values, ChainSummary(first.cost, last.cost, last.it, last.accepted, last.term))
    if batched:
        return out
    return out[0][0], ChainSummary(*(x[0] for x in out[1]))


def chain_edge_partition(n, edges_from, edges_to):
    """The (first_idx [n-1], is_chain [E]) partition behind
    classify_chain_edges: the first (i, i+1) edge of each consecutive pair
    is the tridiagonal entry, every other edge a loop edge. Raises when a
    consecutive pair has no edge."""
    ef = _host(edges_from)
    et = _host(edges_to)
    first_idx = np.full(n - 1, -1, dtype=np.int64)
    for e in np.nonzero(et == ef + 1)[0]:
        if first_idx[ef[e]] < 0:
            first_idx[ef[e]] = e
    if np.any(first_idx < 0):
        raise ValueError("chain_direct requires at least one (i, i+1) edge per consecutive pair")
    is_chain = np.zeros(len(ef), dtype=bool)
    is_chain[first_idx] = True
    return first_idx, is_chain


def has_full_chain(n, edges_from, edges_to):
    """True when every consecutive (i, i+1) pair has an edge: the 'direct'
    routing predicate (chain_direct against banded_direct)."""
    ef = _host(edges_from)
    et = _host(edges_to)
    consec = np.zeros(max(n - 1, 0), bool)
    mask = et == ef + 1
    consec[ef[mask]] = True
    return bool(consec.all())


def classify_chain_edges(n, edges_from, edges_to, measurements, information=None):
    """Split an edge list into the chain part (i -> i+1, in order) and the
    loop-closure remainder, on the host (numpy). Returns (chain_meas
    [n-1, rdim], chain_info or None, loop_from, loop_to, loop_meas,
    loop_info or None). Every (i, i+1) pair needs an edge; extra parallel
    (i, i+1) edges join the loop closures on the low-rank side."""
    ef = _host(edges_from)
    et = _host(edges_to)
    meas = _host(measurements)
    info = None if information is None else _host(information)
    first_idx, is_chain = chain_edge_partition(n, ef, et)
    loop = ~is_chain
    return (meas[first_idx], None if info is None else info[first_idx], ef[loop], et[loop],
            meas[loop], None if info is None else info[loop])
