"""Temporally parallel Kalman filtering and RTS smoothing (an associative
scan over the time axis).

The port of rust_robotics_tpu/filters/smoother.py (Särkkä &
García-Fernández, "Temporal Parallelization of Bayesian Smoothers", IEEE
TAC 2021): Kalman filtering and smoothing are associative operations, so a
length-T sequence runs in O(log T) levels of batched combines.

The affine-Gaussian system is x_k = F_k x_{k−1} + c_k + w_k,
z_k = H x_k + v_k (the drift c_k carries EKF linearisation offsets, so the
extended smoother reuses the same elements). Filtering elements
(A, b, C, η, J) compose forward; smoothing elements (E, g, L) compose in
reverse. `sequential_*` are the textbook loops, the golden references.

Shapes are the JAX functions' with the time axis where JAX has it (fs
[..., T, n, n], zs [..., T, m], m0 [..., n]) and optional leading batch
dims in front of it. The scan is this module's own `associative_scan`, in
plain torch: it follows JAX's odd/even recursion
(`jax/_src/lax/control_flow/loops.py::associative_scan`), so that the order
in which elements combine, and with it the rounding, is JAX's.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters.kalman import ekf_step
from rust_robotics_tpu_torch.models.motion import unicycle_jacobian, unicycle_propagate

__all__ = [
    "associative_scan",
    "parallel_kalman_filter",
    "parallel_rts_smoother",
    "sequential_kalman_filter",
    "sequential_rts_smoother",
    "ekf_smooth_unicycle",
]


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along dim 0; len(even) is len(odd) or one
    more."""
    out = even.new_empty((even.shape[0] + odd.shape[0], *even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn, elems, reverse=False):
    """Inclusive scan of `fn` over dim 0 of every tensor of the tuple
    `elems`: [a, fn(a, b), fn(fn(a, b), c), ...]. `fn` takes and returns
    tuples of tensors and combines elementwise over dim 0 (and any dims
    after it). With reverse=True the scan runs from the end, and `fn`
    receives (later, earlier): the result is [..., fn(fn(z, y), x),
    fn(z, y), z], as `jax.lax.associative_scan(reverse=True)` gives it.

    JAX's recursion: combine adjacent pairs, scan the half-length sequence
    (the odd outputs), then combine each odd output with the next even
    input (the even outputs). O(log T) levels of batched combines."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        reduced = fn(tuple(x[0:n - 1:2] for x in xs), tuple(x[1::2] for x in xs))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            even = fn(tuple(o[:-1] for o in odd), tuple(x[2::2] for x in xs))
        else:
            even = fn(tuple(odd), tuple(x[2::2] for x in xs))
        even = tuple(torch.cat([x[:1], e], 0) for x, e in zip(xs, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(o, (0,)) for o in out)
    return out


def _solve(a, b):
    """a⁻¹ b for a matrix b [..., n, k], by LU with partial pivoting as
    `jnp.linalg.solve`; `solve_ex` checks nothing, so nothing is read back
    (a singular system gives non-finite values, as in JAX)."""
    return torch.linalg.solve_ex(a, b).result


def _solve_vec(a, b):
    """a⁻¹ b for a vector b [..., n]."""
    return _solve(a, b[..., None])[..., 0]


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


def _to_time_first(mats=(), vecs=()):
    """Time axes to dim 0: matrices [..., T, n, n], vectors [..., T, m]."""
    return (tuple(m.movedim(-3, 0) for m in mats), tuple(v.movedim(-2, 0) for v in vecs))


def _default_cs(fs, cs):
    return fs.new_zeros(fs.shape[:-1]) if cs is None else cs


def _filter_elements(fs, qs, h, r, zs, cs, m0, p0):
    """Per-step associative filtering elements of the affine system, time
    first: fs [T, ..., n, n], zs [T, ..., m], cs [T, ..., n]."""
    n = fs.shape[-1]
    eye = torch.eye(n, dtype=fs.dtype, device=fs.device)
    s = h @ qs @ h.mT + r
    k = _solve(s, h @ qs).mT  # Q Hᵀ S⁻¹
    ikh = eye - k @ h
    a = ikh @ fs
    b = _mv(ikh, cs) + _mv(k, zs)
    c = ikh @ qs
    hf = h @ fs
    resid = zs - _mv(h, cs)
    eta = _mv(hf.mT, _solve_vec(s, resid))
    jj = hf.mT @ _solve(s, hf)

    # the first element conditions on the prior (m0, P0) directly
    f0, q0, z0, c0v = fs[0], qs[0], zs[0], cs[0]
    m_pred = _mv(f0, m0) + c0v
    p_pred = f0 @ p0 @ f0.mT + q0
    s0 = h @ p_pred @ h.mT + r
    k0 = _solve(s0, h @ p_pred).mT
    b0 = m_pred + _mv(k0, z0 - _mv(h, m_pred))
    c0 = (eye - k0 @ h) @ p_pred
    lead = a.shape[1:]
    a = torch.cat([a.new_zeros((1, *lead)), a[1:]])
    b = torch.cat([b0.expand(b.shape[1:])[None], b[1:]])
    c = torch.cat([c0.expand(c.shape[1:])[None], c[1:]])
    eta = torch.cat([eta.new_zeros((1, *eta.shape[1:])), eta[1:]])
    jj = torch.cat([jj.new_zeros((1, *jj.shape[1:])), jj[1:]])
    return a, b, c, eta, jj


def _filter_combine(e1, e2):
    """(A, b, C, η, J): e1 earlier, e2 later (Särkkä & G-F, Lemma 1)."""
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    n = a1.shape[-1]
    eye = torch.eye(n, dtype=a1.dtype, device=a1.device)
    m = eye + c1 @ j2
    mt = eye + j2 @ c1
    a = a2 @ _solve(m, a1)
    b = _mv(a2, _solve_vec(m, b1 + _mv(c1, eta2))) + b2
    c = a2 @ _solve(m, c1) @ a2.mT + c2
    eta = _mv(a1.mT, _solve_vec(mt, eta2 - _mv(j2, b1))) + eta1
    j = a1.mT @ _solve(mt, j2 @ a1) + j1
    return a, b, c, eta, j


def _parallel_filter_tf(fs, qs, h, r, zs, cs, m0, p0):
    elems = _filter_elements(fs, qs, h, r, zs, cs, m0, p0)
    _, b, c, _, _ = associative_scan(_filter_combine, elems)
    return b, c


def parallel_kalman_filter(fs, qs, h, r, zs, m0, p0, cs=None):
    """Filtered means/covs [..., T, n] / [..., T, n, n] in O(log T) scan
    depth."""
    cs = _default_cs(fs, cs)
    (fs_t, qs_t), (zs_t, cs_t) = _to_time_first((fs, qs), (zs, cs))
    b, c = _parallel_filter_tf(fs_t, qs_t, h, r, zs_t, cs_t, m0, p0)
    return b.movedim(0, -2), c.movedim(0, -3)


def sequential_kalman_filter(fs, qs, h, r, zs, m0, p0, cs=None):
    """The textbook sequential KF, the golden reference for the scan."""
    cs = _default_cs(fs, cs)
    n = m0.shape[-1]
    eye = torch.eye(n, dtype=p0.dtype, device=p0.device)
    m, p = m0, p0
    ms, ps = [], []
    for t in range(fs.shape[-3]):
        f, q, z, c = fs[..., t, :, :], qs[..., t, :, :], zs[..., t, :], cs[..., t, :]
        m_pred = _mv(f, m) + c
        p_pred = f @ p @ f.mT + q
        s = h @ p_pred @ h.mT + r
        k = _solve(s, h @ p_pred).mT
        m = m_pred + _mv(k, z - _mv(h, m_pred))
        p = (eye - k @ h) @ p_pred
        ms.append(m)
        ps.append(p)
    return torch.stack(ms, -2), torch.stack(ps, -3)


def _smoother_elements(fs, qs, cs, ms, ps):
    """Smoothing elements (E, g, L), time first: element k maps the
    smoothed state at k+1 to the smoothed state at k."""
    f_next, q_next, c_next, m, p = fs[1:], qs[1:], cs[1:], ms[:-1], ps[:-1]
    p_pred = f_next @ p @ f_next.mT + q_next
    g = _solve(p_pred, f_next @ p).mT  # P Fᵀ (P⁻)⁻¹
    gvec = m - _mv(g, _mv(f_next, m) + c_next)
    ll = p - g @ p_pred @ g.mT
    # the last element: the filtered posterior at T
    e = torch.cat([g, g.new_zeros((1, *g.shape[1:]))])
    gvec = torch.cat([gvec, ms[-1:]])
    ll = torch.cat([ll, ps[-1:]])
    return e, gvec, ll


def _smoother_combine(e1, e2):
    """e1 earlier (closer to t = 0), e2 later; composes right to left."""
    ee1, g1, l1 = e1
    ee2, g2, l2 = e2
    return ee1 @ ee2, _mv(ee1, g2) + g1, ee1 @ l2 @ ee1.mT + l1


def parallel_rts_smoother(fs, qs, h, r, zs, m0, p0, cs=None):
    """Smoothed means/covs by two associative scans (the filter forward,
    the smoother backward), O(log T) depth in all. Returns
    (smoothed_means, smoothed_covs, filtered_means, filtered_covs)."""
    cs = _default_cs(fs, cs)
    (fs_t, qs_t), (zs_t, cs_t) = _to_time_first((fs, qs), (zs, cs))
    ms, ps = _parallel_filter_tf(fs_t, qs_t, h, r, zs_t, cs_t, m0, p0)
    elems = _smoother_elements(fs_t, qs_t, cs_t, ms, ps)
    # reverse=True feeds the combine (later, earlier): swap into time order
    _, g, ll = associative_scan(lambda a, b: _smoother_combine(b, a), elems, reverse=True)
    return g.movedim(0, -2), ll.movedim(0, -3), ms.movedim(0, -2), ps.movedim(0, -3)


def sequential_rts_smoother(fs, qs, h, r, zs, m0, p0, cs=None):
    """The textbook RTS backward pass, the golden reference."""
    cs = _default_cs(fs, cs)
    ms, ps = sequential_kalman_filter(fs, qs, h, r, zs, m0, p0, cs)
    t_len = fs.shape[-3]
    m_s, p_s = ms[..., -1, :], ps[..., -1, :, :]
    out_m, out_p = [m_s], [p_s]
    for t in range(t_len - 2, -1, -1):
        f_next, q_next, c_next = fs[..., t + 1, :, :], qs[..., t + 1, :, :], cs[..., t + 1, :]
        m, p = ms[..., t, :], ps[..., t, :, :]
        p_pred = f_next @ p @ f_next.mT + q_next
        g = _solve(p_pred, f_next @ p).mT
        m_s = m + _mv(g, m_s - (_mv(f_next, m) + c_next))
        p_s = p + g @ (p_s - p_pred) @ g.mT
        out_m.append(m_s)
        out_p.append(p_s)
    return torch.stack(out_m[::-1], -2), torch.stack(out_p[::-1], -3), ms, ps


def _ekf_affine_system(zs, us, dt, q, r, m0, p0):
    """The affine system of the extended smoother: run the EKF (a host
    loop over T, nothing read back), linearise the motion along the
    filtered trajectory (F_t at the filtered point, drift
    c_t = f(x̂) − F_t x̂). Returns (fs, qs, h, cs)."""
    belief = GaussianBelief(m0, p0)
    means = []
    for t in range(zs.shape[-2]):
        belief = ekf_step(belief, zs[..., t, :], us[..., t, :], dt, q, r)
        means.append(belief.mean)
    means = torch.stack(means, -2)
    lead = torch.broadcast_shapes(m0.shape[:-1], means.shape[:-2])
    lin_pts = torch.cat([m0.expand(*lead, m0.shape[-1])[..., None, :], means[..., :-1, :]], -2)
    fs = unicycle_jacobian(unicycle_propagate(lin_pts, us, dt), us, dt)
    cs = unicycle_propagate(lin_pts, us, dt) - _mv(fs, lin_pts)
    h = torch.eye(2, 4, dtype=zs.dtype, device=zs.device)  # observe x, y
    return fs, torch.broadcast_to(q, fs.shape), h, cs


def ekf_smooth_unicycle(zs, us, dt, q, r, m0, p0):
    """Extended smoothing for the reference's shared unicycle problem: the
    EKF's linearisation (`_ekf_affine_system`), then the parallel affine
    smoother, O(log T) deep. zs [..., T, 2], us [..., T, 2]. Returns a
    dict of smoothed and filtered means and covariances."""
    fs, qs, h, cs = _ekf_affine_system(zs, us, dt, q, r, m0, p0)
    g, ll, ms, ps = parallel_rts_smoother(fs, qs, h, r, zs, m0, p0, cs)
    return {"smoothed_means": g, "smoothed_covs": ll, "filtered_means": ms,
            "filtered_covs": ps}
