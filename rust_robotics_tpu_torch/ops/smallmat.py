"""Closed-form batched small-matrix algebra (n ≤ 4).

The filter hot path works on 2×2 innovation and 4×4 state covariances. Every
op here is explicit elementwise arithmetic over the trailing [n, n] dims,
batched over any leading dims, as the reference hand-unrolls its 4×4/2×2
Cholesky (square_root_ukf.rs:114-407 `cholesky_lower_4/2`). The closed forms
are the semantics the filters are held to; beyond n = 4 the generic
`torch.linalg` routines take over.

SPD structure is assumed where the name says so (covariances/innovation
matrices are SPD by construction). `householder_r` is the R of a tall
matrix's QR, by reflections elementwise over the batch (the SR-UKF's
square-root factor; triangulation's least squares).
"""

from __future__ import annotations

import torch


def _dim(m):
    n = m.shape[-1]
    if m.shape[-2] != n:
        raise ValueError(f"expected square trailing dims, got {tuple(m.shape)}")
    return n


def det_small(m):
    """Determinant, closed form for n ≤ 3; LU beyond."""
    n = _dim(m)
    if n == 1:
        return m[..., 0, 0]
    if n == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if n == 3:
        a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return torch.linalg.det(m)


def inv_spd_small(m):
    """Inverse of a symmetric positive-definite matrix, n ≤ 4 closed form
    (block inversion for n=4), generic beyond."""
    n = _dim(m)
    if n == 1:
        return 1.0 / m
    if n == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, d = m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return inv_det[..., None, None] * torch.stack([row0, row1], dim=-2)
    if n == 3:
        # adjugate / det
        a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        co00 = e * i - f * h
        co01 = c * h - b * i
        co02 = b * f - c * e
        co10 = f * g - d * i
        co11 = a * i - c * g
        co12 = c * d - a * f
        co20 = d * h - e * g
        co21 = b * g - a * h
        co22 = a * e - b * d
        det = a * co00 + b * co10 + c * co20
        adj = torch.stack(
            [
                torch.stack([co00, co01, co02], dim=-1),
                torch.stack([co10, co11, co12], dim=-1),
                torch.stack([co20, co21, co22], dim=-1),
            ],
            dim=-2,
        )
        return adj / det[..., None, None]
    if n == 4:
        # SPD block inversion: M = [[A, B], [Bᵀ, C]], S = C − Bᵀ A⁻¹ B
        a = m[..., :2, :2]
        b = m[..., :2, 2:]
        c = m[..., 2:, 2:]
        a_inv = inv_spd_small(a)
        ainv_b = a_inv @ b
        s = c - b.mT @ ainv_b
        s_inv = inv_spd_small(s)
        tl = a_inv + ainv_b @ s_inv @ ainv_b.mT
        tr = -ainv_b @ s_inv
        bl = tr.mT
        top = torch.cat([tl, tr], dim=-1)
        bottom = torch.cat([bl, s_inv], dim=-1)
        return torch.cat([top, bottom], dim=-2)
    return torch.linalg.inv(m)


def solve_spd_small(s, b):
    """Solve s @ x = b for SPD s (n ≤ 4 closed form)."""
    n = _dim(s)
    if n <= 4:
        return inv_spd_small(s) @ b
    return torch.linalg.solve(s, b)


def cholesky_small(m):
    """Lower Cholesky factor, unrolled for n ≤ 4 (the reference's manual
    cholesky_lower_4/2, square_root_ukf.rs:114-407). A non-positive pivot is
    clipped to the dtype's smallest normal number."""
    n = _dim(m)
    if n > 4:
        return torch.linalg.cholesky(m)
    tiny = torch.finfo(m.dtype).tiny
    rows = [[None] * n for _ in range(n)]
    zero = torch.zeros_like(m[..., 0, 0])
    for j in range(n):
        s = m[..., j, j]
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        ljj = torch.sqrt(torch.clamp(s, min=tiny))
        rows[j][j] = ljj
        for i in range(j + 1, n):
            s = m[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            rows[i][j] = s / ljj
    full = [
        torch.stack([rows[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)
    ]
    return torch.stack(full, dim=-2)


def householder_r(a):
    """The upper-triangular R [..., n, n] of a = QR for a [..., m, n],
    m ≥ n, by Householder reflections (LAPACK's geqrf), each one
    elementwise over the batch. Rows of R may differ in sign from another
    QR's; RᵀR does not."""
    n = a.shape[-1]
    a = a.clone()
    for j in range(n):
        x = a[..., j:, j]
        alpha = x[..., 0]
        sigma = torch.sum(x[..., 1:] * x[..., 1:], dim=-1)
        norm = torch.sqrt(alpha * alpha + sigma)
        # beta = -sign(alpha)·|x|, so that v = x - beta·e1 does not cancel
        beta = torch.where(alpha >= 0, -norm, norm)
        v = torch.cat([(alpha - beta)[..., None], x[..., 1:]], dim=-1)
        vv = torch.sum(v * v, dim=-1)
        live = vv > 0
        tau = torch.where(live, 2.0 / torch.where(live, vv, torch.ones_like(vv)),
                          torch.zeros_like(vv))
        block = a[..., j:, j:]
        proj = torch.sum(v[..., :, None] * block, dim=-2)  # vᵀ A [..., n - j]
        a[..., j:, j:] = block - (tau[..., None] * proj)[..., None, :] * v[..., :, None]
    return torch.triu(a[..., :n, :])
