"""Lie-group operations: SO(2), SE(2), SO(3), SE(3).

The port of rust_robotics_tpu/core/lie.py, with its names and conventions
(reference surface: crates/rust_robotics_core/src/lie.rs). Every function
is plain tensor arithmetic over the trailing axes, batched over any leading
dims, and works under `torch.func.vmap` and `torch.func.jacfwd`: no Python
branch on a value, no `.item()`, no in-place write. Small-angle branches
keep the "double-where" pattern, so that both the value and the derivative
are NaN-free at theta == 0: `torch.where` passes NaN derivatives from the
branch it does not take exactly as `jnp.where` does. Constants are built
on the input's device and dtype.

Conventions match the reference:
- SE(2) tangent is [vx, vy, omega]; SE(3) tangent is [rho(3), phi(3)]
  (translation first, rotation last).
- exp uses the left Jacobian: t = V(phi) @ rho.
"""

from __future__ import annotations

import math

import torch

from rust_robotics_tpu_torch._numeric import true_div

_EPS = 1e-8
_COS_NEAR_PI = math.cos(math.pi - 1e-4)


def _safe_div(num, den, fallback, eps=_EPS):
    """num/den where |den| > eps, else fallback — NaN-free in the derivative too."""
    small = torch.abs(den) < eps
    safe_den = torch.where(small, torch.ones_like(den), den)
    return torch.where(small, fallback, num / safe_den)


def _safe_theta(theta2, eps2=1e-12):
    """(small, theta) with theta = sqrt(theta2) guarded so that sqrt never
    sees 0 on the differentiated path (double-where). Use `small` to select
    the Taylor branch computed directly from theta2."""
    small = theta2 < eps2
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return small, theta


def _eye_like(x, n, shape):
    """The n x n identity on x's device and dtype, broadcast to `shape`."""
    return torch.eye(n, dtype=x.dtype, device=x.device).expand(shape)


def _last_row(top):
    """The homogeneous row [0, ..., 0, 1] under `top` [..., n-1, n], on its
    device and dtype. Built on the device: a row made from a host list is a
    copy to the device, which synchronises, once per call of the Lie
    functions inside a solver step."""
    n = top.shape[-1]
    return torch.eye(n, dtype=top.dtype, device=top.device)[n - 1:].expand(top[..., :1, :].shape)


# ---------------------------------------------------------------------------
# SO(2)
# ---------------------------------------------------------------------------

def so2_exp(theta):
    """Angle [...,] -> rotation matrix [..., 2, 2]. `lie.rs:37`."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def so2_log(rot):
    """Rotation matrix [..., 2, 2] -> angle. `lie.rs:43`."""
    return torch.atan2(rot[..., 1, 0], rot[..., 0, 0])


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def skew(v):
    """[..., 3] -> [..., 3, 3] cross-product matrix. `lie.rs:25`."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([z, -w, y], dim=-1),
            torch.stack([w, z, -x], dim=-1),
            torch.stack([-y, x, z], dim=-1),
        ],
        dim=-2,
    )


def unskew(m):
    """[..., 3, 3] -> [..., 3]. `lie.rs:32`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(phi):
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]. `lie.rs:48`."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small, theta = _safe_theta(theta2)
    k = skew(phi)
    k2 = k @ k
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks at t ~ 0
    a = torch.where(small, 1.0 - true_div(theta2, 6.0), torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - true_div(theta2, 24.0), (1.0 - torch.cos(theta)) / (theta * theta))
    return _eye_like(phi, 3, k.shape) + a[..., None, None] * k + b[..., None, None] * k2


def so3_log(rot):
    """Rotation [..., 3, 3] -> axis-angle [..., 3]. `lie.rs:57`.

    Derivative-safe at the identity: theta comes from atan2(|antisym|/2,
    cos) with a Taylor branch for tiny angles (the arccos form's derivative
    is infinite at 1, exactly where Gauss-Newton residuals reach zero).
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part = 2 sin(theta) * axis
    w = unskew(rot - rot.transpose(-1, -2))
    s2 = 0.25 * torch.sum(w * w, dim=-1)  # sin²(theta)
    small = (s2 < 1e-14) & (cos_theta > 0.0)
    # safe sin: 1 on the small branch so sqrt/atan2/divide all stay
    # differentiable; those lanes take the Taylor scale anyway (and w ≈ 0)
    sin_theta = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_theta, cos_theta)
    scale = torch.where(small, 0.5 + true_div(s2, 12.0), theta / (2.0 * sin_theta))
    near_pi = cos_theta < _COS_NEAR_PI
    # Near pi the antisymmetric part vanishes; recover the axis from the
    # diagonal of the symmetric part.
    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / torch.clamp(1.0 - cos_theta[..., None], min=1e-12),
        min=0.0,
    )
    # double-where: off the near-pi lanes feed sqrt a 1 so its derivative
    # stays finite (sqrt'(0) = inf would leak NaN through the final where)
    axis_sq = torch.where(near_pi[..., None], axis_sq, torch.ones_like(axis_sq))
    axis = torch.sqrt(axis_sq)
    # fix signs from off-diagonal sums (symmetric part signs)
    s12 = rot[..., 0, 1] + rot[..., 1, 0]
    s13 = rot[..., 0, 2] + rot[..., 2, 0]
    s23 = rot[..., 1, 2] + rot[..., 2, 1]
    sx = axis[..., 0]
    sy = torch.where(s12 >= 0, axis[..., 1], -axis[..., 1])
    sz = torch.where(s13 >= 0, axis[..., 2], -axis[..., 2])
    # resolve sy/sz consistency via s23
    one = torch.ones_like(s12)
    flip = (torch.where(s12 >= 0, one, -one) * torch.where(s13 >= 0, one, -one) * s23) < 0
    sz = torch.where(flip, -sz, sz)
    axis_pi = torch.stack([sx, sy, sz], dim=-1)
    phi_pi = axis_pi * theta[..., None]
    phi_generic = w * scale[..., None]
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def so3_left_jacobian(phi):
    """Left Jacobian J_l(phi) [..., 3, 3]. `lie.rs:74`."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small, theta = _safe_theta(theta2)
    k = skew(phi)
    k2 = k @ k
    b = torch.where(small, 0.5 - true_div(theta2, 24.0), (1.0 - torch.cos(theta)) / (theta * theta))
    c = torch.where(
        small,
        1.0 / 6.0 - true_div(theta2, 120.0),
        (theta - torch.sin(theta)) / (theta * theta * theta),
    )
    return _eye_like(phi, 3, k.shape) + b[..., None, None] * k + c[..., None, None] * k2


def so3_left_jacobian_inverse(phi):
    """J_l^{-1}(phi) = I - K/2 + coeff * K², coeff = 1/t² − (1+cos t)/(2 t sin t).
    `lie.rs:83`."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small, theta = _safe_theta(theta2, eps2=1e-8)
    k = skew(phi)
    k2 = k @ k
    coeff = torch.where(
        small,
        1.0 / 12.0 + true_div(theta2, 720.0),
        1.0 / (theta * theta) - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta)),
    )
    return _eye_like(phi, 3, k.shape) - 0.5 * k + coeff[..., None, None] * k2


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------

def se2_exp(xi):
    """Tangent [vx, vy, omega] [..., 3] -> homogeneous [..., 3, 3]. `lie.rs:97`."""
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    s, c = torch.sin(w), torch.cos(w)
    # V = [[sin w / w, -(1-cos w)/w], [(1-cos w)/w, sin w / w]]
    a = _safe_div(s, w, 1.0 - true_div(w * w, 6.0))
    b = _safe_div(1.0 - c, w, w / 2.0 - true_div(w**3, 24.0))
    tx = a * vx - b * vy
    ty = b * vx + a * vy
    z = torch.zeros_like(w)
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([c, -s, tx], dim=-1),
            torch.stack([s, c, ty], dim=-1),
            torch.stack([z, z, one], dim=-1),
        ],
        dim=-2,
    )


def se2_log(m):
    """Homogeneous [..., 3, 3] -> tangent [vx, vy, omega]. `lie.rs:~120`."""
    w = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    s, c = torch.sin(w), torch.cos(w)
    a = _safe_div(s, w, 1.0 - true_div(w * w, 6.0))
    b = _safe_div(1.0 - c, w, w / 2.0 - true_div(w**3, 24.0))
    det = a * a + b * b
    inv_det = _safe_div(torch.ones_like(det), det, torch.ones_like(det), eps=1e-12)
    vx = inv_det * (a * tx + b * ty)
    vy = inv_det * (-b * tx + a * ty)
    return torch.stack([vx, vy, w], dim=-1)


def se2_inverse(m):
    """Inverse of homogeneous SE(2) matrix. `lie.rs:~135`."""
    rot_t = m[..., :2, :2].transpose(-1, -2)
    t = m[..., :2, 2:]
    top = torch.cat([rot_t, -rot_t @ t], dim=-1)
    return torch.cat([top, _last_row(top)], dim=-2)


def se2_adjoint(m):
    """Adjoint [..., 3, 3] of SE(2): [[R, [ty; -tx]], [0, 1]]. `lie.rs:146`."""
    r = m[..., :2, :2]
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    col = torch.stack([ty, -tx], dim=-1)[..., :, None]
    top = torch.cat([r, col], dim=-1)
    return torch.cat([top, _last_row(top)], dim=-2)


def se2_from_pose(x, y, yaw):
    """Build homogeneous SE(2) from pose components (batched)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(x)
    one = torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([c, -s, x], dim=-1),
            torch.stack([s, c, y], dim=-1),
            torch.stack([z, z, one], dim=-1),
        ],
        dim=-2,
    )


def se2_to_pose(m):
    """Homogeneous SE(2) -> (x, y, yaw)."""
    return m[..., 0, 2], m[..., 1, 2], torch.atan2(m[..., 1, 0], m[..., 0, 0])


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_exp(xi):
    """Tangent [rho(3), phi(3)] [..., 6] -> homogeneous [..., 4, 4]. `lie.rs:164`."""
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    top = torch.cat([rot, t[..., None]], dim=-1)
    return torch.cat([top, _last_row(top)], dim=-2)


def se3_log(m):
    """Homogeneous [..., 4, 4] -> tangent [rho, phi]. `lie.rs:~185`."""
    phi = so3_log(m[..., :3, :3])
    rho = (so3_left_jacobian_inverse(phi) @ m[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(m):
    """Inverse of homogeneous SE(3). `lie.rs:~205`."""
    rot_t = m[..., :3, :3].transpose(-1, -2)
    t = m[..., :3, 3:]
    top = torch.cat([rot_t, -rot_t @ t], dim=-1)
    return torch.cat([top, _last_row(top)], dim=-2)


def se3_adjoint(m):
    """Adjoint [..., 6, 6]: [[R, skew(t) R], [0, R]]. `lie.rs:228`."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    tr = skew(t) @ r
    zeros = torch.zeros_like(r)
    top = torch.cat([r, tr], dim=-1)
    bottom = torch.cat([zeros, r], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Deviation-space (near-identity) SE(3) calculus
# ---------------------------------------------------------------------------
# Working with E = T − I instead of T keeps RELATIVE precision for
# near-identity transforms: a homogeneous matrix stores 1 + x with absolute
# rounding eps, while the deviation E stores x itself. The anchored SE(3)
# solver composes edge residuals entirely in E-space, so the f32
# residual-evaluation noise scales down with the residual. Series are plain
# polynomials: differentiable, branch-free, vmap-friendly.

def se3_hat(xi):
    """Tangent [..., 6] -> se(3) algebra matrix [..., 4, 4]
    [[skew(phi), rho], [0, 0]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    k = skew(phi)
    top = torch.cat([k, rho[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    return torch.cat([top, bottom], dim=-2)


def _products(a, b):
    """a @ b ([..., m, k] @ [..., k, n], k small) as k products and k − 1
    adds in order, each rounded on its own: the same bits on the CPU and on
    CUDA, where a matmul's summation order and fused multiply-adds are the
    library's."""
    out = a[..., :, :1] * b[..., :1, :]
    for i in range(1, a.shape[-1]):
        out = out + a[..., :, i:i + 1] * b[..., i:i + 1, :]
    return out


def se3_expm1(xi, terms: int = 10):
    """E = exp(hat(xi)) − I via the Horner-evaluated series
    X·(I + X/2·(I + X/3·(…))). Exact to f32 for |xi| ≲ 0.3 at the default
    term count. The same bits on the CPU and on CUDA (`_products`, and a
    true division where JAX divides)."""
    x = se3_hat(xi)
    eye = _eye_like(xi, 4, x.shape)
    s = eye
    for k in range(terms, 1, -1):
        s = eye + true_div(_products(x, s), k)
    return _products(x, s)


def se3_compose_dev(e1, e2):
    """Deviation of the product: (I+E1)(I+E2) − I = E1 + E2 + E1·E2 — no
    near-identity cancellation, absolute accuracy ~eps·|E|."""
    return e1 + e2 + e1 @ e2


def se3_logm1(e, terms: int = 10):
    """Tangent of I+E via the matrix-log series Σ (−1)^{k+1} E^k / k. phi is
    read from the antisymmetrized rotation block, rho from the translation
    column. Valid for ||E|| < 1."""
    l = e  # noqa: E741
    p = e
    sign = 1.0
    for k in range(2, terms + 1):
        p = p @ e
        sign = -sign
        l = l + (sign / k) * p  # noqa: E741
    phi = 0.5 * torch.stack([
        l[..., 2, 1] - l[..., 1, 2],
        l[..., 0, 2] - l[..., 2, 0],
        l[..., 1, 0] - l[..., 0, 1],
    ], dim=-1)
    rho = l[..., :3, 3]
    return torch.cat([rho, phi], dim=-1)
