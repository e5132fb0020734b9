"""Host-side (NumPy, float64) SE(3) Lie operations for anchor precomputation.

The port's own copy of rust_robotics_tpu/core/lie_np.py (numpy only). An
f32 device path loses the global-coordinate composition X_i⁻¹X_j of a
large-workspace SE(3) graph to cancellation. The anchored solver
(slam/pose_graph.py::optimize_pose_graph_3d(anchored=True)) therefore
re-centres every edge around anchors: the large-coordinate arithmetic
happens once HERE, in f64 on the host, and the device composes only small
local transforms.

Conventions are core/lie.py's (tangent = [rho, phi], left-Jacobian
translation coupling; reference lie.rs:164-228), over leading axes. Plain
angles only: nothing differentiates through these.
"""

from __future__ import annotations

import numpy as np

_EPS2 = 1e-14


def skew(phi):
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    o = np.zeros_like(x)
    return np.stack([
        np.stack([o, -z, y], -1),
        np.stack([z, o, -x], -1),
        np.stack([-y, x, o], -1),
    ], -2)


def _abc(theta2):
    """sin t/t, (1-cos t)/t², (t-sin t)/t³ with Taylor fallbacks."""
    small = theta2 < _EPS2
    t2 = np.where(small, 1.0, theta2)  # protected denominator
    theta = np.sqrt(t2)
    a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    b = np.where(small, 0.5 - theta2 / 24.0, (1.0 - np.cos(theta)) / t2)
    c = np.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - np.sin(theta)) / (t2 * theta))
    return a, b, c


def so3_exp(phi):
    theta2 = np.sum(phi * phi, -1)
    a, b, _ = _abc(theta2)
    k = skew(phi)
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_left_jacobian(phi):
    theta2 = np.sum(phi * phi, -1)
    _, b, c = _abc(theta2)
    k = skew(phi)
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + b[..., None, None] * k + c[..., None, None] * (k @ k)


def so3_left_jacobian_inverse(phi):
    theta2 = np.sum(phi * phi, -1)
    small = theta2 < 1e-8
    theta = np.sqrt(np.where(small, 1.0, theta2))
    coeff = np.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / np.where(small, 1.0, theta2) - (1.0 + np.cos(theta)) / (2.0 * theta * np.sin(theta)))
    k = skew(phi)
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye - 0.5 * k + coeff[..., None, None] * (k @ k)


def so3_log(rot):
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w = np.stack([
        rot[..., 2, 1] - rot[..., 1, 2],
        rot[..., 0, 2] - rot[..., 2, 0],
        rot[..., 1, 0] - rot[..., 0, 1],
    ], -1)
    s2 = 0.25 * np.sum(w * w, -1)
    small = (s2 < 1e-14) & (cos_theta > 0.0)
    sin_theta = np.sqrt(np.where(small, 1.0, s2))
    theta = np.arctan2(sin_theta, cos_theta)
    scale = np.where(small, 0.5 + s2 / 12.0, theta / (2.0 * sin_theta))
    phi = w * scale[..., None]
    # near pi the antisymmetric part vanishes: recover the axis from the
    # diagonal
    near_pi = cos_theta < np.cos(np.pi - 1e-4)
    if np.any(near_pi):
        diag = np.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], -1)
        axis_sq = np.clip(
            (diag - cos_theta[..., None])
            / np.clip(1.0 - cos_theta[..., None], 1e-12, None), 0.0, None)
        axis = np.sqrt(axis_sq)
        s12 = rot[..., 0, 1] + rot[..., 1, 0]
        s13 = rot[..., 0, 2] + rot[..., 2, 0]
        s23 = rot[..., 1, 2] + rot[..., 2, 1]
        sign1 = np.where(w[..., 0] >= 0.0, 1.0, -1.0)
        sign2 = np.where(s12 >= 0.0, sign1, -sign1)
        sign3 = np.where(s13 >= 0.0, sign1, -sign1)
        axis = axis * np.stack([sign1, sign2, sign3], -1)
        # keep the largest pair consistent through s23 when x is tiny
        tiny_x = np.abs(axis[..., 0]) < 1e-6
        sign3b = np.where(s23 >= 0.0, np.sign(axis[..., 1]) + (axis[..., 1] == 0),
                          -(np.sign(axis[..., 1]) + (axis[..., 1] == 0)))
        axis = np.where(
            (near_pi & tiny_x)[..., None],
            np.concatenate([axis[..., :2], (np.abs(axis[..., 2]) * sign3b)[..., None]], -1),
            axis)
        phi = np.where(near_pi[..., None], axis * theta[..., None], phi)
    return phi


def se3_exp(xi):
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    out = np.zeros(xi.shape[:-1] + (4, 4))
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def se3_log(m):
    phi = so3_log(m[..., :3, :3])
    rho = (so3_left_jacobian_inverse(phi) @ m[..., :3, 3:])[..., 0]
    return np.concatenate([rho, phi], -1)


def se3_adjoint(m):
    """Adjoint [..., 6, 6]: [[R, skew(t)·R], [0, R]] (lie.rs:228)."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    out = np.zeros(m.shape[:-2] + (6, 6))
    out[..., :3, :3] = r
    out[..., :3, 3:] = skew(t) @ r
    out[..., 3:, 3:] = r
    return out


def se3_inverse(m):
    rot_t = np.swapaxes(m[..., :3, :3], -1, -2)
    out = np.zeros_like(m)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = -(rot_t @ m[..., :3, 3:])[..., 0]
    out[..., 3, 3] = 1.0
    return out
