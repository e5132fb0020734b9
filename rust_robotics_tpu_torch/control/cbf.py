"""Control-barrier-function safety filter.

The port of rust_robotics_tpu/control/cbf.py. Reference:
crates/rust_robotics_control/src/cbf_safety_filter.rs: QP filter
min ‖u − u_des‖² s.t. ḣ_i(x, u) ≥ −α h_i(x) over circle obstacles, for
single-integrator dynamics.

The small QP is solved by projected dual ascent for a fixed number of
steps, with leading batch dims (robots) in lock-step: the products are
`_small`'s explicit sums, so a robot equals its solo run bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch.control._small import mt, mv, rsum


@dataclasses.dataclass(frozen=True)
class CBFConfig:
    alpha: float = 1.0
    dual_iterations: int = 200
    dual_lr: float = 0.3
    u_max: float = 10.0


def solve_qp_dual(u_des, a_mat, b_vec, iterations=200, lr=0.3):
    """min ½‖u − u_des‖² s.t. A u ≥ b, by projected dual ascent:
    u(λ) = u_des + Aᵀλ;  λ ← max(0, λ + lr (b − A u))."""
    at = mt(a_mat)
    lam = torch.zeros_like(b_vec)
    for _ in range(iterations):
        u = u_des + mv(at, lam)
        lam = torch.clamp(lam + lr * (b_vec - mv(a_mat, u)), min=0.0)
    return u_des + mv(at, lam)


def cbf_filter_single_integrator(pos, u_des, obstacles, radii, cfg: CBFConfig = CBFConfig()):
    """Safety-filter a desired velocity for ẋ = u.

    Barriers h_i = ‖x − o_i‖² − r_i²; constraint ∇h_i·u ≥ −α h_i, i.e.
    2(x−o_i)ᵀ u ≥ −α h_i. pos, u_des [..., 2]; obstacles [M, 2]; radii
    [M]. Returns the filtered velocity.
    """
    d = pos[..., None, :] - obstacles  # [..., M, 2]
    h = rsum(d * d, -1) - radii ** 2
    u = solve_qp_dual(u_des, 2.0 * d, -cfg.alpha * h, cfg.dual_iterations, cfg.dual_lr)
    return torch.clamp(u, -cfg.u_max, cfg.u_max)
