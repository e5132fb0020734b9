"""ADMM consensus: formation / graph / horizon consensus.

The port of rust_robotics_tpu/control/admm.py. Reference:
crates/rust_robotics_control/src/admm_consensus.rs — agents with local
quadratic objectives agree on a shared consensus variable via ADMM
(x-update local, z-update global average, scaled dual update).

All agents run batched on one device for a fixed number of iterations,
with no read. The horizon consensus's z-system is inverted once
(`inv_ex`) and applied under `full_fp32_matmul` (TF32 off).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.nlls.tridiag import full_fp32_matmul


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho: float = 1.0
    iterations: int = 100


@dataclasses.dataclass(frozen=True)
class ADMMResult:
    x: Any          # [A, d] local solutions
    z: Any          # [d] consensus value
    primal_residual: Any
    dual_residual: Any


def solve_consensus(targets, weights=None, cfg: ADMMConfig = ADMMConfig()):
    """min Σ_i w_i/2 ‖x_i − a_i‖²  s.t.  x_i = z.

    targets [A, d] (a tensor); returns ADMMResult. Scaled-form ADMM:
      x_i ← (w_i a_i + ρ(z − u_i)) / (w_i + ρ)
      z   ← mean(x + u)
      u_i ← u_i + x_i − z
    """
    a = targets
    n_agents = a.shape[0]
    w = (torch.ones((n_agents, 1), dtype=a.dtype, device=a.device) if weights is None
         else torch.as_tensor(weights, dtype=a.dtype, device=a.device).reshape(n_agents, 1))
    rho = cfg.rho
    x, z, u = a, torch.mean(a, dim=0), torch.zeros_like(a)
    pr = dr = torch.zeros((), dtype=a.dtype, device=a.device)
    for _ in range(cfg.iterations):
        x = (w * a + rho * (z - u)) / (w + rho)
        z_new = torch.mean(x + u, dim=0)
        u = u + x - z_new
        pr, dr = torch.linalg.vector_norm(x - z_new), rho * torch.linalg.vector_norm(z_new - z)
        z = z_new
    return ADMMResult(x, z, pr, dr)


def solve_formation_consensus(positions, formation_offsets, weights=None,
                              cfg: ADMMConfig = ADMMConfig()):
    """Formation consensus (admm_consensus.rs `solve_formation_consensus`):
    agents at `positions` [A, d] agree on a formation center such that
    agent i sits at center + offset_i; returns (center [d], target
    positions [A, d], result)."""
    res = solve_consensus(positions - formation_offsets, weights, cfg)
    return res.z, res.z + formation_offsets, res


def _second_difference(horizon, dtype, device):
    """D [H−2, H]: rows (1, −2, 1)."""
    eye = torch.eye(horizon, dtype=dtype, device=device)
    return eye[:-2] - 2.0 * eye[1:-1] + eye[2:]


def solve_horizon_consensus(goal_trajs, anchor=None, smooth_weight=0.0,
                            cfg: ADMMConfig = ADMMConfig()):
    """Receding-horizon trajectory consensus
    (admm_consensus.rs `solve_horizon_consensus`:491-693): agents with
    per-agent goal trajectories agree on one shared center trajectory.

    min over z [H, d]:  Σ_i ½‖x_i − g_i‖²  +  (λ/2)‖Δ²z‖²
    s.t. x_i = z, z_0 = anchor (hard, when given).

    The x-update is the per-agent proximal step x_i = (g_i + ρ(z − u_i)) /
    (1 + ρ); the z-update solves (ρ·A·I + λ DᵀD) z = ρ Σ_i (x_i + u_i)
    per axis with an anchored z_0 moved to the right-hand side.

    goal_trajs [A, H, d] (a tensor); anchor [d] or None. Returns
    (z [H, d], ADMMResult).
    """
    g = goal_trajs
    n_agents, horizon, d = g.shape
    f, dev = g.dtype, g.device
    rho = cfg.rho
    with full_fp32_matmul():
        if horizon >= 3:
            dd = _second_difference(horizon, f, dev)
            smooth = (smooth_weight * dd.T) @ dd
        else:
            smooth = torch.zeros((horizon, horizon), dtype=f, device=dev)
        a_mat = torch.eye(horizon, dtype=f, device=dev) * (rho * n_agents) + smooth
        anchored = anchor is not None
        if anchored:
            anchor = torch.as_tensor(anchor, dtype=f, device=dev)
        if anchored and horizon == 1:
            # the whole trajectory is the anchored step (the reference's
            # m == 0 reduced-system case, admm_consensus.rs:582)
            def z_update(x, u):
                return anchor[None, :]
        elif anchored:
            # the reduced system over the free steps 1..H; the anchored z_0
            # column moves to the right-hand side (admm_consensus.rs:568-581)
            a_red_inv = torch.linalg.inv_ex(a_mat[1:, 1:])[0]
            a_col0 = a_mat[1:, 0]

            def z_update(x, u):
                b = rho * torch.sum(x + u, dim=0)
                b_red = b[1:] - a_col0[:, None] * anchor[None, :]
                return torch.cat([anchor[None, :], a_red_inv @ b_red], dim=0)
        else:
            a_inv = torch.linalg.inv_ex(a_mat)[0]

            def z_update(x, u):
                return a_inv @ (rho * torch.sum(x + u, dim=0))

        z = torch.mean(g, dim=0)
        if anchored:
            z = torch.cat([anchor[None, :], z[1:]], dim=0)
        x = z[None].expand(g.shape)
        u = torch.zeros_like(g)
        pr = dr = torch.zeros((), dtype=f, device=dev)
        scale = rho * math.sqrt(n_agents)
        for _ in range(cfg.iterations):
            x = true_div(g + rho * (z[None] - u), 1.0 + rho)
            z_new = z_update(x, u)
            u = u + x - z_new
            pr = torch.linalg.vector_norm(x - z_new[None])
            dr = scale * torch.linalg.vector_norm(z_new - z)
            z = z_new
    return z, ADMMResult(x, z, pr, dr)
