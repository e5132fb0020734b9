"""SE(2) / SE(3) pose-graph pieces on the shared NLLS engine.

The port, in part, of rust_robotics_tpu/slam/pose_graph.py (reference:
slam/src/pose_graph_optimization.rs and pose_graph_optimization_3d.rs):
- SE(2): additive+wrap retraction (:167), the edge residual
  r = [R_ijᵀ(R_iᵀ(t_j−t_i) − t_ij); wrap(yaw_j − yaw_i − yaw_ij)]
  (:178-200), first pose fixed (:100-103), LM with the reference's
  tolerances (:113-121), for the dense, pcg and matfree_pcg linear solvers;
- SE(3): the right-multiplicative tangent retraction and the edge residual
  r = log(Z⁻¹ X_i⁻¹ X_j) (pose_graph_optimization_3d.rs:155-157), which
  bundle adjustment shares.

The chain, banded and direct solvers (`chain_direct`, `banded_direct`,
`direct`) and the SE(3) optimiser come with slice 4 of the port.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.convert import to_tensor
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.core.lie import se3_exp, se3_inverse, se3_log
from rust_robotics_tpu_torch.nlls import (
    FactorBlock,
    Problem,
    SolverConfig,
    VariableGroup,
    solve,
)

_LATER = ("direct", "chain_direct", "banded_direct")


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------

def se2_retract(value, delta):
    """pose_graph_optimization.rs:167: additive with yaw wrap."""
    return torch.stack([value[0] + delta[0], value[1] + delta[1],
                        normalize_angle(value[2] + delta[2])])


def _rot_t(c, s):
    """[[c, s], [-s, c]] from traced scalars (torch.tensor of traced values
    fails under vmap)."""
    return torch.stack([torch.stack([c, s]), torch.stack([-s, c])])


def se2_edge_residual(xi, xj, meas):
    """pose_graph_optimization.rs:178-200 edge error."""
    r_i_t = _rot_t(torch.cos(xi[2]), torch.sin(xi[2]))
    r_ij_t = _rot_t(torch.cos(meas[2]), torch.sin(meas[2]))
    delta_t = xj[:2] - xi[:2]
    te = r_ij_t @ (r_i_t @ delta_t - meas[:2])
    ang = normalize_angle(xj[2] - xi[2] - meas[2])
    return torch.cat([te, ang[None]])


def build_pose_graph_2d(poses, edges_from, edges_to, measurements, information=None,
                        fix_first=True):
    """poses [N, 3]; edges_* [E]; measurements [E, 3]; information
    [E, 3, 3] (default identity). Tensors, on one device."""
    n = poses.shape[0]
    fixed = torch.zeros((n,), dtype=torch.bool, device=poses.device)
    fixed[0] = fix_first
    group = VariableGroup("pose", poses, retract=se2_retract, fixed_mask=fixed)
    idx = torch.stack([torch.as_tensor(edges_from, device=poses.device).long(),
                       torch.as_tensor(edges_to, device=poses.device).long()], dim=-1)
    block = FactorBlock("se2_edge", se2_edge_residual, ("pose", "pose"), idx,
                        measurement=measurements, information=information)
    return Problem((group,), (block,))


def optimize_pose_graph_2d(poses, edges_from, edges_to, measurements, information=None,
                           max_iterations=50, tolerance=1e-10, linear_solver="dense",
                           pcg_max_iterations=3000, pcg_tolerance=1e-6, device=None,
                           dtype=torch.float32):
    """optimize_pose_graph (pose_graph_optimization.rs:73-140): LM, first
    pose fixed; tolerances mapped as the reference maps PoseGraphConfig
    (PCG defaults follow benchmark_large_pose_graph.rs:66-75). Host arrays
    (or tensors) go to `device` (default cuda) in `dtype`. linear_solver is
    "dense", "pcg" or "matfree_pcg". Returns (poses [N, 3], SolverSummary)."""
    if linear_solver in _LATER:
        raise NotImplementedError(
            f"linear_solver={linear_solver!r} is not ported yet: it belongs to slice 4 "
            f"(the chain and banded pose-graph solvers) of the port")
    device = resolve_device(device)
    prob = build_pose_graph_2d(
        to_tensor(poses, device, dtype), to_tensor(edges_from, device, torch.int64),
        to_tensor(edges_to, device, torch.int64), to_tensor(measurements, device, dtype),
        None if information is None else to_tensor(information, device, dtype))
    cfg = SolverConfig(
        method="lm",
        max_iterations=max(max_iterations, 1),
        gradient_tolerance=tolerance,
        step_tolerance=tolerance,
        cost_tolerance=tolerance * tolerance,
        linear_solver=linear_solver,
        pcg_max_iterations=pcg_max_iterations,
        pcg_tolerance=pcg_tolerance,
    )
    solved, summary = solve(prob, cfg)
    return solved.groups[0].values, summary


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_retract(value, delta):
    """Right-multiplicative tangent update: log(exp(v) · exp(δ))."""
    return se3_log(se3_exp(value) @ se3_exp(delta))


def se3_edge_residual(xi, xj, meas_tangent):
    """r = log(Z⁻¹ · X_i⁻¹ · X_j) (pose_graph_optimization_3d.rs:155-157),
    the measurement given as a tangent [6]."""
    z = se3_exp(meas_tangent)
    return se3_log(se3_inverse(z) @ se3_inverse(se3_exp(xi)) @ se3_exp(xj))
