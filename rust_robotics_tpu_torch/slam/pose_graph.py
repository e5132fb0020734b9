"""SE(2) / SE(3) pose-graph pieces on the shared NLLS engine.

The port, in part, of rust_robotics_tpu/slam/pose_graph.py (reference:
slam/src/pose_graph_optimization.rs and pose_graph_optimization_3d.rs):
- SE(2): additive+wrap retraction (:167), the edge residual
  r = [R_ijᵀ(R_iᵀ(t_j−t_i) − t_ij); wrap(yaw_j − yaw_i − yaw_ij)]
  (:178-200), first pose fixed (:100-103), LM with the reference's
  tolerances (:113-121), for every linear solver of the JAX package:
  dense, pcg and matfree_pcg on the shared NLLS engine; `chain_direct`
  (nlls/tridiag.py: cyclic-reduction ladder + Woodbury loop closures, the
  nested elimination for large closure-rich chains); `banded_direct`
  (nlls/banded.py: RCM-banded fat-block ladder + Woodbury); and `direct`,
  which takes the chain route when every (i, i+1) pair has an edge and the
  banded route otherwise;
- SE(3): the right-multiplicative tangent retraction and the edge residual
  r = log(Z⁻¹ X_i⁻¹ X_j) (pose_graph_optimization_3d.rs:155-157), which
  bundle adjustment shares.

The SE(3) optimiser (`optimize_pose_graph_3d` and its anchored chain path)
is not ported yet (ROADMAP.md A12).
"""

from __future__ import annotations

import numpy as np
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
from rust_robotics_tpu_torch.nlls.banded import solve_general_graph
from rust_robotics_tpu_torch.nlls.solver import SolverSummary
from rust_robotics_tpu_torch.nlls.tridiag import (
    TERMINATION_NAMES,
    classify_chain_edges,
    has_full_chain,
    solve_chain_lm,
)


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
                           pcg_max_iterations=3000, pcg_tolerance=1e-6, refine=0, chunks=None,
                           device=None, dtype=torch.float32):
    """optimize_pose_graph (pose_graph_optimization.rs:73-140): LM, first
    pose fixed; tolerances mapped as the reference maps PoseGraphConfig
    (PCG defaults follow benchmark_large_pose_graph.rs:66-75). Host arrays
    (or tensors) go to `device` (default cuda) in `dtype`. Returns
    (poses [N, 3], SolverSummary).

    linear_solver: "dense", "pcg" or "matfree_pcg" (the host LM of
    nlls/solver.py); "chain_direct", the LM of nlls/tridiag.py with one
    cyclic-reduction solve + Woodbury loop-closure correction per iteration
    and no host read inside an iteration, for an odometry chain with loop
    closures; "banded_direct", the RCM-banded supernodal solve of
    nlls/banded.py for any topology; "direct", chain_direct when every
    (i, i+1) pair has an edge, banded_direct otherwise.

    refine (chain_direct only): iterative-refinement passes of each linear
    solve. chunks (chain_direct only): None or 0/1 runs the plain ladder at
    any n; chunks > 1 (the SPIKE-chunked ladder) is not ported and
    raises."""
    device = resolve_device(device)
    if linear_solver == "direct":
        linear_solver = ("chain_direct" if has_full_chain(len(poses), edges_from, edges_to)
                         else "banded_direct")
    if linear_solver == "chain_direct":
        return _optimize_chain_direct(poses, edges_from, edges_to, measurements, information,
                                      max_iterations, tolerance, refine=refine, chunks=chunks,
                                      device=device, dtype=dtype)
    if refine:
        raise ValueError(f"refine is only supported by linear_solver='chain_direct', "
                         f"got {linear_solver!r}")
    if linear_solver == "banded_direct":
        return _optimize_banded_direct(poses, edges_from, edges_to, measurements, information,
                                       max_iterations, tolerance, se2_edge_residual,
                                       se2_retract, 3, device=device, dtype=dtype)
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


def _summary(summ):
    """The SolverSummary of a direct solve: one linear solve per LM
    iteration, so linear_iterations == iterations."""
    return SolverSummary(float(summ.initial_cost), float(summ.final_cost),
                         int(summ.iterations), int(summ.accepted_steps),
                         TERMINATION_NAMES[int(summ.termination_code)], int(summ.iterations))


def _optimize_chain_direct(poses, edges_from, edges_to, measurements, information,
                           max_iterations, tolerance, fix_first=True, refine=0,
                           residual_fn=None, retract_fn=None, tdim=3, chunks=None,
                           device=None, dtype=torch.float32):
    """A pose graph on the chain solver (nlls/tridiag.py)."""
    device = resolve_device(device)
    poses = to_tensor(poses, device, dtype)
    n = poses.shape[0]
    (chain_meas, chain_info, loop_ef, loop_et, loop_meas,
     loop_info) = classify_chain_edges(n, edges_from, edges_to, measurements, information)
    fixed = torch.zeros((n,), dtype=torch.bool, device=device)
    fixed[0] = fix_first
    out, summ = solve_chain_lm(
        poses,
        to_tensor(chain_meas, device, dtype),
        None if chain_info is None else to_tensor(chain_info, device, dtype),
        to_tensor(loop_ef, device, torch.int64),
        to_tensor(loop_et, device, torch.int64),
        to_tensor(loop_meas, device, dtype),
        None if loop_info is None else to_tensor(loop_info, device, dtype),
        fixed,
        residual_fn=residual_fn or se2_edge_residual,
        retract_fn=retract_fn or se2_retract,
        tdim=tdim,
        max_iterations=max(max_iterations, 1),
        gradient_tolerance=tolerance,
        step_tolerance=tolerance,
        cost_tolerance=tolerance * tolerance,
        refine=refine,
        chunks=chunks or 0,
    )
    return out, _summary(summ)


def _optimize_banded_direct(poses, edges_from, edges_to, measurements, information,
                            max_iterations, tolerance, residual_fn, retract_fn, tdim,
                            fix_first=True, device=None, dtype=torch.float32):
    """A pose graph of any topology on the RCM-banded supernodal solver
    (nlls/banded.py)."""
    device = resolve_device(device)
    poses = to_tensor(poses, device, dtype)
    fixed = np.zeros((poses.shape[0],), bool)
    fixed[0] = fix_first
    out, summ, _ = solve_general_graph(
        poses, edges_from, edges_to, measurements, information, fixed,
        residual_fn=residual_fn, retract_fn=retract_fn, tdim=tdim,
        max_iterations=max(max_iterations, 1), tolerance=tolerance)
    return out, _summary(summ)


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
