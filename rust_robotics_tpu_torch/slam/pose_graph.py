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
- SE(3) (pose_graph_optimization_3d.rs): nodes stored as tangent
  6-vectors (:14-35), the right-multiplicative retraction, the edge
  residual r = log(Z⁻¹ X_i⁻¹ X_j) (:155-157), which bundle adjustment
  shares, and `optimize_pose_graph_3d` on the same routes as SE(2), plus
  the anchored chain path: host f64 anchors (core/lie_np.py) and small
  device-side locals, composed in deviation space, so that an f32 solve of
  a large-workspace graph keeps its accuracy.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device, to_tensor
from rust_robotics_tpu_torch.core import lie_np
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.core.lie import (
    se3_compose_dev,
    se3_exp,
    se3_expm1,
    se3_inverse,
    se3_log,
    se3_logm1,
)
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
    _host,
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
    group = VariableGroup("pose", poses, retract=se2_retract,
                          fixed_mask=_first_fixed(poses.shape[0], fix_first, poses.device))
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
    solve. chunks (chain_direct only): > 1 runs the SPIKE-chunked ladder of
    that many row chunks, 0 or 1 the plain ladder; None takes the JAX
    package's rule (`_auto_chunks`): the plain ladder to 262,144 poses, the
    chunked ladder above."""
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
    out, summ = _chain_lm(poses, edges_from, edges_to, measurements, information,
                          _first_fixed(poses.shape[0], fix_first, device),
                          residual_fn or se2_edge_residual, retract_fn or se2_retract, tdim,
                          max_iterations, tolerance, refine=refine,
                          chunks=_auto_chunks(poses.shape[0], chunks))
    return out, _summary(summ)


def _first_fixed(n, fix_first, device):
    """[n] bool, the first pose fixed when `fix_first`; built on the device
    (an item write from the host would synchronise)."""
    return torch.arange(n, device=device) < (1 if fix_first else 0)


def _chain_lm(values, edges_from, edges_to, measurements, information, fixed, residual_fn,
              retract_fn, tdim, max_iterations, tolerance, **lm_kw):
    """Split the edges into chain and loop closures (host), then
    `solve_chain_lm` from `values` on its device and dtype."""
    device, dtype = values.device, values.dtype
    (chain_meas, chain_info, loop_ef, loop_et, loop_meas,
     loop_info) = classify_chain_edges(values.shape[0], edges_from, edges_to, measurements,
                                       information)
    return solve_chain_lm(
        values,
        to_tensor(chain_meas, device, dtype),
        None if chain_info is None else to_tensor(chain_info, device, dtype),
        to_tensor(loop_ef, device, torch.int64),
        to_tensor(loop_et, device, torch.int64),
        to_tensor(loop_meas, device, dtype),
        None if loop_info is None else to_tensor(loop_info, device, dtype),
        fixed,
        residual_fn=residual_fn,
        retract_fn=retract_fn,
        tdim=tdim,
        max_iterations=max(max_iterations, 1),
        gradient_tolerance=tolerance,
        step_tolerance=tolerance,
        cost_tolerance=tolerance * tolerance,
        **lm_kw,
    )


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


def se3_anchored_edge_residual(li, lj, meas48):
    """Anchor-recentred SE(3) edge error in deviation space: with
    X_i = A_i·exp(l_i) for host anchors A and small device-side locals l,

        r = log(Z⁻¹ · X_i⁻¹ · X_j)
          = log( M · exp(−hat(Ad_{rel⁻¹} l_i)) · exp(hat(l_j)) ),

    where rel = A_i⁻¹A_j, M = Z⁻¹·rel and Ad_{rel⁻¹} come from the host in
    f64 (core/lie_np.py). Every device-side factor is near the identity and
    composed as a deviation E = T − I (core/lie.py se3_expm1,
    se3_compose_dev, se3_logm1), so the f32 evaluation error is relative to
    max(|residual|, |locals|), not absolute at the workspace's scale;
    re-anchoring (anchor_rounds) shrinks it with the state.

    meas48 packs [E_M's top three rows (12) | Ad_{rel⁻¹} (36)]."""
    e_m = torch.cat([meas48[:12].reshape(3, 4), torch.zeros_like(meas48[:4])[None]], 0)
    ad = meas48[12:].reshape(6, 6)
    e_a = se3_expm1(-(ad @ li))
    e_b = se3_expm1(lj)
    return se3_logm1(se3_compose_dev(se3_compose_dev(e_m, e_a), e_b))


def _auto_chunks(n, chunks):
    """The JAX package's SPIKE chunk rule (slam/pose_graph.py:171-179): the
    plain ladder to 262,144 poses, beyond it the smallest power of two
    keeping each chunk <= 131,072 rows. An explicit `chunks` stands."""
    if chunks is not None:
        return chunks
    chunks = 0
    if n > 262144:
        chunks = 2
        while -(-n // chunks) > 131072:
            chunks *= 2
    return chunks


def _optimize_chain_direct_anchored_se3(pose_tangents, edges_from, edges_to,
                                        measurement_tangents, information, max_iterations,
                                        tolerance, fix_first=True, chunks=None, anchor_rounds=2,
                                        device=None, dtype=torch.float32):
    """The SE(3) chain solve in anchor-recentred deviation coordinates: the
    anchors are the current tangents (composed in f64 on the host), the
    device solves for small locals from zero, and the poses recompose in
    f64; `anchor_rounds + 1` rounds, each re-anchored at the last one's
    solution. LM semantics as the plain chain path; the summary is the last
    round's. Each round reads its locals back once.

    Unlike the JAX package, the capacitance system is factored by LU
    (spd=False), not Cholesky: near the optimum the damping falls to ~1e-8,
    where f32 assembly can make the system indefinite; IEEE f32 Cholesky
    then rejects it and the round ends with numerical_failure. The JAX
    package's own f32 10k test (tests/test_tridiag.py::
    test_se3_anchored_f32_10k_closes_accuracy_island, marked slow) misses
    its 1e-4 RMSE gate on the CPU; with LU the port meets it. In f64 both
    factorisations give the same steps. Numbers in ROADMAP.md C4."""
    device = resolve_device(device)
    t64 = _host(pose_tangents).astype(np.float64)
    n = t64.shape[0]
    ef = _host(edges_from)
    et = _host(edges_to)
    z_inv = lie_np.se3_inverse(lie_np.se3_exp(_host(measurement_tangents).astype(np.float64)))
    fixed = _first_fixed(n, fix_first, device)
    chunks = _auto_chunks(n, chunks)
    cur = t64
    for _ in range(anchor_rounds + 1):
        anchors, meas48 = anchored_measurements(cur, ef, et, z_inv)
        out_locals, summ = _chain_lm(
            torch.zeros((n, 6), dtype=dtype, device=device), ef, et, meas48, information, fixed,
            se3_anchored_edge_residual, se3_retract, 6, max_iterations, tolerance, rdim=6,
            chunks=chunks, spd=False)
        cur = lie_np.se3_log(anchors @ lie_np.se3_exp(_host(out_locals).astype(np.float64)))
    return to_tensor(cur, device, dtype), _summary(summ)


def anchored_measurements(tangents, edges_from, edges_to, z_inv):
    """One anchoring round's host f64 set-up: the anchors A = exp(tangents)
    [N, 4, 4] and each edge's meas48 [E, 48] for
    `se3_anchored_edge_residual` (E_M = Z⁻¹A_i⁻¹A_j − I's top rows, then
    Ad of (A_i⁻¹A_j)⁻¹), given the measurements' inverses z_inv [E, 4, 4]."""
    anchors = lie_np.se3_exp(tangents)
    rel = lie_np.se3_inverse(anchors[edges_from]) @ anchors[edges_to]
    e_m = (z_inv @ rel - np.eye(4))[:, :3, :].reshape(len(rel), 12)
    ad = lie_np.se3_adjoint(lie_np.se3_inverse(rel)).reshape(len(rel), 36)
    return anchors, np.concatenate([e_m, ad], -1)


def build_pose_graph_3d(pose_tangents, edges_from, edges_to, measurement_tangents,
                        information=None, fix_first=True):
    """pose_tangents [N, 6]; edges_* [E]; measurement_tangents [E, 6];
    information [E, 6, 6] (default identity). Tensors, on one device."""
    n = pose_tangents.shape[0]
    group = VariableGroup("pose", pose_tangents, retract=se3_retract,
                          fixed_mask=_first_fixed(n, fix_first, pose_tangents.device))
    idx = torch.stack([torch.as_tensor(edges_from, device=pose_tangents.device).long(),
                       torch.as_tensor(edges_to, device=pose_tangents.device).long()], dim=-1)
    block = FactorBlock("se3_edge", se3_edge_residual, ("pose", "pose"), idx,
                        measurement=measurement_tangents, information=information)
    return Problem((group,), (block,))


def optimize_pose_graph_3d(pose_tangents, edges_from, edges_to, measurement_tangents,
                           information=None, max_iterations=50, tolerance=1e-10,
                           linear_solver="dense", refine=0, anchored=False, chunks=None,
                           anchor_rounds=2, device=None, dtype=torch.float32):
    """optimize_pose_graph_3d (pose_graph_optimization_3d.rs:53-119). Host
    arrays (or tensors) go to `device` (default cuda) in `dtype`. Returns
    (pose tangents [N, 6], SolverSummary).

    linear_solver: the routes of `optimize_pose_graph_2d` on 6-dof tangents
    ("dense", "pcg", "matfree_pcg", "chain_direct", "banded_direct",
    "direct").

    anchored=True (chain_direct or direct only): anchor-recentred residuals,
    the f32 fix for a large workspace. The host composes the poses into
    per-edge anchor-relative transforms in f64; the device solves small
    local corrections only, `anchor_rounds + 1` times. Above 262,144 poses
    it picks the SPIKE-chunked ladder as the JAX package does. chunks: see
    `optimize_pose_graph_2d`."""
    device = resolve_device(device)
    if anchored:
        if linear_solver not in ("chain_direct", "direct"):
            raise ValueError("anchored=True requires the chain_direct (or direct-routed chain) "
                             "solver")
        return _optimize_chain_direct_anchored_se3(
            pose_tangents, edges_from, edges_to, measurement_tangents, information,
            max_iterations, tolerance, chunks=chunks, anchor_rounds=anchor_rounds,
            device=device, dtype=dtype)
    if linear_solver == "direct":
        linear_solver = ("chain_direct"
                         if has_full_chain(len(pose_tangents), edges_from, edges_to)
                         else "banded_direct")
    if linear_solver == "chain_direct":
        return _optimize_chain_direct(pose_tangents, edges_from, edges_to, measurement_tangents,
                                      information, max_iterations, tolerance, refine=refine,
                                      residual_fn=se3_edge_residual, retract_fn=se3_retract,
                                      tdim=6, chunks=chunks, device=device, dtype=dtype)
    if refine:
        raise ValueError(f"refine is only supported by linear_solver='chain_direct', "
                         f"got {linear_solver!r}")
    if linear_solver == "banded_direct":
        return _optimize_banded_direct(pose_tangents, edges_from, edges_to,
                                       measurement_tangents, information, max_iterations,
                                       tolerance, se3_edge_residual, se3_retract, 6,
                                       device=device, dtype=dtype)
    solved, summary = solve(*pose_graph_3d_lm(
        pose_tangents, edges_from, edges_to, measurement_tangents, information, max_iterations,
        tolerance, linear_solver, device, dtype))
    return solved.groups[0].values, summary


def pose_graph_3d_lm(pose_tangents, edges_from, edges_to, measurement_tangents,
                     information=None, max_iterations=50, tolerance=1e-10,
                     linear_solver="dense", device=None, dtype=torch.float32):
    """The (Problem, SolverConfig) that `optimize_pose_graph_3d` hands to
    `solve` on its dense, pcg and matfree_pcg routes; a caller that runs
    another LM on the same graph (`solve_device`) takes its settings here."""
    prob = build_pose_graph_3d(
        to_tensor(pose_tangents, device, dtype), to_tensor(edges_from, device, torch.int64),
        to_tensor(edges_to, device, torch.int64), to_tensor(measurement_tangents, device, dtype),
        None if information is None else to_tensor(information, device, dtype))
    cfg = SolverConfig(
        method="lm",
        max_iterations=max(max_iterations, 1),
        gradient_tolerance=tolerance,
        step_tolerance=tolerance,
        cost_tolerance=tolerance * tolerance,
        linear_solver=linear_solver,
    )
    return prob, cfg
