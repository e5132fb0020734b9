"""Carry the JAX package's arrays across to the port's tensors.

The system has no learned weights; what crosses is state: a Gaussian belief
and its noise model, a particle cloud, an occupancy grid, a bundle-adjustment
or pose-graph problem, an EKF-SLAM or FastSLAM state, a square-root
belief, an IMU preintegration, nav and bias states, a windowed-VIO window.
Each function takes numpy arrays as the JAX side holds them
(`np.asarray` of a JAX array) and returns tensors on the given device
(default `cuda`) and dtype. `belief_to_lanes`/`belief_from_lanes` switch a
belief between the filter layout (mean [B, 4], cov [B, 4, 4]) and the scan
kernel's lane-major layout (mean [4, B], cov [16, B]), as
ekf_pallas.py:157-170 does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device, to_tensor  # noqa: F401 (re-exported)
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters.particle import ParticleBelief
from rust_robotics_tpu_torch.planning.grid import GridMap


def belief_from_numpy(mean, cov, device=None, dtype=torch.float32) -> GaussianBelief:
    """A JAX `GaussianBelief`'s mean [..., n] and cov [..., n, n]."""
    return GaussianBelief(to_tensor(mean, device, dtype), to_tensor(cov, device, dtype))


def noise_from_numpy(q, r, device=None, dtype=torch.float32):
    """Q and R, each dense or given by its diagonal, -> dense (q, r)."""
    q, r = (to_tensor(x, device, dtype) for x in (q, r))
    return tuple(torch.diag(x) if x.ndim == 1 else x for x in (q, r))


def particles_from_numpy(states, weights, device=None, dtype=torch.float32) -> ParticleBelief:
    """A JAX `ParticleBelief`'s states [..., P, n] and weights [..., P]."""
    return ParticleBelief(to_tensor(states, device, dtype), to_tensor(weights, device, dtype))


def grid_from_numpy(blocked, min_x, min_y, resolution, device=None,
                    dtype=torch.float32) -> GridMap:
    """A JAX `GridMap`'s blocked raster [W, H] and its geometry scalars."""
    device = resolve_device(device)
    return GridMap(torch.tensor(np.asarray(blocked), dtype=torch.bool, device=device),
                   *(to_tensor(x, device, dtype) for x in (min_x, min_y, resolution)))


def bundle_from_numpy(cameras, points, cam_idx, pt_idx, pixels, device=None,
                      dtype=torch.float32):
    """A JAX bundle-adjustment problem's arrays: cameras [C, 4, 4] (or [C, 6]
    tangents), points [P, 3], observation indices [O] and pixels [O, 2] ->
    (cameras, points, cam_idx, pt_idx, pixels), the indices as int64."""
    device = resolve_device(device)
    return (to_tensor(cameras, device, dtype), to_tensor(points, device, dtype),
            to_tensor(cam_idx, device, torch.int64), to_tensor(pt_idx, device, torch.int64),
            to_tensor(pixels, device, dtype))


def pose_graph_from_numpy(poses, edges_from, edges_to, measurements, information=None,
                          device=None, dtype=torch.float32):
    """A JAX pose graph's arrays: poses [N, 3], edge endpoints [E],
    measurements [E, 3] and optional information [E, 3, 3] -> (poses,
    edges_from, edges_to, measurements, information or None), the indices
    as int64."""
    device = resolve_device(device)
    return (to_tensor(poses, device, dtype), to_tensor(edges_from, device, torch.int64),
            to_tensor(edges_to, device, torch.int64), to_tensor(measurements, device, dtype),
            None if information is None else to_tensor(information, device, dtype))


def lanes_from_numpy(*arrays, device=None, dtype=torch.float32):
    """Lane-major arrays ([4, B], [16, B], [T, 2, B]) -> contiguous tensors."""
    return tuple(to_tensor(a, device, dtype).contiguous() for a in arrays)


def belief_to_lanes(belief: GaussianBelief):
    """GaussianBelief (mean [B, 4], cov [B, 4, 4]) -> mean [4, B], cov [16, B]."""
    b = belief.mean.shape[0]
    return belief.mean.T.contiguous(), belief.cov.permute(1, 2, 0).reshape(16, b).contiguous()


def belief_from_lanes(mean, cov) -> GaussianBelief:
    """mean [4, B], cov [16, B] -> GaussianBelief (mean [B, 4], cov [B, 4, 4])."""
    b = mean.shape[-1]
    return GaussianBelief(mean.T, cov.reshape(4, 4, b).permute(2, 0, 1))


def ekf_slam_from_numpy(mean, cov, n_lm, device=None, dtype=torch.float64):
    """A JAX `EKFSLAMBelief`'s mean [..., 3+2L], cov [..., n, n] and
    landmark count [...] (as int64)."""
    from rust_robotics_tpu_torch.slam.ekf_slam import EKFSLAMBelief

    return EKFSLAMBelief(to_tensor(mean, device, dtype), to_tensor(cov, device, dtype),
                         to_tensor(n_lm, device, torch.int64))


def fastslam_from_numpy(poses, weights, lm_mean, lm_cov, lm_seen, device=None,
                        dtype=torch.float64):
    """A JAX `FastSLAMParticles`: poses [..., P, 3], weights [..., P],
    lm_mean [..., P, L, 2], lm_cov [..., P, L, 2, 2], lm_seen [..., P, L]
    (as bool)."""
    from rust_robotics_tpu_torch.slam.fastslam import FastSLAMParticles

    return FastSLAMParticles(to_tensor(poses, device, dtype), to_tensor(weights, device, dtype),
                             to_tensor(lm_mean, device, dtype), to_tensor(lm_cov, device, dtype),
                             to_tensor(lm_seen, device, torch.bool))


def sqrt_belief_from_numpy(mean, sqrt_cov, device=None, dtype=torch.float32):
    """The square-root UKF's belief: mean [..., n] and the lower Cholesky
    factor [..., n, n] -> (mean, sqrt_cov)."""
    return to_tensor(mean, device, dtype), to_tensor(sqrt_cov, device, dtype)


def preintegrated_from_numpy(pre, device=None, dtype=torch.float64):
    """A JAX `Preintegrated` (any object with its seven fields, each with
    the intervals' leading dims) -> the port's `Preintegrated`."""
    from rust_robotics_tpu_torch.slam.imu import Preintegrated

    names = [f.name for f in dataclasses.fields(Preintegrated)]
    return Preintegrated(*(to_tensor(getattr(pre, n), device, dtype) for n in names))


def nav_from_numpy(nav_states, biases, device=None, dtype=torch.float64):
    """Nav states [..., 9] ([rot tangent, position, velocity]) and biases
    [..., 6] ([accel, gyro]) -> (nav_states, biases)."""
    return to_tensor(nav_states, device, dtype), to_tensor(biases, device, dtype)


def vio_window_from_numpy(window, device=None, dtype=torch.float64):
    """One window dict of the JAX `vio_pp` (accel, gyro, dts, cam_local,
    pt_idx, pixels, obs_mask) -> the port's: floats in `dtype`, indices as
    int64, the mask as bool."""
    kinds = {"cam_local": torch.int64, "pt_idx": torch.int64, "obs_mask": torch.bool}
    return {k: to_tensor(v, device, kinds.get(k, dtype)) for k, v in window.items()}


def cubic_spline_from_numpy(t, a, b, c, d, device=None, dtype=torch.float64):
    """A JAX `CubicSpline1D`'s knots and coefficients -> the port's."""
    from rust_robotics_tpu_torch.planning.curves import CubicSpline1D

    return CubicSpline1D(*(to_tensor(x, device, dtype) for x in (t, a, b, c, d)))


def spline2d_from_numpy(s, sx_t, sx_a, sx_b, sx_c, sx_d, sy_t, sy_a, sy_b, sy_c, sy_d,
                        device=None, dtype=torch.float64):
    """A JAX `Spline2D` (its arc lengths and both 1-D splines' fields) ->
    the port's."""
    from rust_robotics_tpu_torch.planning.curves import Spline2D

    return Spline2D(to_tensor(s, device, dtype),
                    cubic_spline_from_numpy(sx_t, sx_a, sx_b, sx_c, sx_d, device, dtype),
                    cubic_spline_from_numpy(sy_t, sy_a, sy_b, sy_c, sy_d, device, dtype))


def quintic_from_numpy(coeffs, device=None, dtype=torch.float64):
    """A JAX `QuinticPolynomial`'s coefficients [..., 6] -> the port's."""
    from rust_robotics_tpu_torch.planning.curves import QuinticPolynomial

    return QuinticPolynomial(to_tensor(coeffs, device, dtype))


def eta3_chain_from_numpy(coeffs, device=None, dtype=torch.float64):
    """η³ chain coefficients [S, 2, 8] -> a tensor."""
    return to_tensor(coeffs, device, dtype)


def tree_from_numpy(nodes, parents, costs, active, count, device=None, dtype=torch.float64):
    """A JAX RRT `Tree` (nodes [..., N, 2], parents, costs, active, count)
    -> the port's: parents and count as int64, active as bool."""
    from rust_robotics_tpu_torch.planning.rrt import Tree

    return Tree(to_tensor(nodes, device, dtype), to_tensor(parents, device, torch.int64),
                to_tensor(costs, device, dtype), to_tensor(active, device, torch.bool),
                to_tensor(count, device, torch.int64))


def pose_tree_from_numpy(poses, parents, costs, active, count, device=None,
                         dtype=torch.float64):
    """A JAX `PoseTree` (poses [..., N, 3], ...) -> the port's."""
    from rust_robotics_tpu_torch.planning.rrt_kinematic import PoseTree

    return PoseTree(to_tensor(poses, device, dtype), to_tensor(parents, device, torch.int64),
                    to_tensor(costs, device, dtype), to_tensor(active, device, torch.bool),
                    to_tensor(count, device, torch.int64))


def dmp_from_numpy(weights, y0, g, device=None, dtype=torch.float64):
    """`dmp_fit`'s weights [n_basis, D] and (y0, g) -> tensors, as
    `dmp_rollout` takes them."""
    return tuple(to_tensor(x, device, dtype) for x in (weights, y0, g))
