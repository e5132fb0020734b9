"""Offline visual-inertial odometry pipeline.

The port of rust_robotics_tpu/slam/vio.py (reference:
slam/src/vio_pipeline.rs — `run_vio_pipeline` (:176): IMU initialization +
per-keyframe preintegration (:278, :344) → bundle adjustment over keyframe
cameras + sidecar landmarks → visual-constrained state/bias refinement
(`optimize_imu_trajectory`) → SE(3) pose-graph fusion of visual and
inertial odometry (`fuse_pose_graph` :408); `pose_error` (:450)).

The stages are the port's subsystems, composed on the host as the JAX
package composes them: stage 1 preintegrates the K − 1 keyframe intervals
as lanes of one `preintegrate` call (ragged intervals padded with dt = 0,
an exact no-op) and chains K − 1 `predict_nav_state` calls; stage 2 is
`bundle_adjust` (Schur, Huber, two fixed cameras), whose retained camera
system goes to kernel B4 for a CUDA float32 system of 1024 or more dims
(171 keyframes or more); stages 3 and 4 are `optimize_imu_trajectory` and
`optimize_pose_graph_3d` (dense). The landmark initialisation noise of
`point_init_noise` is `point_init_noise · draws`, with standard-normal
draws [L, 3] passed in (`draws=`) or drawn from `generator` (a
`torch.Generator` on the device; seeded 0 when not given), where the JAX
package draws from `jax.random.PRNGKey(0)`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device, to_tensor
from rust_robotics_tpu_torch.core.lie import se3_exp, se3_inverse, se3_log, so3_exp, so3_log
from rust_robotics_tpu_torch.data.euroc import quat_to_rot
from rust_robotics_tpu_torch.nlls import RobustKernel, SolverConfig
from rust_robotics_tpu_torch.slam.bundle_adjustment import CameraIntrinsics, bundle_adjust
from rust_robotics_tpu_torch.slam.imu import (
    GRAVITY,
    optimize_imu_trajectory,
    predict_nav_state,
    preintegrate,
)
from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_3d


@dataclasses.dataclass
class VIOResult:
    nav_states: Any          # [K, 9] refined IMU states (body frame)
    biases: Any              # [K, 6]
    fused_poses: Any         # [K, 4, 4] body poses after pose-graph fusion
    ba_cameras: Any          # [K, 4, 4]
    ba_points: Any           # [L, 3]
    dead_reckoned: Any       # [K, 9]
    summaries: dict


def nav_to_se3(nav):
    """[..., 9] -> homogeneous body pose [..., 4, 4]."""
    top = torch.cat([so3_exp(nav[..., 0:3]), nav[..., 3:6, None]], dim=-1)
    last = torch.eye(4, dtype=nav.dtype, device=nav.device)[3:].expand(top[..., :1, :].shape)
    return torch.cat([top, last], dim=-2)


def initial_state(dataset, device, dtype):
    """(nav0 [9], bias0 [6]) from the first ground-truth row, or zeros
    (docs/datasets.md:47-49: ground truth initialises only the first
    state)."""
    gt = dataset.ground_truth
    if gt is None:
        return (torch.zeros(9, dtype=dtype, device=device),
                torch.zeros(6, dtype=dtype, device=device))
    rot0 = torch.as_tensor(quat_to_rot(gt.quaternions[0]), device=device).to(dtype)
    nav0 = torch.cat([so3_log(rot0), torch.as_tensor(gt.positions[0], device=device).to(dtype),
                      torch.as_tensor(gt.velocities[0], device=device).to(dtype)])
    bias0 = torch.as_tensor(np.concatenate([gt.accel_bias[0], gt.gyro_bias[0]]),
                            device=device).to(dtype)
    return nav0, bias0


def interval_lanes(dataset, cam_ts, max_samples=None):
    """The IMU samples between consecutive keyframes as padded host lanes:
    (accel [K-1, S, 3], gyro [K-1, S, 3], dts [K-1, S]), each interval's
    samples first and dt = 0 after them; S is the longest interval (at
    least 1) unless `max_samples` is given."""
    parts = [dataset.imu_between(int(cam_ts[i]), int(cam_ts[i + 1]))
             for i in range(len(cam_ts) - 1)]
    s = max([1] + [len(d) for _, _, d in parts]) if max_samples is None else max_samples
    accel = np.zeros((len(parts), s, 3))
    gyro = np.zeros((len(parts), s, 3))
    dts = np.zeros((len(parts), s))
    for i, (a, g, d) in enumerate(parts):
        if len(d) > s:
            raise ValueError("max_samples too small for interval")
        accel[i, :len(d)], gyro[i, :len(d)], dts[i, :len(d)] = a, g, d
    return accel, gyro, dts


def imu_refine_kwargs(dead_reckoned, bias0, ba_body, cam_ts):
    """Stage 3's priors and measurements (`optimize_imu_trajectory`'s
    keyword arguments): the first dead-reckoned state and bias as priors,
    the bias random walk, and the BA body positions [K, 3] with velocity
    proxies from their finite differences."""
    f, device = dead_reckoned.dtype, dead_reckoned.device
    k = dead_reckoned.shape[0]
    positions = ba_body[:, :3, 3]
    dts_k = torch.as_tensor(np.diff(np.asarray(cam_ts[:k])) / 1e9, device=device).to(f)
    vel = torch.cat([(positions[1:] - positions[:-1]) / dts_k[:, None],
                     (positions[-1:] - positions[-2:-1]) / dts_k[-1]])
    eye = torch.eye(9, dtype=f, device=device)
    posvel_w = torch.cat([torch.full((3,), 1e2, dtype=f, device=device),
                          torch.ones(3, dtype=f, device=device)])
    return dict(
        nav_prior=dead_reckoned[0], nav_prior_info=1e8 * eye,
        bias_prior=bias0, bias_prior_info=1e2 * eye[:6, :6],
        bias_between_info=1e6 * eye[:6, :6],
        posvel_meas=torch.cat([positions, vel], dim=-1),
        posvel_indices=torch.arange(k, device=device),
        posvel_info=torch.diag(posvel_w).expand(k, 6, 6),
    )


def run_vio_pipeline(dataset, tracks, accel_sigma=0.02, gyro_sigma=0.002,
                     gravity=GRAVITY, max_keyframes=None,
                     pixel_sigma=1.0, point_init_noise=0.0, draws=None, generator=None,
                     device=None, dtype=torch.float32):
    """Full pipeline on an EurocDataset + FeatureTracks (vio_pipeline.rs:176),
    on `device` (default cuda) in `dtype`.

    Returns VIOResult; `summaries` holds the three solver summaries and
    `seconds`, the host seconds of each stage (each solver stage ends in a
    read of its result, so its device work lies inside its span). Ground
    truth (first state) initializes pose/velocity/biases only, matching
    docs/datasets.md:47-49."""
    device = resolve_device(device)
    f = dtype
    cam_ts = dataset.cam.timestamps
    if max_keyframes is not None:
        cam_ts = cam_ts[:max_keyframes]
    k = len(cam_ts)
    clock = [time.perf_counter()]

    # --- stage 1: IMU initialization + dead reckoning (:278) ---
    nav0, bias0 = initial_state(dataset, device, f)
    accel, gyro, dts = (torch.as_tensor(x, device=device).to(f)
                        for x in interval_lanes(dataset, cam_ts))
    pres = preintegrate(accel, gyro, dts, bias0, accel_sigma, gyro_sigma)
    navs = [nav0]
    for i in range(k - 1):
        navs.append(predict_nav_state(pres.map(lambda x, i=i: x[i]), navs[-1], bias0, gravity))
    dead_reckoned = torch.stack(navs)
    clock.append(time.perf_counter())

    # --- stage 2: bundle adjustment ---
    t_bs = torch.as_tensor(dataset.cam.t_bs, device=device).to(f)
    cams0 = nav_to_se3(dead_reckoned) @ t_bs  # world-from-camera
    intr = CameraIntrinsics(*[float(v) for v in dataset.cam.intrinsics])
    ts_to_idx = {int(t): i for i, t in enumerate(cam_ts)}
    sel = np.isin(tracks.obs_timestamps, np.asarray(cam_ts))
    cam_idx = np.array([ts_to_idx[int(t)] for t in tracks.obs_timestamps[sel]], np.int64)
    pt_idx = tracks.obs_landmark_ids[sel].astype(np.int64)
    points0 = torch.as_tensor(tracks.landmarks, device=device).to(f)
    if point_init_noise:
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            draws = torch.randn(points0.shape, generator=generator, device=device, dtype=f)
        points0 = points0 + point_init_noise * to_tensor(draws, device, f)
    # two fixed cameras anchor the monocular gauge AND scale (one camera
    # leaves a similarity freedom that reprojects perfectly but drifts the
    # structure); the reference defaults to one because its demo problems
    # carry depth-true initializations
    ba_cams, ba_points, ba_summary = bundle_adjust(
        cams0, points0, cam_idx, pt_idx, tracks.obs_pixels[sel], intr,
        fixed_cameras=2, robust=RobustKernel("huber", 2.0),
        config=SolverConfig(linear_solver="schur", max_iterations=30),
        device=device, dtype=f,
    )
    clock.append(time.perf_counter())

    # --- stage 3: visual-constrained IMU refinement (:799) ---
    ba_body = ba_cams @ se3_inverse(t_bs)
    nav_refined, biases, imu_summary = optimize_imu_trajectory(
        dead_reckoned, bias0.expand(k, 6).clone(), pres, gravity,
        config=SolverConfig(max_iterations=30),
        **imu_refine_kwargs(dead_reckoned, bias0, ba_body, cam_ts),
    )
    clock.append(time.perf_counter())

    # --- stage 4: SE(3) pose-graph fusion (:408) ---
    imu_poses = nav_to_se3(nav_refined)
    vis_rel = se3_log(se3_inverse(ba_body[:-1]) @ ba_body[1:])
    imu_rel = se3_log(se3_inverse(imu_poses[:-1]) @ imu_poses[1:])
    ar = torch.arange(k, device=device)
    ef = torch.cat([ar[:-1], ar[:-1]])
    et = torch.cat([ar[1:], ar[1:]])
    eye6 = torch.eye(6, dtype=f, device=device)
    info = torch.cat([(10.0 * eye6).expand(k - 1, 6, 6), eye6.expand(k - 1, 6, 6)])
    fused_tangents, fuse_summary = optimize_pose_graph_3d(
        se3_log(imu_poses), ef, et, torch.cat([vis_rel, imu_rel]), info, max_iterations=30,
        device=device, dtype=f,
    )
    fused = se3_exp(fused_tangents)
    clock.append(time.perf_counter())

    stages = ("preintegrate", "bundle_adjust", "imu_refine", "fusion")
    return VIOResult(
        nav_states=nav_refined,
        biases=biases,
        fused_poses=fused,
        ba_cameras=ba_cams,
        ba_points=ba_points,
        dead_reckoned=dead_reckoned,
        summaries={"ba": ba_summary, "imu": imu_summary, "fusion": fuse_summary,
                   "seconds": dict(zip(stages, np.diff(clock).tolist()))},
    )


def pose_error(poses, gt_positions):
    """Translation RMSE of [K, 4, 4] poses vs ground-truth positions."""
    if isinstance(poses, torch.Tensor):
        poses = poses.detach().cpu().numpy()
    d = np.asarray(poses)[:, :3, 3] - np.asarray(gt_positions)
    return float(np.sqrt(np.mean(np.sum(d**2, axis=-1))))


def pose_error_se3(actual, expected):
    """SE(3) tangent-norm pose error ‖log(expected⁻¹·actual)‖ — the exact
    metric of the reference's `pose_error` (vio_pipeline.rs:450-452) used
    by the headless EuRoC acceptance gate (headless_euroc_vio.rs:43-47).
    Accepts single [4,4] poses or batched [..., 4, 4], as tensors (on
    their device) or host arrays (on the CPU, in float64); returns numpy."""
    if not isinstance(actual, torch.Tensor):
        actual = torch.tensor(np.asarray(actual, dtype=np.float64))
    expected = to_tensor(expected, actual.device, actual.dtype)
    tau = se3_log(se3_inverse(expected) @ actual)
    return torch.linalg.vector_norm(tau, dim=-1).cpu().numpy()
