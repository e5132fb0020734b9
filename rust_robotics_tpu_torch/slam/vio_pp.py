"""Pipeline-parallel windowed VIO replay (fixed-lag smoother).

The port of rust_robotics_tpu/slam/vio_pp.py (reference:
slam/src/vio_pipeline.rs:176 composes preintegration → BA → refinement →
pose-graph fusion strictly sequentially over the whole sequence, keyframe
windows :296-316; the windowed stages microbatch the keyframe windows and
pipeline the stages across devices).

Stages, on windows of uniform shapes:

  A  preintegrate   [independent]  the window's frame transitions as lanes
                                   of one `preintegrate` call
  B  dead-reckon    [chain, cheap] nav-state propagation; carry = nav at
                                   window boundary
  C  visual refine  [independent]  per-camera Gauss-Newton on reprojection
                                   residuals against the (fixed) landmark map
  D  fuse           [chain]        per-window SE(3) pose graph anchored on
                                   the previous window's fused tail pose
                                   (entry edge = IMU odometry; in-window
                                   edges = visual + inertial odometry, the
                                   10:1 weighting of vio_pipeline.rs:408)

Windows stream through `parallel.pipeline.run_pipelined` (GPipe diagonal);
`pipelined=False` runs the identical stages window-major, and the two
outputs are bitwise equal. Differences from the JAX package: stage C's
Jacobian is reverse mode, per observation with respect to its own camera
(the JAX package's forward-mode Jacobian of all residuals with respect to
all cameras is zero elsewhere), and its 6×6 systems go to `solve_ex`, which
reads nothing back; stage D solves its pose graph with `solve_device`, the
LM that reads nothing back inside an iteration, on the problem and
settings of `optimize_pose_graph_3d`'s dense route (`pose_graph_3d_lm`),
where the JAX package calls that function (the host-side LM); the dtype is an argument (`jnp.result_type(
float)` in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.lie import se3_exp, se3_inverse, se3_log
from rust_robotics_tpu_torch.nlls import solve_device
from rust_robotics_tpu_torch.parallel.pipeline import Stage, run_pipelined, run_sequential
from rust_robotics_tpu_torch.slam.bundle_adjustment import CameraIntrinsics
from rust_robotics_tpu_torch.slam.imu import GRAVITY, predict_nav_state, preintegrate
from rust_robotics_tpu_torch.slam.pose_graph import pose_graph_3d_lm
from rust_robotics_tpu_torch.slam.vio import initial_state, interval_lanes, nav_to_se3


def _window_inputs(dataset, tracks, window_frames, f, device, max_imu, max_obs):
    """Host-side packing of uniform-shape window dicts of tensors."""
    cam_ts = dataset.cam.timestamps
    k = (len(cam_ts) // window_frames) * window_frames
    cam_ts = cam_ts[:k]
    n_w = k // window_frames
    ts_to_local = {int(t): i for i, t in enumerate(cam_ts)}

    # lane gi holds the transition gi-1 -> gi; lane 0 is a dummy of dt = 0
    lanes = [np.concatenate([np.zeros_like(x[:1]), x])
             for x in interval_lanes(dataset, cam_ts, max_imu)]
    if max_obs is None:
        max_obs = 1
        for w in range(n_w):
            lo = w * window_frames
            max_obs = max(max_obs, int(np.isin(tracks.obs_timestamps,
                                               cam_ts[lo:lo + window_frames]).sum()))

    def t(x, dtype=f):
        return torch.as_tensor(x, device=device).to(dtype)

    windows = []
    for w in range(n_w):
        lo = w * window_frames
        sel = np.isin(tracks.obs_timestamps, cam_ts[lo:lo + window_frames])
        o = int(sel.sum())
        if o > max_obs:
            raise ValueError("max_obs too small for window")
        cam_local = np.zeros((max_obs,), np.int64)
        pt_idx = np.zeros((max_obs,), np.int64)
        pixels = np.zeros((max_obs, 2))
        mask = np.zeros((max_obs,), bool)
        cam_local[:o] = [ts_to_local[int(ts)] - lo for ts in tracks.obs_timestamps[sel]]
        pt_idx[:o] = tracks.obs_landmark_ids[sel]
        pixels[:o] = tracks.obs_pixels[sel]
        mask[:o] = True
        accel, gyro, dts = (x[lo:lo + window_frames] for x in lanes)
        windows.append({
            "accel": t(accel), "gyro": t(gyro), "dts": t(dts),
            "cam_local": t(cam_local, torch.int64), "pt_idx": t(pt_idx, torch.int64),
            "pixels": t(pixels), "obs_mask": t(mask, torch.bool),
        })
    return windows, k


def _refine_cameras(cam0_tangents, landmarks, cam_local, pt_idx, pixels,
                    obs_mask, intr, iters=10, damping=1e-4):
    """Per-camera GN against fixed landmarks (PnP refinement). Cameras are
    world-from-camera tangents [Wf, 6]; observations are window-local."""
    wf = cam0_tangents.shape[0]
    f, dev = cam0_tangents.dtype, cam0_tangents.device
    points = landmarks[pt_idx]
    onehot = (cam_local[:, None] == torch.arange(wf, device=dev)).to(f)  # [O, Wf]
    live = obs_mask[:, None]

    def residual(tangent, point, pixel):
        inv = se3_inverse(se3_exp(tangent))
        return intr.project(inv[:3, :3] @ point + inv[:3, 3]) - pixel

    res = torch.func.vmap(residual)
    jac = torch.func.vmap(torch.func.jacrev(residual))  # [O, 2, 6]
    eye = torch.eye(6, dtype=f, device=dev)
    tangents = cam0_tangents
    for _ in range(iters):
        at = tangents[cam_local]
        r = torch.where(live, res(at, points, pixels), 0.0)  # [O, 2]
        j = torch.where(live[..., None], jac(at, points, pixels), 0.0)
        # per-camera normal equations (cameras are decoupled given the map)
        jt = torch.einsum("ow,oij->wij", onehot, j.mT @ j)  # [Wf, 6, 6]
        g = torch.einsum("ow,oi->wi", onehot, (j.mT @ r[..., None])[..., 0])  # [Wf, 6]
        step = torch.linalg.solve_ex(jt + damping * eye, g[..., None])[0][..., 0]
        tangents = tangents - step
    return tangents


def fuse_problem(carry_pose, win, vis_weight=10.0, imu_weight=1.0, fuse_iterations=20):
    """Stage D's pose graph for one window and its solver settings: (Problem,
    SolverConfig). The carry is the previous window's fused tail pose, or
    None for the first window (then the anchor nav's pose)."""
    navs = win["navs"]
    wf = navs.shape[0]
    dev = navs.device
    imu_poses = nav_to_se3(navs)
    anchor_pose = nav_to_se3(win["anchor_nav"])
    carry_pose = anchor_pose if carry_pose is None else carry_pose

    # entry edge: IMU odometry anchor -> frame 0 of the window
    entry = se3_log(se3_inverse(anchor_pose) @ imu_poses[0])[None]
    body = win["refined_body"]
    vis_rel = se3_log(se3_inverse(body[:-1]) @ body[1:])
    imu_rel = se3_log(se3_inverse(imu_poses[:-1]) @ imu_poses[1:])
    ar = torch.arange(wf + 1, device=dev)
    ef = torch.cat([ar[:1], ar[1:wf], ar[1:wf]])
    et = torch.cat([ar[1:2], ar[2:], ar[2:]])
    f6 = torch.eye(6, dtype=navs.dtype, device=dev)
    info = torch.cat([(imu_weight * f6).expand(1, 6, 6), (vis_weight * f6).expand(wf - 1, 6, 6),
                      (imu_weight * f6).expand(wf - 1, 6, 6)])
    init = torch.cat([se3_log(carry_pose)[None], se3_log(body)])
    return pose_graph_3d_lm(init, ef, et, torch.cat([entry, vis_rel, imu_rel]), info,
                            max_iterations=fuse_iterations, device=dev, dtype=navs.dtype)


def make_stages(dataset, tracks, window_frames=3, accel_sigma=0.02,
                gyro_sigma=0.002, gravity=GRAVITY, max_imu=None,
                max_obs=None, vis_weight=10.0, imu_weight=1.0,
                fuse_iterations=20, device=None, dtype=torch.float32):
    """Build (stages, windows, nav0, k) on `device` (default cuda) in
    `dtype`. Stage outputs are enriched dicts so downstream stages see
    upstream results (the pipeline passes one value)."""
    device = resolve_device(device)
    f = dtype
    nav0, bias0 = initial_state(dataset, device, f)
    windows, k = _window_inputs(dataset, tracks, window_frames, f, device, max_imu, max_obs)
    t_bs = torch.as_tensor(dataset.cam.t_bs, device=device).to(f)
    landmarks = torch.as_tensor(tracks.landmarks, device=device).to(f)
    intr = CameraIntrinsics(*[float(v) for v in dataset.cam.intrinsics])

    def on(x, like):
        return x.to(like.device)

    def stage_preintegrate(win):
        pres = preintegrate(win["accel"], win["gyro"], win["dts"], on(bias0, win["dts"]),
                            accel_sigma, gyro_sigma)
        return {**win, "pres": pres}

    def stage_dead_reckon(carry_nav, win):
        pres = win["pres"]
        bias = on(bias0, carry_nav)
        navs, nav = [], carry_nav
        for j in range(pres.delta_time.shape[0]):
            nav = predict_nav_state(pres.map(lambda x, j=j: x[j]), nav, bias, gravity)
            navs.append(nav)
        return nav, {**win, "navs": torch.stack(navs), "anchor_nav": carry_nav}

    def stage_visual_refine(win):
        tbs = on(t_bs, win["navs"])
        cams0 = se3_log(nav_to_se3(win["navs"]) @ tbs)
        refined = _refine_cameras(cams0, on(landmarks, tbs), win["cam_local"], win["pt_idx"],
                                  win["pixels"], win["obs_mask"], intr)
        return {**win, "refined_body": se3_exp(refined) @ se3_inverse(tbs)}

    def stage_fuse(carry_pose, win):
        problem, config = fuse_problem(carry_pose, win, vis_weight, imu_weight,
                                       fuse_iterations)
        solved, _ = solve_device(problem, config)
        fused = se3_exp(solved.groups[0].values[1:])
        return fused[-1], {"fused": fused, "dead_reckoned": nav_to_se3(win["navs"]),
                           "refined_body": win["refined_body"]}

    stages = [
        Stage(stage_preintegrate),
        Stage(stage_dead_reckon, chain=True, init_carry=nav0),
        Stage(stage_visual_refine),
        Stage(stage_fuse, chain=True, init_carry=None),
    ]
    return stages, windows, nav0, k


@dataclasses.dataclass
class WindowedVIOResult:
    fused_poses: Any       # [K, 4, 4]
    dead_reckoned: Any     # [K, 4, 4]
    refined_body: Any      # [K, 4, 4]
    schedule: list
    num_windows: int


def run_vio_pipeline_windowed(dataset, tracks, window_frames=3, pipelined=True,
                              devices=None, device=None, dtype=torch.float32, max_windows=None,
                              **kw):
    """Windowed VIO replay; pipelined=True streams windows through the
    GPipe schedule (one device per stage, cycled from `devices`, default
    `device`), False runs window-major. Both produce identical output.
    `max_windows` replays the flight's first windows only."""
    device = resolve_device(device)
    stages, windows, _, _ = make_stages(dataset, tracks, window_frames, device=device,
                                        dtype=dtype, **kw)
    windows = windows[:max_windows]
    record = []
    if pipelined:
        outs = run_pipelined(stages, windows, devices=devices or [device], record=record)
    else:
        outs = run_sequential(stages, windows)
    fused = torch.cat([o["fused"].to(device) for o in outs])
    dead = torch.cat([o["dead_reckoned"].to(device) for o in outs])
    refined = torch.cat([o["refined_body"].to(device) for o in outs])
    return WindowedVIOResult(fused, dead, refined, record, len(windows))
