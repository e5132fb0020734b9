"""A headless SLAM-node pipeline: scan → ICP → submap → quality-gated
blend.

The port of rust_robotics_tpu/slam/slam_node.py. Reference:
ros2_nodes/slam_node/src/main.rs — laser scan to points (:203), stride
subsampling for ICP (:228), the per-axis ICP quality gate
`compute_icp_blend_decision` (:592) built from ramp weights (`ramp_weight`
:572, `ramp_up_weight` :582), clamped correction blending
`blend_motion_delta` (:741), the local submap budget `append_and_prune`
(:508) and the gating defaults (:31-41). The ROS plumbing is not
reproduced: the same decisions are driven by a simulated scan and
odometry stream.

Scans and submaps are fixed-capacity [..., N, 2] tensors with validity
masks; the gate is branch-free arithmetic returning (alpha, reason code),
so the functions take leading batch dims. `run_slam_node_loop` is a host
loop over the steps, as in the JAX package, with nothing read back inside
it; its odometry noise comes from the same numpy generator and seed, so
both packages run on the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.slam.scan_matching import point_to_line_icp

__all__ = [
    "IcpGatingParams", "REASONS", "ramp_weight", "ramp_up_weight",
    "compute_icp_blend_decision", "blend_motion_delta", "scan_to_points",
    "subsample_stride", "append_and_prune", "run_slam_node_loop",
]


# slam_node/src/main.rs:31-41 defaults
@dataclasses.dataclass(frozen=True)
class IcpGatingParams:
    blend_alpha: float = 0.35
    blend_alpha_yaw: float = 0.35
    full_weight_error: float = 0.007
    reject_error: float = 0.011
    full_weight_error_yaw: float = 0.007
    reject_error_yaw: float = 0.011
    full_weight_iterations: float = 12.0
    reject_iterations: float = 40.0
    full_weight_translation_correction: float = 0.05
    max_translation_correction: float = 0.25
    full_weight_yaw_correction: float = 0.08
    max_yaw_correction: float = 0.35
    full_weight_translation_motion: float = 0.05
    full_weight_yaw_motion: float = 0.08


# Reason codes (main.rs uses &'static str reasons; here fixed integers).
REASONS = (
    "accepted",                # 0
    "not_converged",           # 1
    "invalid_error",           # 2
    "high_error",              # 3
    "slow_convergence",        # 4
    "translation_outlier",     # 5
    "yaw_outlier",             # 6
    "low_motion",              # 7
    "attenuated_low_motion",   # 8
    "attenuated_error",        # 9
    "attenuated_iterations",   # 10
    "attenuated_translation",  # 11
    "attenuated_yaw",          # 12
    "rejected",                # 13
)
_R = {name: i for i, name in enumerate(REASONS)}


def ramp_weight(value, full_weight_limit, reject_limit):
    """1 below full_weight_limit, 0 above reject_limit, linear between
    (main.rs:572)."""
    return torch.clamp((reject_limit - value) / (reject_limit - full_weight_limit), 0.0, 1.0)


def ramp_up_weight(value, reject_limit, full_weight_limit):
    """0 below reject_limit, 1 above full_weight_limit (main.rs:582)."""
    return torch.clamp((value - reject_limit) / (full_weight_limit - reject_limit), 0.0, 1.0)


def _code(name, like):
    return torch.full(like.shape, _R[name], dtype=torch.int64, device=like.device)


def _axis_decision(base_alpha, final_error, full_weight_error, reject_error, iteration_weight,
                   correction_size, max_correction, correction_weight, motion_weight,
                   outlier_code, attenuated_code):
    """compute_axis_decision (main.rs:697), branch-free: alpha = base ·
    min(error, iteration, correction, motion weights); the reason follows
    the precedence of the reference's early returns."""
    error_weight = ramp_weight(final_error, full_weight_error, reject_error)
    scale = torch.minimum(torch.minimum(error_weight, iteration_weight),
                          torch.minimum(correction_weight, motion_weight))
    alpha = base_alpha * scale
    code = lambda name: _code(name, scale)  # noqa: E731
    # attenuation attribution: which weight is the binding minimum
    reason = torch.where(scale == iteration_weight, code("attenuated_iterations"),
                         code(attenuated_code))
    reason = torch.where(scale == error_weight, code("attenuated_error"), reason)
    reason = torch.where(scale == motion_weight, code("attenuated_low_motion"), reason)
    # precedence-ordered rejections (the first match wins, as the early returns)
    for cond, name in reversed((
            (correction_size >= max_correction, outlier_code),
            (error_weight <= 0.0, "high_error"),
            (iteration_weight <= 0.0, "slow_convergence"),
            (correction_weight <= 0.0, outlier_code),
            (motion_weight <= 0.0, "low_motion"),
            (alpha <= 0.0, "rejected"),
            (scale >= 0.999, "accepted"))):
        reason = torch.where(cond, code(name), reason)
    is_reject = (((reason >= _R["not_converged"]) & (reason <= _R["low_motion"]))
                 | (reason == _R["rejected"]))
    return torch.where(is_reject, 0.0, alpha), reason


def compute_icp_blend_decision(odom, icp, converged, iterations, final_error,
                               p: IcpGatingParams = IcpGatingParams()):
    """The per-axis ICP trust decision (main.rs:592). `odom`/`icp` are
    motion deltas [..., 3] = [x, y, yaw]. Returns dict(alpha_xy,
    reason_xy, alpha_yaw, reason_yaw), reasons indexing REASONS."""
    corr = icp - odom
    corr_t = torch.linalg.norm(corr[..., :2], dim=-1)
    corr_yaw = torch.abs(normalize_angle(corr[..., 2]))
    final_error = torch.as_tensor(final_error, dtype=corr.dtype, device=corr.device)
    converged = torch.as_tensor(converged, device=corr.device)

    iteration_weight = ramp_weight(torch.as_tensor(iterations, dtype=corr.dtype,
                                                   device=corr.device),
                                   p.full_weight_iterations, p.reject_iterations)
    trans_motion = ramp_up_weight(torch.linalg.norm(odom[..., :2], dim=-1),
                                  p.full_weight_translation_motion * 0.25,
                                  p.full_weight_translation_motion)
    yaw_motion = ramp_up_weight(torch.abs(odom[..., 2]), p.full_weight_yaw_motion * 0.25,
                                p.full_weight_yaw_motion)
    yaw_axis_motion = torch.maximum(trans_motion, yaw_motion)
    corr_t_weight = ramp_weight(corr_t, p.full_weight_translation_correction,
                                p.max_translation_correction)
    corr_yaw_weight = ramp_weight(corr_yaw, p.full_weight_yaw_correction, p.max_yaw_correction)

    alpha_xy, reason_xy = _axis_decision(
        p.blend_alpha, final_error, p.full_weight_error, p.reject_error, iteration_weight,
        corr_t, p.max_translation_correction, corr_t_weight, trans_motion,
        "translation_outlier", "attenuated_translation")
    alpha_yaw, reason_yaw = _axis_decision(
        p.blend_alpha_yaw, final_error, p.full_weight_error_yaw, p.reject_error_yaw,
        iteration_weight, corr_yaw, p.max_yaw_correction, corr_yaw_weight, yaw_axis_motion,
        "yaw_outlier", "attenuated_yaw")

    # global rejections override both axes (main.rs:600-605)
    bad = ~converged | ~torch.isfinite(final_error)
    bad_code = torch.where(~converged, _R["not_converged"], _R["invalid_error"])
    return dict(alpha_xy=torch.where(bad, 0.0, alpha_xy),
                reason_xy=torch.where(bad, bad_code, reason_xy),
                alpha_yaw=torch.where(bad, 0.0, alpha_yaw),
                reason_yaw=torch.where(bad, bad_code, reason_yaw))


def blend_motion_delta(odom, icp, alpha_xy, alpha_yaw, p: IcpGatingParams = IcpGatingParams()):
    """Blend the clamped ICP corrections into the odometry (main.rs:741)."""
    mt = p.max_translation_correction
    cx = torch.clamp(icp[..., 0] - odom[..., 0], -mt, mt)
    cy = torch.clamp(icp[..., 1] - odom[..., 1], -mt, mt)
    cyaw = torch.clamp(normalize_angle(icp[..., 2] - odom[..., 2]),
                       -p.max_yaw_correction, p.max_yaw_correction)
    return torch.stack([odom[..., 0] + alpha_xy * cx, odom[..., 1] + alpha_xy * cy,
                        normalize_angle(odom[..., 2] + alpha_yaw * cyaw)], dim=-1)


def scan_to_points(ranges, angle_min, angle_increment, range_min, range_max):
    """LaserScan ranges [..., N] → body-frame points [..., N, 2] and a
    validity mask (main.rs:203 drops non-finite and out-of-range returns;
    here they stay as masked slots)."""
    n = ranges.shape[-1]
    angles = angle_min + angle_increment * torch.arange(n, dtype=ranges.dtype,
                                                        device=ranges.device)
    valid = torch.isfinite(ranges) & (ranges > range_min) & (ranges < range_max)
    r = torch.where(valid, ranges, 0.0)
    return torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1), valid


def subsample_stride(points, valid, stride: int, min_points: int = 4):
    """Keep every stride-th VALID return (main.rs:228); the full set when
    fewer than `min_points` survive. A mask-only edit."""
    if stride <= 1:
        return valid
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1  # the index among valid points
    keep = valid & (rank % stride == 0)
    few = torch.sum(keep, dim=-1, keepdim=True) < min_points
    return torch.where(few, valid, keep)


def append_and_prune(submap_pts, submap_valid, new_pts, new_valid, anchor, max_radius: float,
                     max_points: int):
    """The submap budget (main.rs:508): prune by radius around the anchor,
    keep the newest `max_points`. The capacity C is the submap's; new
    points overwrite the OLDEST slots (ring semantics give the reference's
    newest-first survival)."""
    cap = submap_pts.shape[-2]
    both_pts = torch.cat([submap_pts, new_pts], dim=-2)
    both_valid = torch.cat([submap_valid, new_valid], dim=-1)
    in_radius = torch.linalg.norm(both_pts - anchor[..., None, :2], dim=-1) <= max_radius
    both_valid = both_valid & in_radius
    # newest first: order rows by (valid, recency) and take the last `cap`;
    # the stable sort keeps the append order among ties
    order = torch.argsort(both_valid.to(torch.int32), dim=-1, stable=True)
    keep = order[..., -cap:]
    pts = torch.take_along_dim(both_pts, keep[..., None], dim=-2)
    valid = torch.take_along_dim(both_valid, keep, dim=-1)
    # max_points among the kept (the newest survive)
    n_valid = torch.sum(valid, dim=-1, keepdim=True)
    overflow = torch.clamp(n_valid - max_points, min=0)
    rank = torch.cumsum(valid.to(torch.int64), dim=-1)  # 1-based among valid, oldest first
    return pts, valid & (rank > overflow)


@dataclasses.dataclass(frozen=True)
class SlamNodeDiagnostics:
    """A per-scan record mirroring /slam_diagnostics; stacked over steps."""

    alpha_xy: torch.Tensor
    alpha_yaw: torch.Tensor
    reason_xy: torch.Tensor
    reason_yaw: torch.Tensor
    icp_error: torch.Tensor
    icp_iterations: torch.Tensor
    submap_points: torch.Tensor
    pose_error: torch.Tensor
    odom_error: torch.Tensor


def _se2_apply(pose, pts):
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    return pts @ rot.mT + pose[..., None, :2]


def _se2_delta(a, b):
    """The body-frame motion delta a → b (main.rs MotionDelta)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    d = b[..., :2] - a[..., :2]
    return torch.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1],
                        normalize_angle(b[..., 2] - a[..., 2])], dim=-1)


def _se2_compose(pose, delta):
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([pose[..., 0] + c * delta[..., 0] - s * delta[..., 1],
                        pose[..., 1] + s * delta[..., 0] + c * delta[..., 1],
                        normalize_angle(pose[..., 2] + delta[..., 2])], dim=-1)


def _room(dtype, device):
    """A square room's wall points and three round pillars (the pillars pin
    the rotation: along bare walls NN correspondences slide)."""
    kw = dict(dtype=dtype, device=device)
    side = torch.linspace(-5.0, 5.0, 320, **kw)
    ang = 2 * np.pi * torch.arange(48, **kw) / 48
    ring = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    pillars = torch.cat([torch.tensor([[2.5, 1.5]], **kw) + 0.4 * ring,
                         torch.tensor([[-2.0, 2.5]], **kw) + 0.3 * ring,
                         torch.tensor([[-1.0, -3.0]], **kw) + 0.5 * ring])
    five = torch.full_like(side, 5.0)
    return torch.cat([torch.stack([side, -five], -1), torch.stack([side, five], -1),
                      torch.stack([-five, side], -1), torch.stack([five, side], -1), pillars])


def run_slam_node_loop(steps: int = 60, stride: int = 2, odom_drift: float = 0.004,
                       odom_noise: float = 0.002, submap_capacity: int = 1024,
                       submap_max_points: int = 800, submap_radius: float = 6.0,
                       bootstrap_scans: int = 3, seed: int = 0,
                       gating: IcpGatingParams = IcpGatingParams(
                           # sensor-dependent gate thresholds (env-tuned in
                           # the reference, main.rs:245-380 ICP_*): scaled
                           # to this sim's wall-sampling NN residual
                           full_weight_error=0.02, reject_error=0.06,
                           full_weight_error_yaw=0.02, reject_error_yaw=0.06,
                           full_weight_iterations=31.0, reject_iterations=60.0),
                       device=None, dtype=torch.float64):
    """The headless slam_node loop: a unicycle drives a circle in a square
    room; each step makes a dense scan of the walls, odometry accumulates
    drift and noise, scan-to-scan point-to-line ICP proposes a correction,
    the quality gate blends it, and the submap ring gathers world-frame
    points. On `device` (default cuda) in `dtype`. Returns a dict of the
    stacked SlamNodeDiagnostics and the final poses and submap."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=device)
    walls = _room(dtype, device)

    def observe(pose):
        """The body-frame view of every wall point (a virtual dense scan)."""
        c, s = torch.cos(pose[2]), torch.sin(pose[2])
        rot = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
        return (walls - pose[None, :2]) @ rot.T

    dt = 0.1
    v, w = 1.2, 0.35  # drive a circle inside the room
    truth = torch.zeros(3, **kw)
    raw_odom = torch.zeros(3, **kw)
    corrected = torch.zeros(3, **kw)
    prev_scan = observe(truth)
    prev_raw = raw_odom
    sub_pts = torch.zeros((submap_capacity, 2), **kw)
    sub_valid = torch.zeros((submap_capacity,), dtype=torch.bool, device=device)

    icp_iters = 30
    n = prev_scan.shape[0]
    # the stride's keep mask is the same every step: its indices once
    ones = torch.ones((n,), dtype=torch.bool)
    keep = torch.nonzero(subsample_stride(None, ones, stride))[:, 0].to(device)
    delta_true = torch.tensor([v * dt, 0.0, w * dt], **kw)
    drift = torch.tensor([odom_drift, 0.0, odom_drift * 0.5], **kw)
    iterations = torch.tensor(icp_iters, device=device)
    diags = []
    for k in range(steps):
        # the truth advances; odometry integrates the same motion plus drift
        truth = _se2_compose(truth, delta_true)
        noise = torch.tensor(rng.normal(0.0, odom_noise, 3), **kw)
        raw_odom = _se2_compose(raw_odom, delta_true + drift + noise)

        scan = observe(truth)
        # ICP aligns the previous scan to the current one; point-to-line
        # removes the tangential sliding bias of flat walls
        icp_delta, icp_err = point_to_line_icp(prev_scan[keep], scan[keep], iterations=icp_iters)
        odom_delta = _se2_delta(prev_raw, raw_odom)
        dec = compute_icp_blend_decision(odom_delta, icp_delta, torch.isfinite(icp_err),
                                         iterations, icp_err, gating)
        blended = blend_motion_delta(odom_delta, icp_delta, dec["alpha_xy"], dec["alpha_yaw"],
                                     gating)
        corrected = _se2_compose(corrected, blended)

        # submap maintenance in the corrected world frame
        world_pts = _se2_apply(corrected, scan[keep][:submap_capacity])
        new_valid = torch.ones((world_pts.shape[0],), dtype=torch.bool, device=device)
        radius = submap_radius if k >= bootstrap_scans else 1e9
        sub_pts, sub_valid = append_and_prune(sub_pts, sub_valid, world_pts, new_valid,
                                              corrected, radius, submap_max_points)
        diags.append(SlamNodeDiagnostics(
            alpha_xy=dec["alpha_xy"], alpha_yaw=dec["alpha_yaw"],
            reason_xy=dec["reason_xy"], reason_yaw=dec["reason_yaw"],
            icp_error=icp_err, icp_iterations=iterations,
            submap_points=torch.sum(sub_valid),
            pose_error=torch.linalg.norm(corrected[:2] - truth[:2]),
            odom_error=torch.linalg.norm(raw_odom[:2] - truth[:2]),
        ))
        prev_scan = scan
        prev_raw = raw_odom

    stacked = SlamNodeDiagnostics(**{f.name: torch.stack([getattr(d, f.name) for d in diags])
                                     for f in dataclasses.fields(SlamNodeDiagnostics)})
    return dict(diagnostics=stacked, truth=truth, raw_odom=raw_odom, corrected=corrected,
                submap=(sub_pts, sub_valid))
