"""Bundle adjustment: pinhole reprojection factors over cameras + landmarks.

The port of rust_robotics_tpu/slam/bundle_adjustment.py (reference:
slam/src/bundle_adjustment.rs — `CameraIntrinsics::project` (:21-31),
world-from-camera SE(3) poses stored as tangents with the
right-multiplicative retraction, euclidean landmarks, residual =
project(cam⁻¹ · p_world) − pixel, Huber(δ=2) by default, the leading
cameras fixed for gauge (:76-86), Schur elimination of the landmarks).

All observations form one factor block; the landmarks are the LAST group,
so the Schur path eliminates their 3×3 blocks and the retained camera
system goes to `nlls.solver._reduced_solve` (kernel B4 for a CUDA float32
system of 1024 or more dims under the default `reduced_solver="auto"`).
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._device import resolve_device, to_tensor
from rust_robotics_tpu_torch.core.lie import se3_exp, se3_inverse, se3_log
from rust_robotics_tpu_torch.nlls import (
    FactorBlock,
    Problem,
    RobustKernel,
    SolverConfig,
    VariableGroup,
    solve,
)
from rust_robotics_tpu_torch.slam.pose_graph import se3_retract


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    def project(self, point_cam):
        """bundle_adjustment.rs:21-31, with z clamped at 1e-9 instead of an
        error (a numeric guard, as in the JAX package)."""
        z = torch.clamp(point_cam[..., 2], min=1e-9)
        return torch.stack([self.fx * point_cam[..., 0] / z + self.cx,
                            self.fy * point_cam[..., 1] / z + self.cy], dim=-1)


def make_reprojection_residual(intrinsics: CameraIntrinsics):
    def residual(cam_tangent, point_world, pixel):
        inv = se3_inverse(se3_exp(cam_tangent))
        p_cam = inv[:3, :3] @ point_world + inv[:3, 3]
        return intrinsics.project(p_cam) - pixel

    return residual


def build_bundle_adjustment(cameras, points, cam_indices, point_indices, pixels, intrinsics,
                            information=None, fixed_cameras: int = 1,
                            robust=RobustKernel("huber", 2.0)):
    """cameras: [C, 4, 4] world-from-camera (or [C, 6] tangents); points
    [P, 3]; observations: cam_indices / point_indices [O], pixels [O, 2].
    Tensors, on one device."""
    cams = se3_log(cameras) if cameras.ndim == 3 else cameras
    fixed = torch.arange(cams.shape[0], device=cams.device) < fixed_cameras
    cam_group = VariableGroup("camera", cams, retract=se3_retract, fixed_mask=fixed)
    pt_group = VariableGroup("point", points)
    idx = torch.stack([cam_indices.long(), point_indices.long()], dim=-1)
    block = FactorBlock("reprojection", make_reprojection_residual(intrinsics),
                        ("camera", "point"), idx, measurement=pixels,
                        information=information, robust=robust)
    # points last => Schur eliminates the landmark blocks (sparse.rs:160)
    return Problem((cam_group, pt_group), (block,))


def bundle_adjust(cameras, points, cam_indices, point_indices, pixels, intrinsics,
                  information=None, fixed_cameras=1, robust=RobustKernel("huber", 2.0),
                  use_schur=True, config: SolverConfig | None = None, device=None,
                  dtype=torch.float32):
    """bundle_adjust (bundle_adjustment.rs:108+). Host arrays (or tensors)
    go to `device` (default cuda) in `dtype`, index arrays as int64.
    Returns (cameras [C, 4, 4], points [P, 3], SolverSummary)."""
    device = resolve_device(device)
    prob = build_bundle_adjustment(
        to_tensor(cameras, device, dtype), to_tensor(points, device, dtype),
        to_tensor(cam_indices, device, torch.int64), to_tensor(point_indices, device, torch.int64),
        to_tensor(pixels, device, dtype), intrinsics,
        None if information is None else to_tensor(information, device, dtype),
        fixed_cameras, robust,
    )
    if config is None:
        config = SolverConfig(linear_solver="schur" if use_schur else "dense")
    elif use_schur and config.linear_solver == "dense":
        config = dataclasses.replace(config, linear_solver="schur")
    solved, summary = solve(prob, config)
    cams = se3_exp(solved.group("camera").values)
    pts = solved.group("point").values
    return cams, pts, summary
