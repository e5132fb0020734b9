"""Observation models.

Reference: GPS-like position measurement H = [[1,0,0,0],[0,1,0,0]]
(localization/src/ekf.rs:237-245) shared by the Kalman family; range(-only)
landmark observations for the particle filter / FastSLAM
(localization/src/particle_filter.rs:310-336, slam/src/fastslam1.rs).
"""

import torch

from rust_robotics_tpu_torch.core.angles import normalize_angle


def position_observe(state):
    """[..., 4] unicycle state -> [..., 2] position measurement. `ekf.rs:237`."""
    return state[..., :2]


def position_jacobian(state, dtype=None):
    """Constant H [..., 2, 4] = [[1,0,0,0],[0,1,0,0]]. `ekf.rs:243`."""
    dtype = dtype or state.dtype
    # built on the device (a tensor from a host list is a copy that
    # synchronises)
    h = torch.eye(2, 4, dtype=dtype, device=state.device)
    return h.expand(state.shape[:-1] + (2, 4))


def range_observe(state_xy, landmarks):
    """Ranges from positions [..., 2] to landmarks [L, 2] -> [..., L].

    The particle-filter likelihood model (`particle_filter.rs:310-336`).
    """
    d = state_xy[..., None, :] - landmarks
    return torch.linalg.norm(d, dim=-1)


def range_bearing_observe(pose, landmarks):
    """Range-bearing from pose [..., 3] ([x,y,yaw]) to landmarks [L, 2].

    Returns ranges [..., L] and bearings [..., L] in (-pi, pi]
    (EKF-SLAM observation model, slam/src/ekf_slam.rs:237).
    """
    d = landmarks - pose[..., None, :2]
    rng = torch.linalg.norm(d, dim=-1)
    bearing = normalize_angle(torch.atan2(d[..., 1], d[..., 0]) - pose[..., None, 2])
    return rng, bearing
