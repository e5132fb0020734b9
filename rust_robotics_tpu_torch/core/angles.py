"""Angle utilities (reference: rust_robotics_core/src/types.rs Pose2D::normalize_yaw)."""

import math

import torch


def normalize_angle(theta):
    """Wrap an angle (tensor) to (-pi, pi].

    The floor-based wrap yields [-pi, pi); -pi is then mapped to pi, so the
    result lies in (-pi, pi] as the reference's `Pose2D::normalize_yaw`.
    """
    two_pi = 2.0 * math.pi
    wrapped = theta - two_pi * torch.floor((theta + math.pi) / two_pi)
    return torch.where(wrapped <= -math.pi, wrapped + two_pi, wrapped)


def angle_diff(a, b):
    """Smallest signed difference a - b, wrapped to (-pi, pi]."""
    return normalize_angle(a - b)
