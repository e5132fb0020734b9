"""Core value types as frozen dataclasses of tensors.

Reference surface: crates/rust_robotics_core/src/types.rs (Pose2D:90,
State2D:141, Path2D:219). Every field is a tensor whose leading dims are the
batch, so a filter is `step(belief[B], z[B], u[B]) -> belief[B]`.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.core.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class Pose2D:
    """SE(2) pose. `types.rs:90`. Fields: [...] tensors."""

    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor

    def normalized(self) -> "Pose2D":
        return Pose2D(self.x, self.y, normalize_angle(self.yaw))

    def as_array(self):
        return torch.stack([self.x, self.y, self.yaw], dim=-1)

    @staticmethod
    def from_array(a) -> "Pose2D":
        return Pose2D(a[..., 0], a[..., 1], a[..., 2])


@dataclasses.dataclass(frozen=True)
class State2D:
    """Unicycle state [x, y, yaw, v]. `types.rs:141`."""

    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor
    v: torch.Tensor

    def as_array(self):
        return torch.stack([self.x, self.y, self.yaw, self.v], dim=-1)

    @staticmethod
    def from_array(a) -> "State2D":
        return State2D(a[..., 0], a[..., 1], a[..., 2], a[..., 3])


@dataclasses.dataclass(frozen=True)
class GaussianBelief:
    """Batched Gaussian state belief: mean [..., n], covariance [..., n, n].

    The shared belief type of the whole Kalman family.
    """

    mean: torch.Tensor
    cov: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]


@dataclasses.dataclass(frozen=True)
class Path2D:
    """Padded waypoint path: points [..., N, 2] + valid mask [..., N].

    Capacity is fixed and `mask` marks live waypoints (`types.rs:219`).
    """

    points: torch.Tensor
    mask: torch.Tensor

    def total_length(self):
        """Arc length over valid consecutive segments."""
        deltas = self.points[..., 1:, :] - self.points[..., :-1, :]
        seg = torch.linalg.norm(deltas, dim=-1)
        valid = self.mask[..., 1:] * self.mask[..., :-1]
        return torch.sum(seg * valid, dim=-1)

    def num_valid(self):
        return torch.sum(self.mask.to(torch.int32), dim=-1)


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Occupancy-grid geometry (world<->index math).

    Cell index i maps to world x = min_x + (i + 0.5) * resolution, the
    coordinate contract of the reference GridMap (grid.rs:136-175).
    """

    min_x: float
    min_y: float
    resolution: float
    width: int
    height: int

    @property
    def max_x(self) -> float:
        return self.min_x + self.width * self.resolution

    @property
    def max_y(self) -> float:
        return self.min_y + self.height * self.resolution

    def world_to_index(self, xy):
        """World coords [..., 2] -> integer cell indices [..., 2] (ix, iy).

        A true division on every device (`_numeric.true_div`; CUDA's
        division by a number multiplies by its reciprocal, which moves a
        point on a cell boundary, such as x = 0.3 at resolution 0.1, into
        the next cell)."""
        rel = torch.stack([true_div(xy[..., 0] - self.min_x, self.resolution),
                           true_div(xy[..., 1] - self.min_y, self.resolution)], dim=-1)
        return torch.floor(rel).to(torch.int32)

    def index_to_world(self, idx, dtype=torch.float32):
        """Cell indices [..., 2] -> world coords of cell centers [..., 2]."""
        off = (idx.to(dtype) + 0.5) * self.resolution
        return torch.stack([self.min_x + off[..., 0], self.min_y + off[..., 1]], dim=-1)

    def in_bounds(self, idx):
        ix, iy = idx[..., 0], idx[..., 1]
        return (ix >= 0) & (ix < self.width) & (iy >= 0) & (iy < self.height)
