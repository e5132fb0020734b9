"""Occupancy grid construction for the grid planners.

Reference: crates/rust_robotics_planning/src/grid.rs — GridMap::try_new
(:71-122) builds a bool occupancy raster from obstacle *points* with
robot-radius inflation (a cell is blocked iff some point lies within
robot_radius of the cell's world position); world<->index uses `.round()`
(:136-158) and a cell's world position is `index*resolution + min` (its
corner, not its centre). `core.types.GridSpec2D` uses floor and centres and
is a different contract: it is not used here.

The inflation test keeps the `|c|² + |p|² − 2c·p <= r²` form of the JAX
package, evaluated over tiles of cells, so that cells on the radius fall on
the same side as there.

Functions that take host data (numpy arrays, lists) create tensors on
`device` (default `cuda`); given tensors, they follow the tensors' device.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._device import (  # noqa: F401 (the planners import them from here)
    _bool_on,
    _float_on,
    _host_bool,
    _placement,
)


@dataclasses.dataclass(frozen=True)
class GridMap:
    """blocked: [W, H] bool raster indexed [ix, iy] (True = obstacle), plus
    the geometry as 0-d tensors (min_x, min_y, resolution)."""

    blocked: torch.Tensor
    min_x: torch.Tensor
    min_y: torch.Tensor
    resolution: torch.Tensor

    @property
    def x_width(self) -> int:
        return self.blocked.shape[-2]

    @property
    def y_width(self) -> int:
        return self.blocked.shape[-1]

    def _origin(self):
        return torch.stack([self.min_x, self.min_y], dim=-1)

    def world_to_index(self, xy):
        """`grid.rs:136`: round((p - min) / resolution), half to even."""
        origin = self._origin()
        xy = torch.as_tensor(xy, dtype=origin.dtype, device=origin.device)
        return torch.round((xy - origin) / self.resolution).to(torch.int32)

    def index_to_world(self, idx):
        """`grid.rs:152`: index * resolution + min."""
        origin = self._origin()
        return idx.to(origin.dtype) * self.resolution + origin

    def free(self):
        return ~self.blocked


def _one_hot(shape, idx, device):
    """[W, H] bool raster, True at the host cell `idx` only."""
    w, h = shape
    gx = torch.arange(w, device=device)[:, None]
    gy = torch.arange(h, device=device)[None, :]
    return (gx == int(idx[0])) & (gy == int(idx[1]))


def _scalars(device, dtype, *values):
    return [torch.tensor(float(v), dtype=dtype, device=device) for v in values]


def grid_from_raster(blocked, min_x=0.0, min_y=0.0, resolution=1.0, device=None,
                     dtype=torch.float32) -> GridMap:
    """A GridMap from a [W, H] occupancy raster (True = blocked)."""
    device = _placement(blocked, device)
    blocked = torch.as_tensor(blocked, device=device).to(torch.bool)
    return GridMap(blocked, *_scalars(device, dtype, min_x, min_y, resolution))


def grid_from_obstacle_points(ox, oy, resolution, robot_radius, tile=4096, device=None,
                              dtype=torch.float32) -> GridMap:
    """An inflated occupancy grid from obstacle points, the contract of
    GridMap::try_new (grid.rs:71-122): extents are the rounded min/max of
    the points, widths round((max - min)/res), and the cell at world
    position (ix*res + min_x, iy*res + min_y) is blocked iff its least
    distance to a point is <= robot_radius.

    Sizing runs on the host (Python floats); the distance test on `device`.
    """
    device = _placement(ox, device)
    ox = torch.as_tensor(ox, dtype=dtype, device=device)
    oy = torch.as_tensor(oy, dtype=dtype, device=device)
    min_x = float(round(float(ox.min())))
    min_y = float(round(float(oy.min())))
    max_x = float(round(float(ox.max())))
    max_y = float(round(float(oy.max())))
    x_width = int(round((max_x - min_x) / resolution))
    y_width = int(round((max_y - min_y) / resolution))
    if x_width <= 0 or y_width <= 0:
        raise ValueError("obstacles must span a non-zero 2D area")

    pts = torch.stack([ox, oy], dim=-1)
    xs = min_x + resolution * torch.arange(x_width, dtype=dtype, device=device)
    ys = min_y + resolution * torch.arange(y_width, dtype=dtype, device=device)
    cells = torch.stack([xs.repeat_interleave(y_width), ys.repeat(x_width)], dim=-1)  # [W*H, 2]

    r2 = torch.tensor(robot_radius, dtype=dtype, device=device) ** 2
    pts_sq = torch.sum(pts**2, dim=-1)
    blocked = []
    for c in cells.split(tile):
        d2 = torch.sum(c**2, dim=-1, keepdim=True) + pts_sq - 2.0 * c @ pts.T
        blocked.append(torch.amin(d2, dim=-1) <= r2)
    blocked = torch.cat(blocked).reshape(x_width, y_width)
    return GridMap(blocked, *_scalars(device, dtype, min_x, min_y, resolution))
