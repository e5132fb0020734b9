"""MovingAI Lab benchmark format loaders (`.map` / `.scen`).

The port of rust_robotics_tpu/data/moving_ai.py, host code as the JAX
package's is. `parse_map` and `parse_scenarios` run the port's native C++
runtime (`rust_robotics_tpu_torch/native`) where it is built, and the
pure-Python parsers (`_parse_map_py`, `_parse_scenarios_py`, the reference
semantics) where it is not; tests/test_torch_native_scaling.py holds the
two equal.

Reference: crates/rust_robotics_planning/src/moving_ai.rs — octile `.map`
parse (:21-100), passable tiles {'.', 'G', 'S', 'W'} (:108), conversion to
planner coordinates with a one-cell border so map tile (x, y) lands at
world (x+1, y+1) (:115-151), `.scen` rows with octile-optimal lengths
(:178-230).

Host-side parsing (NumPy) feeding device-side rasters; `to_grid()` produces
the same occupancy raster GridMap::try_new builds from `to_obstacles()`
output at resolution 1.0, robot_radius 0.0 (the reference benchmark
configuration, tests/any_angle_movingai_comparison.rs:21-22).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PASSABLE = frozenset(".GSW")
VALID_TILES = frozenset(".G@OTSW")


@dataclasses.dataclass(frozen=True)
class MovingAiMap:
    width: int
    height: int
    tiles: np.ndarray  # [height, width] of single chars

    def passable(self) -> np.ndarray:
        """[height, width] bool: True where traversable (:108)."""
        return np.isin(self.tiles, list(PASSABLE))

    def to_grid(self, device=None, dtype=torch.float32):
        """Planner occupancy raster matching the reference pipeline
        (to_obstacles border + GridMap radius-0 inflation): a
        [width+1, height+1] blocked raster indexed [ix, iy], where map tile
        (x, y) maps to cell (x+1, y+1) and the x=0 / y=0 border is blocked.
        The far border obstacles at width+1/height+1 fall outside the raster
        exactly as they fall outside GridMap's index range (grid.rs:80-90).
        On `device` (default cuda), the geometry in `dtype`.
        """
        from rust_robotics_tpu_torch.planning.grid import grid_from_raster

        blocked = np.ones((self.width + 1, self.height + 1), dtype=bool)
        blocked[1:, 1:] = ~self.passable().T  # [x, y] indexing
        return grid_from_raster(blocked, min_x=0.0, min_y=0.0, resolution=1.0, device=device,
                                dtype=dtype)

    def planning_point(self, x: int, y: int):
        """Map tile -> world coords (moving_ai.rs:141-151)."""
        return float(x + 1), float(y + 1)


@dataclasses.dataclass(frozen=True)
class MovingAiScenario:
    bucket: int
    map_name: str
    width: int
    height: int
    start_x: int
    start_y: int
    goal_x: int
    goal_y: int
    optimal_length: float


def parse_map(text: str) -> MovingAiMap:
    """Parse a `.map`: natively where the host runtime is built, else in
    pure Python; the two give the same map."""
    from rust_robotics_tpu_torch import native

    if native.available():
        width, height, _passable, tiles = native.parse_map_native(text)
        return MovingAiMap(width=width, height=height, tiles=tiles)
    return _parse_map_py(text)


def _parse_map_py(text: str) -> MovingAiMap:
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    if lines[0].strip() != "type octile":
        raise ValueError(f"unsupported MovingAI map type {lines[0]!r}")
    height = int(lines[1].split()[1])
    width = int(lines[2].split()[1])
    if lines[3].strip() != "map":
        raise ValueError("expected 'map' marker")
    rows = lines[4 : 4 + height]
    if len(rows) != height:
        raise ValueError("map body shorter than declared height")
    tiles = np.array([list(r[:width]) for r in rows])
    if tiles.shape != (height, width):
        raise ValueError("map row width mismatch")
    bad = set(tiles.ravel()) - VALID_TILES
    if bad:
        raise ValueError(f"unknown tiles: {bad}")
    return MovingAiMap(width=width, height=height, tiles=tiles)


def load_map(path) -> MovingAiMap:
    with open(path) as f:
        return parse_map(f.read())


def parse_scenarios(text: str) -> list[MovingAiScenario]:
    """Parse a `.scen`: natively where the host runtime is built, else in
    pure Python; the two give the same rows."""
    from rust_robotics_tpu_torch import native

    if native.available():
        ints, opt, names = native.parse_scenarios_native(text)
        return [
            MovingAiScenario(
                bucket=int(r[0]), map_name=names[i], width=int(r[1]),
                height=int(r[2]), start_x=int(r[3]), start_y=int(r[4]),
                goal_x=int(r[5]), goal_y=int(r[6]),
                optimal_length=float(opt[i]),
            )
            for i, r in enumerate(ints)
        ]
    return _parse_scenarios_py(text)


def _parse_scenarios_py(text: str) -> list[MovingAiScenario]:
    out = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.lower().startswith("version"):
            continue
        parts = ln.split()
        if len(parts) != 9:
            raise ValueError(f"bad .scen row: {ln!r}")
        out.append(
            MovingAiScenario(
                bucket=int(parts[0]),
                map_name=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                start_x=int(parts[4]),
                start_y=int(parts[5]),
                goal_x=int(parts[6]),
                goal_y=int(parts[7]),
                optimal_length=float(parts[8]),
            )
        )
    return out


def load_scenarios(path) -> list[MovingAiScenario]:
    with open(path) as f:
        return parse_scenarios(f.read())
