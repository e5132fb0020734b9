"""PythonRobotics-style A* variants with golden-CSV parity.

The port of rust_robotics_tpu/planning/a_star_variants.py: the same host
Python and NumPy (a sorted open list and dicts), touching no device, as
the port's `control/mission.py` is host Python.

Reference: planning/src/a_star_variants.rs — variant modes (:16-23,
beam / iterative-deepening / dynamic-weighting / theta-star-like /
jump-point-corners), `AStarVariantConfig` defaults (:38-52), grid
construction + rounding rules (:108-172), 14/10 octile heuristic (:295),
motion model (:300-311), interpolated line-of-sight probe (:325-347),
corner key-point extraction (:349-425), farthest-point stepping (:427-460),
threshold-gated cost update (:507-545), the shared sorted-open-list search
loop (:633-756) and the corner-graph search (:547-630). The reference pins
these planners to PythonRobotics golden CSVs
(src/testdata/a_star_variants_*_python.csv, tests :905-:949); this module
reproduces the paths bit-exactly so the same goldens gate this repo.

Design note: these are deliberately host-side sequential planners — they
exist for exact output parity with the reference's golden fixtures and as
the legacy PythonRobotics API surface. The path for optimal
grid search is the batched min-plus wavefront engine
(planning/wavefront.py), which subsumes the *optimal*
variants at "grid cells relaxed/s" scale; the variants here are
heuristic/suboptimal modes whose value is behavioral parity, not FLOPs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

Coord = Tuple[int, int]

MODES = (
    "standard",
    "beam",
    "iterative_deepening",
    "dynamic_weighting",
    "theta_star_like",
    "jump_point_corners",
)


@dataclasses.dataclass(frozen=True)
class AStarVariantConfig:
    """a_star_variants.rs:38-52 defaults."""

    resolution: float = 1.0
    robot_radius: float = 0.0
    mode: str = "standard"
    beam_capacity: int = 30
    epsilon: float = 4.0
    upper_bound_depth: int = 500
    max_theta: int = 5
    only_corners: bool = False
    max_corner: float = 5.0

    def validate(self):
        if not math.isfinite(self.resolution) or self.resolution <= 0:
            raise ValueError(f"resolution must be positive, got {self.resolution}")
        if not math.isfinite(self.robot_radius) or self.robot_radius < 0:
            raise ValueError("robot_radius must be non-negative and finite")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.beam_capacity <= 0:
            raise ValueError("beam_capacity must be greater than zero")
        if not math.isfinite(self.epsilon) or self.epsilon < 0:
            raise ValueError("epsilon must be non-negative and finite")
        if self.upper_bound_depth <= 0:
            raise ValueError("upper_bound_depth must be greater than zero")
        if self.max_theta <= 0:
            raise ValueError("max_theta must be greater than zero")
        if not math.isfinite(self.max_corner) or self.max_corner <= 0:
            raise ValueError("max_corner must be positive and finite")


class _Node:
    __slots__ = ("pred", "gcost", "hcost", "fcost", "open", "in_open_list")

    def __init__(self, hcost: float):
        self.pred: Optional[Coord] = None
        self.gcost = math.inf
        self.hcost = hcost
        self.fcost = math.inf
        self.open = True
        self.in_open_list = False


def _heuristic(a: Coord, b: Coord) -> float:
    """14/10 integer octile heuristic (a_star_variants.rs:293-297)."""
    dx = abs(a[0] - b[0])
    dy = abs(a[1] - b[1])
    return 14.0 * min(dx, dy) + 10.0 * (max(dx, dy) - min(dx, dy))


_MOTION = (
    (-1, -1, 14.0), (-1, 0, 10.0), (-1, 1, 14.0), (0, -1, 10.0),
    (0, 1, 10.0), (1, -1, 14.0), (1, 0, 10.0), (1, 1, 14.0),
)


def _los_steps() -> np.ndarray:
    """The t values of the reference's probe loop: 0, then += 0.001 while
    t <= 0.5 (accumulated, as it accumulates them)."""
    ts, t = [], 0.0
    while t <= 0.5:
        ts.append(t)
        t += 0.001
    return np.asarray(ts)


_LOS_T = _los_steps()


class AStarVariantPlanner:
    """Grid planner over obstacle point lists (a_star_variants.rs:243-266)."""

    def __init__(self, ox, oy, config: AStarVariantConfig = AStarVariantConfig()):
        config.validate()
        ox = np.asarray(ox, np.float64)
        oy = np.asarray(oy, np.float64)
        if ox.shape != oy.shape:
            raise ValueError("obstacle x/y lengths must match")
        if ox.size == 0:
            raise ValueError("at least one obstacle point is required")
        if not (np.isfinite(ox).all() and np.isfinite(oy).all()):
            raise ValueError("obstacle coordinates must be finite")
        self.config = config
        res = config.resolution
        self.min_x = round(float(ox.min()))
        self.min_y = round(float(oy.min()))
        max_x = round(float(ox.max()))
        max_y = round(float(oy.max()))
        self.x_width = int(round((max_x - self.min_x) / res)) + 1
        self.y_width = int(round((max_y - self.min_y) / res)) + 1
        # vectorized inflation (grid cell occupied if within robot_radius of
        # any obstacle point — a_star_variants.rs:151-163)
        gx = self.min_x + np.arange(self.x_width)[:, None] * res
        gy = self.min_y + np.arange(self.y_width)[None, :] * res
        d2 = ((ox[None, None, :] - gx[..., None]) ** 2
              + (oy[None, None, :] - gy[..., None]) ** 2)
        self.obstacle_map = (d2 <= config.robot_radius ** 2).any(-1)

    # --- index math (a_star_variants.rs:175-190) ---
    def _xi(self, x: float) -> int:
        return int(round((x - self.min_x) / self.config.resolution))

    def _yi(self, y: float) -> int:
        return int(round((y - self.min_y) / self.config.resolution))

    def _pos(self, c: Coord) -> Tuple[float, float]:
        return (self.min_x + c[0] * self.config.resolution,
                self.min_y + c[1] * self.config.resolution)

    def _contains(self, x: int, y: int) -> bool:
        return 0 <= x < self.x_width and 0 <= y < self.y_width

    def _is_valid(self, x: int, y: int) -> bool:
        return self._contains(x, y) and not self.obstacle_map[x, y]

    def _blocked(self, x: int, y: int) -> bool:
        return not self._contains(x, y) or bool(self.obstacle_map[x, y])

    def _clear(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The reference's bidirectional interpolation probe for segments
        a[k] → b[k] ([P, 2] integer cells): t ∈ [0, 0.5] step 0.001 with
        truncation to int (a_star_variants.rs:325-347), every step at once,
        with the reference loop's t values and products. [P] bool."""
        t = _LOS_T
        a, b = a[:, :, None], b[:, :, None]
        pts = np.concatenate([(1.0 - t) * a + t * b, (1.0 - t) * b + t * a], -1)
        xs, ys = pts[:, 0].astype(np.int64), pts[:, 1].astype(np.int64)  # int(): toward 0
        inside = (xs >= 0) & (xs < self.x_width) & (ys >= 0) & (ys < self.y_width)
        hit = self.obstacle_map[np.where(inside, xs, 0), np.where(inside, ys, 0)]
        return (inside & ~hit).all(-1)

    def _line_of_sight(self, a: Coord, b: Coord) -> Optional[float]:
        """The segment's length when the probe finds it clear, else None."""
        if not self._clear(np.asarray([a]), np.asarray([b]))[0]:
            return None
        return math.hypot(a[0] - b[0], a[1] - b[1])

    def _key_points(self) -> List[Coord]:
        """Obstacle-corner extraction + LOS midpoints
        (a_star_variants.rs:349-425)."""
        offsets1 = ((1, 0), (0, 1), (-1, 0), (1, 0))
        offsets2 = ((1, 1), (-1, 1), (-1, -1), (1, -1))
        offsets3 = ((0, 1), (-1, 0), (0, -1), (0, -1))
        corners: List[Coord] = []
        for x in range(self.x_width):
            for y in range(self.y_width):
                if self._blocked(x, y):
                    continue
                empty = True
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        nx, ny = x + dx, y + dy
                        if self._contains(nx, ny) and self._blocked(nx, ny):
                            empty = False
                            break
                    if not empty:
                        break
                if empty:
                    continue
                for (i1, j1), (i2, j2), (i3, j3) in zip(offsets1, offsets2, offsets3):
                    n1 = (x + i1, y + j1)
                    n2 = (x + i2, y + j2)
                    n3 = (x + i3, y + j3)
                    if not (self._contains(*n1) and self._contains(*n2)
                            and self._contains(*n3)):
                        continue
                    count = (int(self._blocked(*n1)) + int(self._blocked(*n2))
                             + int(self._blocked(*n3)))
                    if count in (1, 3):
                        corners.append((x, y))
                        break
        if self.config.only_corners:
            return corners
        key_points = list(corners)
        pts = np.asarray(corners, np.int64).reshape(-1, 2)
        for x1, y1 in corners:
            clear = self._clear(np.broadcast_to([x1, y1], pts.shape), pts)
            for (x2, y2), ok in zip(corners, clear):
                if ok and (x1, y1) != (x2, y2):
                    key_points.append(((x1 + x2) // 2, (y1 + y2) // 2))
        return key_points

    def _farthest_point(self, x: int, y: int, dx: int, dy: int,
                        goal: Coord) -> Tuple[Coord, int, bool]:
        """Theta-like multi-cell stepping (a_star_variants.rs:427-460)."""
        step_x, step_y = dx, dy
        counter = 1
        got_goal = False
        while (not self._blocked(x + step_x, y + step_y)
               and counter < self.config.max_theta):
            step_x += dx
            step_y += dy
            counter += 1
            if (x + step_x, y + step_y) == goal:
                got_goal = True
                break
            if not self._contains(x + step_x, y + step_y):
                break
        return (x + step_x - 2 * dx, y + step_y - 2 * dy), counter, got_goal

    @staticmethod
    def _choose(open_set: List[Coord], nodes: Dict[Coord, _Node]) -> int:
        """Tie-break scan over the f-sorted open list: prefer lower g, then
        lower h among consecutive equal-f candidates
        (a_star_variants.rs:648-668)."""
        chosen = 0
        lowest_f = nodes[open_set[0]].fcost
        lowest_h = nodes[open_set[0]].hcost
        lowest_g = nodes[open_set[0]].gcost
        for cand in open_set[1:]:
            n = nodes[cand]
            if n.fcost == lowest_f and n.gcost < lowest_g:
                lowest_g = n.gcost
                chosen += 1
            elif n.fcost == lowest_f and n.gcost == lowest_g and n.hcost < lowest_h:
                lowest_h = n.hcost
                chosen += 1
            else:
                break
        return chosen

    def _build_path(self, nodes: Dict[Coord, _Node], goal: Coord) -> np.ndarray:
        pts = []
        cur: Optional[Coord] = goal
        while cur is not None:
            pts.append(self._pos(cur))
            cur = nodes[cur].pred
        pts.reverse()
        return np.asarray(pts, np.float64)

    def _update_node_cost(self, cand: Coord, no_valid_f: bool, *, threshold,
                          current, offset, weight, f_cost_list, nodes,
                          open_set) -> bool:
        """a_star_variants.rs:507-545."""
        current_cost = nodes[current].gcost
        node = nodes[cand]
        if not node.open:
            return no_valid_f
        g = offset + current_cost
        h = node.hcost * weight if weight is not None else node.hcost
        f = g + h
        if f < node.fcost and f <= threshold:
            f_cost_list.append(f)
            node.pred = current
            node.gcost = g
            node.fcost = f
            if not node.in_open_list:
                open_set.append(cand)
                node.in_open_list = True
        if threshold < f < node.fcost:
            no_valid_f = True
        return no_valid_f

    def _plan_grid_variant(self, start: Coord, goal: Coord) -> np.ndarray:
        """Shared loop for standard/beam/IDA/dynamic/theta modes
        (a_star_variants.rs:633-756)."""
        cfg = self.config
        nodes: Dict[Coord, _Node] = {}
        for x in range(self.x_width):
            for y in range(self.y_width):
                if self._is_valid(x, y):
                    nodes[(x, y)] = _Node(_heuristic((x, y), goal))
        sn = nodes[start]
        sn.gcost = 0.0
        sn.fcost = sn.hcost
        sn.in_open_list = True
        open_set: List[Coord] = [start]
        goal_found = False
        threshold = math.inf
        depth = 0
        no_valid_f = False

        while open_set:
            open_set.sort(key=lambda c: nodes[c].fcost)
            chosen = self._choose(open_set, nodes)
            if cfg.mode == "beam":
                while len(open_set) > cfg.beam_capacity:
                    open_set.pop()
            current = open_set[chosen]
            f_cost_list: List[float] = []
            weight = None
            if cfg.mode == "dynamic_weighting":
                weight = (1.0 + cfg.epsilon
                          - cfg.epsilon * depth / cfg.upper_bound_depth)

            for dx, dy, offset in _MOTION:
                reached_goal = False
                if cfg.mode == "theta_star_like":
                    cand, mult, reached_goal = self._farthest_point(
                        current[0], current[1], dx, dy, goal)
                    offset = offset * mult
                else:
                    cand = (current[0] + dx, current[1] + dy)
                if reached_goal:
                    nodes[goal].pred = current
                    goal_found = True
                    break
                if cand not in nodes:
                    continue
                if cand == goal:
                    nodes[goal].pred = current
                    goal_found = True
                    break
                no_valid_f = self._update_node_cost(
                    cand, no_valid_f, threshold=threshold, current=current,
                    offset=offset, weight=weight, f_cost_list=f_cost_list,
                    nodes=nodes, open_set=open_set)

            if goal_found:
                return self._build_path(nodes, goal)

            if cfg.mode == "iterative_deepening":
                threshold = min(f_cost_list) if f_cost_list else math.inf
                if not f_cost_list and no_valid_f:
                    cn = nodes[current]
                    cn.fcost = math.inf
                    cn.hcost = math.inf
                    continue

            cn = nodes[current]
            cn.open = False
            cn.in_open_list = False
            cn.fcost = math.inf
            cn.hcost = math.inf
            open_set.pop(chosen)
            depth += 1

        raise RuntimeError("no path found")

    def _plan_jump_point_corners(self, start: Coord, goal: Coord) -> np.ndarray:
        """Corner-graph search (a_star_variants.rs:547-630)."""
        nodes: Dict[Coord, _Node] = {}
        for p in self._key_points():
            if self._is_valid(*p) and p not in nodes:
                nodes[p] = _Node(_heuristic(p, goal))
        nodes[goal] = _Node(0.0)
        nodes[start] = _Node(_heuristic(start, goal))
        sn = nodes[start]
        sn.gcost = 0.0
        sn.fcost = sn.hcost
        sn.in_open_list = True
        open_set: List[Coord] = [start]
        while open_set:
            open_set.sort(key=lambda c: nodes[c].fcost)
            chosen = self._choose(open_set, nodes)
            current = open_set[chosen]
            for cand in list(nodes.keys()):
                if cand == current:
                    continue
                if math.hypot(current[0] - cand[0],
                              current[1] - cand[1]) > self.config.max_corner:
                    continue
                offset = self._line_of_sight(current, cand)
                if offset is None:
                    continue
                if cand == goal:
                    nodes[goal].pred = current
                    return self._build_path(nodes, goal)
                current_cost = nodes[current].gcost
                node = nodes[cand]
                if not node.open:
                    continue
                g = current_cost + offset
                f = g + node.hcost
                if f < node.fcost:
                    node.pred = current
                    node.gcost = g
                    node.fcost = f
                    if not node.in_open_list:
                        open_set.append(cand)
                        node.in_open_list = True
            cn = nodes[current]
            cn.open = False
            cn.in_open_list = False
            cn.fcost = math.inf
            cn.hcost = math.inf
            open_set.pop(chosen)
        raise RuntimeError("no path found")

    def plan(self, sx: float, sy: float, gx: float, gy: float) -> np.ndarray:
        """Plan start→goal; returns [N, 2] world-coordinate waypoints
        (a_star_variants.rs:758-788)."""
        start = (self._xi(sx), self._yi(sy))
        goal = (self._xi(gx), self._yi(gy))
        if not self._is_valid(*start):
            raise ValueError("start position is invalid")
        if not self._is_valid(*goal):
            raise ValueError("goal position is invalid")
        if self.config.mode == "jump_point_corners":
            return self._plan_jump_point_corners(start, goal)
        return self._plan_grid_variant(start, goal)


def path_length(path: np.ndarray) -> float:
    return float(np.sum(np.hypot(np.diff(path[:, 0]), np.diff(path[:, 1]))))
