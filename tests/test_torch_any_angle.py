"""The MovingAI loader (`data/moving_ai.py`), the A* variants
(`planning/a_star_variants.py`) and the any-angle planners
(`planning/any_angle.py`) against the JAX package's: JAX on the CPU at x64,
torch in float64 on the CPU.

Tolerances: the parsers, the A* variants' paths (host float64 in both),
corners, visibility matrices, corner masks, Theta* parents and every path
exactly; visibility lengths and Theta* fields at 1e-12 (0 measured: the
port rounds lengths as `jnp.linalg.norm` does, `_numeric.norm2`).

The reference's MovingAI maps and golden CSVs are not in the repository;
the loader is held on map and scenario text written here, and the A*
variants on the reference's 50×50 wall maze, built as
tests/test_a_star_variants_golden.py builds it.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.data import moving_ai as jmai
from rust_robotics_tpu.planning import a_star_variants as jav
from rust_robotics_tpu.planning import any_angle as jaa
from rust_robotics_tpu_torch.data import moving_ai as tmai
from rust_robotics_tpu_torch.planning import a_star_variants as tav
from rust_robotics_tpu_torch.planning import any_angle as taa
from test_a_star_variants_golden import build_pythonrobotics_maze

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
F64 = torch.float64


def close(got, want, atol=ATOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0.0)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# MovingAI loader
# ---------------------------------------------------------------------------

MAP_TEXT = """type octile
height 5
width 7
map
.......
.@@T...
.@.O.G.
..S.W@.
@......
"""

SCEN_TEXT = """version 1

0\tmaze.map\t7\t5\t0\t0\t6\t4\t7.82842712
1\tmaze.map\t7\t5\t2\t2\t6\t0\t4.41421356
3 maze.map 7 5 4 3 0 0 5.23606797
"""

BAD_MAPS = {
    "type": MAP_TEXT.replace("octile", "hex"),
    "marker": MAP_TEXT.replace("\nmap\n", "\nmab\n"),
    "short body": MAP_TEXT.replace("height 5", "height 6"),
    "row width": MAP_TEXT.replace(".......\n.@@T", "......\n.@@T"),
    "tile": MAP_TEXT.replace(".@.O.G.", ".@.X.G."),
}


def test_moving_ai_parsers_match_jax(tmp_path):
    want = jmai._parse_map_py(MAP_TEXT)
    got = tmai.parse_map(MAP_TEXT)
    assert (got.width, got.height) == (want.width, want.height) == (7, 5)
    exact(got.tiles, want.tiles)
    exact(got.passable(), want.passable())
    want_s = jmai._parse_scenarios_py(SCEN_TEXT)
    got_s = tmai.parse_scenarios(SCEN_TEXT)
    assert [dataclasses.astuple(s) for s in got_s] == [dataclasses.astuple(s) for s in want_s]
    assert len(got_s) == 3
    (tmp_path / "m.map").write_text(MAP_TEXT)
    (tmp_path / "m.scen").write_text(SCEN_TEXT)
    exact(tmai.load_map(tmp_path / "m.map").tiles, want.tiles)
    assert tmai.load_scenarios(tmp_path / "m.scen") == got_s
    assert got.planning_point(3, 2) == want.planning_point(3, 2) == (4.0, 3.0)


@pytest.mark.parametrize("case", sorted(BAD_MAPS) + ["scenario row"])
def test_moving_ai_rejects_what_jax_rejects(case):
    if case == "scenario row":
        parsers = (jmai._parse_scenarios_py, tmai.parse_scenarios)
        text = "0 maze.map 7 5 0 0 6 4\n"
    else:
        parsers, text = (jmai._parse_map_py, tmai.parse_map), BAD_MAPS[case]
    for parse in parsers:
        with pytest.raises(ValueError):
            parse(text)


def test_moving_ai_to_grid_matches_jax():
    want = jmai._parse_map_py(MAP_TEXT).to_grid()
    got = tmai.parse_map(MAP_TEXT).to_grid(device="cpu", dtype=F64)
    exact(got.blocked, want.blocked)
    assert got.blocked.shape == (8, 6)
    for name in ("min_x", "min_y", "resolution"):
        assert float(getattr(got, name)) == float(getattr(want, name))


# ---------------------------------------------------------------------------
# A* variants, every mode on the reference's 50x50 maze
# ---------------------------------------------------------------------------

MAZE = build_pythonrobotics_maze()


@functools.lru_cache(maxsize=None)
def jax_variant_path(mode):
    ox, oy = MAZE
    return jav.AStarVariantPlanner(ox, oy, jav.AStarVariantConfig(mode=mode)).plan(
        5.0, 5.0, 35.0, 45.0)


@pytest.mark.parametrize("mode", tav.MODES)
def test_a_star_variant_matches_jax(mode):
    ox, oy = MAZE
    got = tav.AStarVariantPlanner(ox, oy, tav.AStarVariantConfig(mode=mode)).plan(
        5.0, 5.0, 35.0, 45.0)
    want = jax_variant_path(mode)
    assert got.shape == want.shape
    exact(got, want)
    assert tav.path_length(got) == jav.path_length(want)
    np.testing.assert_array_equal(got[[0, -1]], [[5.0, 5.0], [35.0, 45.0]])


def test_a_star_variant_key_points_and_rejections_match_jax():
    ox, oy = MAZE
    for only_corners in (False, True):
        cfg = dict(mode="jump_point_corners", only_corners=only_corners)
        got = tav.AStarVariantPlanner(ox[:400], oy[:400], tav.AStarVariantConfig(**cfg))
        want = jav.AStarVariantPlanner(ox[:400], oy[:400], jav.AStarVariantConfig(**cfg))
        exact(got.obstacle_map, want.obstacle_map)
        assert got._key_points() == want._key_points()
    inflated = tav.AStarVariantPlanner(ox, oy, tav.AStarVariantConfig(robot_radius=1.0))
    exact(inflated.obstacle_map,
          jav.AStarVariantPlanner(ox, oy, jav.AStarVariantConfig(robot_radius=1.0)).obstacle_map)
    for bad in (dict(beam_capacity=0), dict(resolution=-1.0), dict(max_theta=0),
                dict(mode="nope"), dict(epsilon=math.inf), dict(max_corner=0.0),
                dict(upper_bound_depth=0), dict(robot_radius=-1.0)):
        with pytest.raises(ValueError):
            jav.AStarVariantPlanner(ox, oy, jav.AStarVariantConfig(**bad))
        with pytest.raises(ValueError):
            tav.AStarVariantPlanner(ox, oy, tav.AStarVariantConfig(**bad))
    for args in (([], []), ([0.0, 1.0], [0.0]), ([0.0, math.nan], [0.0, 1.0])):
        with pytest.raises(ValueError):
            tav.AStarVariantPlanner(*args)
    planner = tav.AStarVariantPlanner(ox, oy)
    with pytest.raises(ValueError):
        planner.plan(0.0, 0.0, 35.0, 45.0)  # start on the boundary wall
    with pytest.raises(ValueError):
        planner.plan(5.0, 5.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# any-angle planners
# ---------------------------------------------------------------------------

def random_grid(rng, w=16, h=16, n_rects=5):
    """tests/test_any_angle.py's worlds: a few random rectangles."""
    blocked = np.zeros((w, h), bool)
    for _ in range(n_rects):
        x0 = rng.integers(2, w - 5)
        y0 = rng.integers(2, h - 5)
        dw = rng.integers(1, 4)
        dh = rng.integers(1, 4)
        blocked[x0:x0 + dw, y0:y0 + dh] = True
    return ~blocked


@functools.lru_cache(maxsize=None)
def grids(seed=3, n=3):
    rng = np.random.default_rng(seed)
    return tuple(random_grid(rng) for _ in range(n))


def test_corner_mask_points_and_vertices_match_jax():
    free = np.ones((7, 7), bool)
    free[3, 3] = False
    for f in (free,) + grids():
        exact(taa.corner_mask(f, device="cpu"), jaa.corner_mask(jnp.asarray(f)))
        exact(taa.corner_points(f, device="cpu"), jaa.corner_points(jnp.asarray(f)))
        exact(taa.corner_vertices(f), jaa.corner_vertices(jnp.asarray(f)))
        exact(taa.corner_vertices(torch.tensor(f), eps=0.01),
              jaa.corner_vertices(jnp.asarray(f), eps=0.01))
    assert set(map(tuple, np.argwhere(taa.corner_mask(free, device="cpu").numpy()))) == {
        (2, 2), (2, 4), (4, 2), (4, 4)}
    assert taa.corner_vertices(np.ones((4, 5), bool)).shape == (0, 2)


STARTS = np.array([[0, 0], [0, 15], [8, 0], [15, 0], [3, 9]])
GOALS = np.array([[15, 15], [15, 15], [3, 15], [0, 15], [12, 2]])


@functools.lru_cache(maxsize=None)
def jax_visibility(i):
    planner = jaa.VisibilityPlanner(jnp.asarray(grids()[i]), samples=128)
    lengths = np.asarray(planner.lengths(STARTS, GOALS))
    path = planner.path(STARTS[0], GOALS[0])
    return planner, lengths, path


@pytest.mark.parametrize("i", range(2))
def test_visibility_planner_matches_jax(i):
    want, lengths, path = jax_visibility(i)
    got = taa.VisibilityPlanner(grids()[i], samples=128, device="cpu", dtype=F64)
    exact(got.corners, want.corners)
    exact(got.vis, want.vis)
    exact(taa.visibility_matrix(got.corners, got.blocked, samples=128, tile=5), want.vis)
    got_lengths = got.lengths(STARTS, GOALS)
    close(got_lengths, lengths)
    # a lane of the batch is its solo run
    for k in range(len(STARTS)):
        exact(got.lengths(STARTS[k:k + 1], GOALS[k:k + 1]), got_lengths[k:k + 1])
    exact(got.path(STARTS[0], GOALS[0]), path)
    assert taa.dijkstra_visibility_oracle(grids()[i], STARTS[0], GOALS[0], samples=128,
                                          device="cpu", dtype=F64) == pytest.approx(
        float(lengths[0]), abs=1e-9)


def test_visibility_planner_capped_hops_empty_map_and_wall_match_jax():
    free = grids()[0]
    want = jaa.VisibilityPlanner(jnp.asarray(free), samples=128)
    got = taa.VisibilityPlanner(free, samples=128, device="cpu", dtype=F64)
    for hops in (1, 2, 9):
        close(got.lengths(STARTS, GOALS, max_hops=hops),
              want.lengths(STARTS, GOALS, max_hops=hops))
    empty = taa.VisibilityPlanner(np.ones((12, 12), bool), samples=64, device="cpu", dtype=F64)
    close(empty.lengths([[0, 0], [2, 3]], [[11, 11], [9, 4]]),
          jaa.VisibilityPlanner(jnp.ones((12, 12), bool), samples=64).lengths(
              jnp.asarray([[0, 0], [2, 3]]), jnp.asarray([[11, 11], [9, 4]])))
    wall = np.ones((8, 8), bool)
    wall[4, :] = False
    p = taa.VisibilityPlanner(wall, samples=64, device="cpu", dtype=F64)
    assert math.isinf(float(p.lengths([[0, 0]], [[7, 7]])[0]))
    assert p.path(np.array([0, 0]), np.array([7, 7])) is None


@functools.lru_cache(maxsize=None)
def jax_theta(i, goal, iters):
    g, parent = jaa.theta_wavefront_costs(jnp.asarray(grids()[i]), jnp.asarray(goal),
                                          iters=iters, samples=64)
    return np.asarray(g), np.asarray(parent)


@pytest.mark.parametrize("i,goal", [(0, (15, 15)), (1, (15, 15)), (2, (3, 12))])
def test_theta_wavefront_costs_matches_jax(i, goal):
    g, parent = taa.theta_wavefront_costs(grids()[i], goal, iters=256, samples=64,
                                          device="cpu", dtype=F64)
    want_g, want_parent = jax_theta(i, goal, 256)
    close(g, want_g)
    exact(parent, want_parent)
    assert np.isfinite(want_g).sum() > 100


def test_theta_wavefront_empty_map_is_euclidean():
    g, parent = taa.theta_wavefront_costs(np.ones((16, 16), bool), (15, 15), iters=128,
                                          samples=64, device="cpu", dtype=F64)
    assert float(g[0, 0]) == pytest.approx(math.hypot(15, 15), abs=1e-12)
    exact(parent[0, 0], [15.5, 15.5])
