"""The grid-search family (`planning/smoothing.py`, `jps.py`,
`incremental.py`, `grid3d.py`) against the JAX package's, on numpy
rasters made from a seed: JAX on the CPU at x64, torch in float64 on the
CPU.

Tolerances: every cost is a sum of the same step costs (1, √2, √3) in the
same order of relaxation, so fields are held at 1e-12 (0 measured); every
stats count (sweeps, RAISE/LOWER sweeps, IDA* deepenings, expanded cells,
jump edges) and every path index and keep mask exactly. The smoothed
paths and shortcut lengths are sums of square roots of the same
coordinates, held at 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import grid3d as jg3
from rust_robotics_tpu.planning import incremental as ji
from rust_robotics_tpu.planning import jps as jj
from rust_robotics_tpu.planning import smoothing as js
from rust_robotics_tpu.planning.wavefront import extract_path as j_extract_path
from rust_robotics_tpu.planning.wavefront import wavefront_costs as j_wavefront_costs
from rust_robotics_tpu_torch.planning import grid3d as tg3
from rust_robotics_tpu_torch.planning import incremental as ti
from rust_robotics_tpu_torch.planning import jps as tj
from rust_robotics_tpu_torch.planning import smoothing as ts
from rust_robotics_tpu_torch.planning.wavefront import wavefront_costs

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
F64 = torch.float64


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@functools.lru_cache(maxsize=None)
def random_free(seed, w=24, h=20, p=0.22):
    rng = np.random.default_rng(seed)
    free = rng.random((w, h)) > p
    free[1, 1] = free[w - 2, h - 2] = True
    return free


def one_hot(shape, idx):
    g = np.zeros(shape, bool)
    g[idx] = True
    return g


def wall_world(w=24, h=24):
    """tests/test_incremental_grid3d.py's world: a wall with a gap."""
    free = np.ones((w, h), bool)
    free[10, 2:20] = False
    return free


# ---------------------------------------------------------------------------
# smoothing
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def smoothing_case(seed):
    """A grid path (wavefront + descent) on a 32x32 raster at 0.5 m."""
    free = random_free(seed, 32, 32, 0.18)
    goals = jnp.asarray(one_hot(free.shape, (30, 30)))
    costs = j_wavefront_costs(jnp.asarray(free), goals)
    idx, mask, _ = j_extract_path(costs, jnp.asarray(free), jnp.array([1, 1]), max_len=96)
    pts = -3.0 + (np.asarray(idx, np.float64) + 0.5) * 0.5
    return ~free, pts, np.asarray(mask, np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_shortcut_path_matches_jax(seed):
    blocked, pts, mask = smoothing_case(seed)
    keep, total = js.shortcut_path(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(blocked),
                                   jnp.asarray(-3.0), jnp.asarray(-3.0), 0.5)
    got_keep, got_total = ts.shortcut_path(torch.tensor(pts), torch.tensor(mask),
                                           torch.tensor(blocked), -3.0, -3.0, 0.5)
    exact(got_keep, keep)
    close(got_total, total)
    assert int(np.asarray(keep).sum()) < int(mask.sum())


def test_line_of_sight_and_relax_path_match_jax():
    blocked, pts, mask = smoothing_case(0)
    jargs = (jnp.asarray(blocked), jnp.asarray(-3.0), jnp.asarray(-3.0), 0.5)
    targs = (torch.tensor(blocked), -3.0, -3.0, 0.5)
    rng = np.random.default_rng(7)
    p0, p1 = rng.uniform(-3.0, 13.0, (2, 40, 2))
    want = js.line_of_sight_free(jnp.asarray(p0), jnp.asarray(p1), *jargs, samples=33)
    got = ts.line_of_sight_free(torch.tensor(p0), torch.tensor(p1), *targs, samples=33)
    exact(got, want)
    assert 0 < int(np.asarray(want).sum()) < 40
    want = js.relax_path(jnp.asarray(pts), jnp.asarray(mask), *jargs, iterations=12)
    got = ts.relax_path(torch.tensor(pts), torch.tensor(mask), *targs, iterations=12)
    close(got, want)
    assert np.abs(np.asarray(want) - pts).max() > 0.01


# ---------------------------------------------------------------------------
# JPS
# ---------------------------------------------------------------------------

def test_jump_point_mask_and_distances_match_jax():
    free = random_free(3)
    goal = (20, 15)
    gm = one_hot(free.shape, goal)
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        exact(tj.jump_point_mask(torch.tensor(free), dx, dy),
              jj.jump_point_mask(jnp.asarray(free), dx, dy))
    want = jj.jump_distances(jnp.asarray(free), jnp.asarray(gm))
    got = tj.jump_distances(torch.tensor(free), torch.tensor(gm), F64)
    assert sorted(got) == sorted(want)
    for key in want:
        exact(got[key], want[key])


@pytest.mark.parametrize("seed", [0, 4])
def test_jps_costs_and_plan_match_jax(seed):
    free = random_free(seed)
    start, goal = (1, 1), (free.shape[0] - 2, free.shape[1] - 2)
    cost, costs, stats = jj.jps_costs(jnp.asarray(free), jnp.asarray(start), jnp.asarray(goal))
    got_cost, got_costs, got_stats = tj.jps_costs(torch.tensor(free), start, goal, dtype=F64)
    close(got_cost, cost)
    close(got_costs, costs)
    for key in ("jump_edges", "cell_edges", "sweeps"):
        assert int(got_stats[key]) == int(stats[key]), key
    assert tj.jps_plan(free, start, goal, device="cpu", dtype=F64) == jj.jps_plan(
        free, start, goal)
    # JPS's cost equals the port's own wavefront optimum
    field = wavefront_costs(torch.tensor(free), torch.tensor(one_hot(free.shape, goal)),
                            dtype=F64)
    close(got_cost, field[start])


# ---------------------------------------------------------------------------
# incremental
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("connectivity", [8, 4])
def test_relax_with_stats_matches_jax(connectivity):
    free = random_free(1)
    goals = one_hot(free.shape, (22, 18))
    kw = dict(connectivity=connectivity)
    want, want_sweeps = ji.relax_with_stats(jnp.full(free.shape, jnp.inf), jnp.asarray(free),
                                            jnp.asarray(goals), **kw)
    got, sweeps = ti.relax_with_stats(torch.full(free.shape, torch.inf, dtype=F64),
                                      torch.tensor(free), torch.tensor(goals), **kw)
    close(got, want)
    assert sweeps == int(want_sweeps) > 16
    # capped, from a warm field
    warm = np.where(np.isfinite(np.asarray(want)), np.asarray(want) + 0.5, np.inf)
    want, want_sweeps = ji.relax_with_stats(jnp.asarray(warm), jnp.asarray(free),
                                            jnp.asarray(goals), max_sweeps=16, **kw)
    got, sweeps = ti.relax_with_stats(torch.tensor(warm), torch.tensor(free),
                                      torch.tensor(goals), max_sweeps=16, **kw)
    close(got, want)
    assert sweeps == int(want_sweeps) == 16


@pytest.mark.parametrize("edit", ["add", "remove", "batch"])
def test_repair_costs_matches_jax(edit):
    free = wall_world()
    goals = one_hot(free.shape, (22, 22))
    d0 = np.asarray(ji.relax_with_stats(jnp.full(free.shape, jnp.inf), jnp.asarray(free),
                                        jnp.asarray(goals))[0])
    free2 = free.copy()
    if edit == "remove":
        free2[10, :] = True
    else:
        free2[10, 20:23] = False
    if edit == "batch":  # three maps in lock-step, two of them edited
        free_b = np.stack([free2, free, random_free(2, 24, 24) | ~free])
        d0 = np.stack([d0] * 3)
        goals = np.stack([goals] * 3)
        free2 = free_b
    want = ji.repair_costs(jnp.asarray(d0), jnp.asarray(free2), jnp.asarray(goals))
    got = ti.repair_costs(torch.tensor(d0), torch.tensor(free2), torch.tensor(goals))
    close(got[0], want[0])
    assert (got[1], got[2]) == (int(want[1]), int(want[2]))
    for jf, tf in ((ji.dstar_lite_replan, ti.dstar_lite_replan),
                   (ji.lpa_star_replan, ti.lpa_star_replan),
                   (ji.dstar_replan, ti.dstar_replan)):
        g = tf(torch.tensor(d0), torch.tensor(free2), torch.tensor(goals))
        assert torch.equal(g[0], got[0]) and g[1:] == got[1:], jf.__name__


def test_ara_star_matches_jax():
    free = wall_world()
    want = ji.ara_star_plan(jnp.asarray(free), jnp.array([1, 1]), jnp.array([22, 22]),
                            stages=3, sweeps_per_stage=8)
    got = ti.ara_star_plan(torch.tensor(free), (1, 1), (22, 22), stages=3,
                           sweeps_per_stage=8, dtype=F64)
    for g, w in zip(got, want):
        close(g, w)
    assert np.isinf(np.asarray(want[1])[0]) and np.isfinite(np.asarray(want[1])[-1])


@pytest.mark.parametrize("case", ["wall", "random", "unreachable"])
def test_ida_star_matches_jax(case):
    """8-connected, JAX's IDA* runs eagerly (`jax.disable_jit`): under
    `jax.jit` XLA contracts the octile heuristic's multiply-add into one
    FMA, whose rounding moves `g + h <= threshold` on cells where it holds
    with equality, and with it the number of deepenings (27 against 28 on
    the 24x24 wall world of `wall_world`). The 4-connected heuristic has no
    product, and those cases run under `jax.jit`."""
    if case == "unreachable":
        free = np.ones((12, 12), bool)
        free[6, :] = False
        start, goal, kw = (1, 1), (10, 10), dict(max_deepenings=16, connectivity=4)
    elif case == "wall":  # a detour round the wall's end
        free, start, goal, kw = wall_world(), (1, 12), (22, 12), dict(connectivity=4)
    else:
        free = random_free(5, 14, 12)
        start, goal, kw = (1, 1), (free.shape[0] - 2, free.shape[1] - 2), {}
    with jax.disable_jit(kw.get("connectivity", 8) == 8):
        want = ji.ida_star_costs(jnp.asarray(free), jnp.asarray(start), jnp.asarray(goal), **kw)
    got = ti.ida_star_costs(torch.tensor(free), start, goal, dtype=F64, **kw)
    close(got[0], want[0])
    close(got[1], want[1])
    for key in ("deepenings", "expanded_cells"):
        assert int(got[2][key]) == int(want[2][key]), key
    close(got[2]["final_threshold"], want[2]["final_threshold"])
    assert int(want[2]["deepenings"]) > 1
    f = ti.fringe_search_costs(torch.tensor(free), start, goal, dtype=F64, **kw)
    assert torch.equal(f[0], got[0]) and f[2]["deepenings"] == got[2]["deepenings"]


@pytest.mark.parametrize("beam_width", [8, 24, 576])
def test_beam_search_and_octile_match_jax(beam_width):
    free = wall_world()
    goals = one_hot(free.shape, (22, 22))
    for conn in (8, 4):
        exact(ti.octile_heuristic(free.shape, (1, 1), conn, device="cpu", dtype=F64),
              ji.octile_heuristic(free.shape, jnp.array([1, 1]), conn))
    hmap = ji.octile_heuristic(free.shape, jnp.array([1, 1]))
    want, want_sweeps = ji.beam_search_costs(jnp.asarray(free), jnp.asarray(goals), hmap,
                                             beam_width=beam_width)
    got, sweeps = ti.beam_search_costs(torch.tensor(free), torch.tensor(goals),
                                       torch.tensor(np.asarray(hmap)), beam_width=beam_width)
    close(got, want)
    assert sweeps == int(want_sweeps)


# ---------------------------------------------------------------------------
# 3-D grids
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def voxels(seed, n=8, p=0.2):
    free = np.random.default_rng(seed).random((n, n, n)) > p
    free[0, 0, 0] = free[n - 1, n - 1, n - 1] = True
    return free


@pytest.mark.parametrize("connectivity", [26, 6])
def test_grid3d_matches_jax(connectivity):
    free = voxels(0)
    goal = (7, 7, 7)
    goals = one_hot(free.shape, goal)
    want = jg3.wavefront_costs_3d(jnp.asarray(free), jnp.asarray(goals),
                                  connectivity=connectivity)
    got = tg3.wavefront_costs_3d(torch.tensor(free), torch.tensor(goals),
                                 connectivity=connectivity, dtype=F64)
    close(got, want)
    w_idx, w_mask, w_cost = jg3.extract_path_3d(want, jnp.asarray(free), jnp.array([0, 0, 0]),
                                                max_len=40, connectivity=connectivity)
    g_idx, g_mask, g_cost = tg3.extract_path_3d(got, torch.tensor(free), (0, 0, 0), max_len=40,
                                                connectivity=connectivity)
    exact(g_idx, w_idx)
    exact(g_mask, w_mask)
    close(g_cost, w_cost)
    plan = tg3.plan_grid_3d(free, (0, 0, 0), goal, connectivity=connectivity, max_len=40,
                            device="cpu", dtype=F64)
    want_plan = jg3.plan_grid_3d(jnp.asarray(free), jnp.array([0, 0, 0]), goal,
                                 connectivity=connectivity, max_len=40)
    for g, w in zip(plan, want_plan):
        close(g, w)


@pytest.mark.cuda
def test_relax_with_stats_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    free = random_free(1, 64, 48)
    goals = one_hot(free.shape, (62, 46))
    args = (torch.full(free.shape, torch.inf), torch.tensor(free), torch.tensor(goals))
    want, want_sweeps = ti.relax_with_stats(*args)
    got, sweeps = ti.relax_with_stats(*(a.cuda() for a in args))
    assert sweeps == want_sweeps
    assert torch.equal(got.cpu(), want)
