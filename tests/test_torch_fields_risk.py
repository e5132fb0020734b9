"""Fields, frontier exploration, the risk graph, coverage and road maps
(`planning/{fields,frontier,risk_graph,coverage,roadmap}.py`) against the
JAX package's: JAX on the CPU at x64, torch in float64 on the CPU.

Tolerances: masks, cells, paths, counts and flags exactly; float64 fields
at 1e-12 (0 measured: the wavefront fields are sums of the same step costs
in the same order; `hypot` and `jnp.linalg.norm` round as the port's
`_numeric.hypot` and `norm2` do). A jitted XLA may fuse the risk
stencil's `dw + rw·r` into one multiply-add, an ulp from the port's two
roundings, so the greedy walks that argmin over a risk field run on worlds
with seeded noise in the risk, where no two moves tie. The worlds are those
of tests/test_frenet_fields.py, test_breadth_planners.py,
test_chomp_risk.py, test_coverage_eta3.py and test_round2_batch.py (risk
worlds at 16 x 16, so that JAX compiles each shape once), and seeded numpy
rasters. JAX's pure functions run under `jax.jit` (one compile, not one
per eager op), which gives the same bits here: a jitted division by a
number becomes a product by its reciprocal, so the Voronoi map's
resolution is a power of two.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import coverage as jc
from rust_robotics_tpu.planning import fields as jf
from rust_robotics_tpu.planning import frontier as jfr
from rust_robotics_tpu.planning import risk_graph as jr
from rust_robotics_tpu.planning import roadmap as jm
from rust_robotics_tpu_torch.ops.wavefront_sweep import wavefront_relax
from rust_robotics_tpu_torch.planning import coverage as tc
from rust_robotics_tpu_torch.planning import fields as tf
from rust_robotics_tpu_torch.planning import frontier as tfr
from rust_robotics_tpu_torch.planning import risk_graph as tr
from rust_robotics_tpu_torch.planning import roadmap as tm

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
F64 = torch.float64

j_potential_field = jax.jit(jf.potential_field)
j_boustrophedon_sweep = jax.jit(jf.boustrophedon_sweep)
j_terrain_risk = jax.jit(jr.terrain_risk_from_elevation,
                         static_argnames=("cell_size", "max_risk", "blocking_step_height"))
j_plan_risk_path = jax.jit(jr.plan_risk_path, static_argnames=("risk_weight",))
j_namo_set_state = jax.jit(jr.namo_set_state, static_argnames=("state", "cfg"))
j_namo_update_movable = jax.jit(jr.namo_update_movable, static_argnames=(
    "commanded_speed", "actual_speed", "odom_delta", "cfg"))
j_build_prm = jax.jit(jm.build_prm, static_argnames=("num_samples", "connect_radius"))
j_shortest_path = jax.jit(jm.roadmap_shortest_path)
j_visibility_roadmap = jax.jit(jm.visibility_roadmap)
j_voronoi_roadmap = jax.jit(jm.voronoi_roadmap, static_argnames=(
    "min_x", "min_y", "resolution", "max_vertices"))


def close(got, want, atol=ATOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0.0)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@functools.lru_cache(maxsize=None)
def random_free(seed, w=20, h=20, p=0.2):
    rng = np.random.default_rng(seed)
    free = rng.random((w, h)) > p
    free[1, 1] = free[w - 2, h - 2] = True
    return free


def one_hot(shape, idx):
    g = np.zeros(shape, bool)
    g[idx] = True
    return g


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

def test_potential_field_and_descent_match_jax():
    blocked = np.zeros((30, 30), dtype=bool)
    blocked[12:18, 10:12] = True
    free = ~blocked
    want = j_potential_field(jnp.asarray(free), jnp.array([25, 15]))
    got = tf.potential_field(free, (25, 15), device="cpu", dtype=F64)
    close(got, want)  # the jitted sum fuses a product: 1.1e-13 apart
    want_path = jf.descend_field(jnp.asarray(got.numpy()), jnp.asarray(free), jnp.array([2, 15]),
                                 max_len=96)
    got_path = tf.descend_field(got, torch.tensor(free), (2, 15), max_len=96)
    for g, w in zip(got_path, want_path):
        exact(g, w)
    want = j_potential_field(jnp.asarray(free), jnp.array([3, 27]), obstacle_gain=40.0,
                             attract_gain=2.0, repulse_radius=3.5)
    close(tf.potential_field(free, (3, 27), obstacle_gain=40.0, attract_gain=2.0,
                             repulse_radius=3.5, device="cpu", dtype=F64), want)


def test_flow_field_boustrophedon_and_coverage_ratio_match_jax():
    free = np.stack([random_free(s) for s in range(3)])
    goals = np.stack([one_hot((20, 20), (10, 10)), one_hot((20, 20), (18, 18)),
                      one_hot((20, 20), (1, 1)) | one_hot((20, 20), (18, 1))])
    exact(tf.flow_field(free, goals, device="cpu", dtype=F64),
          jf.flow_field(jnp.asarray(free), jnp.asarray(goals)))
    field = tf.flow_field(free[0], goals[0], device="cpu", dtype=F64)
    for start in ((1, 1), (18, 18), (0, 19)):
        want = jf.descend_field(jnp.asarray(np.asarray(field)), jnp.asarray(free[0]),
                                jnp.asarray(start), max_len=64)
        for g, w in zip(tf.descend_field(field, torch.tensor(free[0]), start, max_len=64), want):
            exact(g, w)
    blocked = np.zeros((8, 6), dtype=bool)
    blocked[3, 1:5] = True
    cells, valid = tf.boustrophedon_sweep(~blocked, device="cpu")
    want_cells, want_valid = j_boustrophedon_sweep(jnp.asarray(~blocked))
    exact(cells, want_cells)
    exact(valid, want_valid)
    visited = np.random.default_rng(4).random((8, 6)) > 0.4
    assert float(tf.coverage_ratio(visited, ~blocked, device="cpu", dtype=F64)) == float(
        jf.coverage_ratio(jnp.asarray(visited), jnp.asarray(~blocked)))


# ---------------------------------------------------------------------------
# frontier exploration
# ---------------------------------------------------------------------------

def test_sense_reveal_frontiers_and_scores_match_jax():
    truth = np.zeros((20, 20), bool)
    truth[10, 8:13] = True  # a wall casts a shadow
    truth[4:6, 14] = True
    cfg = tfr.FrontierNavConfig()
    known_j = jnp.zeros((20, 20), jnp.int32)
    known_t = torch.zeros((20, 20), dtype=torch.int32)
    for pos, rng in (((5, 10), 8.0), ((12, 3), 6.0), ((15, 15), 5.5)):
        known_j, vis_j = jfr.sense_reveal(known_j, jnp.asarray(truth), jnp.array(pos), rng)
        known_t, vis_t = tfr.sense_reveal(known_t, torch.tensor(truth), pos, rng, dtype=F64)
        exact(known_t, known_j)
        exact(vis_t, vis_j)
    fr_j = jfr.find_frontiers(known_j)
    fr_t = tfr.find_frontiers(known_t)
    exact(fr_t, fr_j)
    assert 0 < int(fr_t.sum()) < 400
    travel = np.asarray(jf.flow_field(jnp.asarray(np.asarray(known_j) == 1),
                                      jnp.asarray(one_hot((20, 20), (15, 15)))))
    want = jfr.score_frontiers(known_j, fr_j, jnp.asarray(travel), vis_j, jnp.array([15, 15]),
                               jnp.array([2.0, 18.0]), cfg)
    got = tfr.score_frontiers(known_t, fr_t, torch.tensor(travel), vis_t, (15, 15), (2.0, 18.0),
                              cfg)
    exact(got, want)


@pytest.mark.parametrize("world", ["wall gap", "random"])
def test_frontier_navigate_matches_jax(world):
    if world == "wall gap":  # tests/test_breadth_planners.py's world
        truth = np.zeros((24, 24), bool)
        truth[12, 0:18] = True
        start, goal = (4, 4), (20, 4)
        kw = dict(sensor_range=6.0, step_budget=5, max_episodes=400)
    else:
        truth = ~random_free(7, 24, 24, 0.15)
        truth[2, 2] = truth[21, 21] = False
        start, goal = (2, 2), (21, 21)
        kw = dict(sensor_range=4.0, step_budget=3, max_episodes=60, w_gain=1.0)
    want = jfr.frontier_navigate(truth, start, goal, jfr.FrontierNavConfig(**kw))
    got = tfr.frontier_navigate(truth, start, goal, tfr.FrontierNavConfig(**kw), device="cpu",
                                dtype=F64)
    assert set(got) == set(want)
    for key in ("trajectory", "frontiers_chosen"):
        exact(got[key], want[key])
    for key in ("reached", "episodes"):
        assert got[key] == want[key]
    close(got["revealed_fraction"], want["revealed_fraction"])
    assert len(want["frontiers_chosen"]) >= 1


# ---------------------------------------------------------------------------
# risk graph
# ---------------------------------------------------------------------------

def channels_j(r):
    return jr.RiskChannels(*(jnp.asarray(np.asarray(getattr(r, k)))
                             for k in ("blocked", "traversability", "stability", "exposure")))


def same_channels(got, want, check=exact):
    for k in ("blocked", "traversability", "stability", "exposure"):
        check(getattr(got, k), getattr(want, k))


def test_terrain_risk_smoothing_clearance_and_exposure_match_jax():
    rng = np.random.default_rng(1)
    z = np.zeros((16, 16))
    z[8:, :] = 2.0  # a step: slope + roughness at the edge (tests/test_chomp_risk.py)
    z = z + 0.3 * rng.normal(size=z.shape)
    for kw in (dict(blocking_step_height=1.5), dict(cell_size=0.5, max_risk=4.0)):
        want = j_terrain_risk(jnp.asarray(z), **kw)
        got = tr.terrain_risk_from_elevation(z, device="cpu", dtype=F64, **kw)
        same_channels(got, want)
        for skw in (dict(), dict(iterations=2, sigma_cells=0.7, smooth_blocked_cells=True)):
            same_channels(tr.smooth_terrain_risk(got, **skw), jr.smooth_terrain_risk(want, **skw))
    assert bool(got.blocked.any()) is False and bool(
        tr.terrain_risk_from_elevation(z, blocking_step_height=1.5, device="cpu").blocked.any())
    blocked = np.zeros((16, 16), bool)
    blocked[5, 5] = blocked[0, 3] = blocked[12, 9] = True
    exact(tr.clearance_map(blocked, 0.5, device="cpu", dtype=F64),
          jr.clearance_map(jnp.asarray(blocked), 0.5))
    exact(tr.clearance_map(np.zeros((16, 16), bool), device="cpu", dtype=F64),
          jr.clearance_map(jnp.zeros((16, 16), bool)))
    for r in (1, 3):
        exact(tr.inflate_blocked_cells(blocked, r, device="cpu"),
              jr.inflate_blocked_cells(jnp.asarray(blocked), r))
    risk = tr.RiskChannels(torch.tensor(blocked), torch.tensor(rng.uniform(0, 2, (16, 16))),
                           torch.tensor(rng.uniform(0, 1, (16, 16))), torch.zeros(16, 16, dtype=F64))
    for kw in (dict(minimum_clearance=3.0, risk_scale=6.0),
               dict(cell_size=0.4, minimum_clearance=2.5, risk_scale=9.0, max_risk=4.0,
                    additive=False)):
        got = tr.add_clearance_exposure_risk(risk, **kw)
        want = jr.add_clearance_exposure_risk(channels_j(risk), **kw)
        same_channels(got, want)
    exact(tr.combined_cell_risk(got, 0.5, 2.0, 3.0), jr.combined_cell_risk(want, 0.5, 2.0, 3.0))


def corridor_risk():
    """tests/test_chomp_risk.py's risky band with a zero-risk corridor,
    plus seeded noise so that no two routes tie."""
    w = h = 16
    blocked = np.zeros((w, h), bool)
    trav = np.zeros((w, h))
    trav[:, 4:11] = 4.0
    trav[7, 4:11] = 0.0
    blocked[6, 4:11] = True
    trav = trav + np.random.default_rng(2).uniform(0.0, 0.5, (w, h))
    zeros = np.zeros((w, h))
    return tr.RiskChannels(*(torch.tensor(a) for a in (blocked, trav, zeros, zeros)))


@pytest.mark.parametrize("risk_weight", [0.0, 0.7, 10.0])
def test_plan_risk_path_matches_jax(risk_weight):
    risk = corridor_risk()
    got = tr.plan_risk_path(risk, (7, 0), (7, 15), risk_weight=risk_weight)
    want = j_plan_risk_path(channels_j(risk), jnp.array([7, 0]), jnp.array([7, 15]),
                            risk_weight=risk_weight)
    for g, w in zip(got[:2], want[:2]):
        exact(g, w)
    close(got[2], want[2])


def test_risk_wavefront_costs_and_sweep_match_jax():
    risk = corridor_risk()
    free = ~risk.blocked
    cr = tr.combined_cell_risk(risk)
    goals = torch.tensor(one_hot((16, 16), (7, 15)))
    args = (jnp.asarray(free.numpy()), jnp.asarray(cr.numpy()), jnp.asarray(goals.numpy()))
    for kw in (dict(distance_weight=0.5, risk_weight=2.0),
               dict(allow_diagonal=False, max_iters=16, block=4)):
        close(tr.risk_wavefront_costs(free, cr, goals, dtype=F64, **kw),
              jr.risk_wavefront_costs(*args, **kw))
    weights = [0.0, 1.0, 4.0, 0.3]
    got = tr.sweep_risk_weights(risk, (0, 0), (15, 15), weights)
    want = jr.sweep_risk_weights(channels_j(risk), (0, 0), (15, 15), weights)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g["risk_weight"] == w["risk_weight"]
        close(g["cost"], w["cost"])
        exact(g["path_idx"], w["path_idx"])
        exact(g["path_mask"], w["path_mask"])
        if k in (1, 3):  # a lane of the batched walk is its solo walk
            field = tr.risk_wavefront_costs(free, cr, torch.tensor(one_hot((16, 16), (15, 15))),
                                            1.0, g["risk_weight"], dtype=F64)
            exact(tr.extract_risk_path(field, free, cr, (0, 0), 1.0, g["risk_weight"])[0],
                  g["path_idx"])


def test_namo_costmap_matches_jax():
    cfg = jr.NamoConfig()
    want = jr.namo_new(10, 10)
    got = tr.namo_new(10, 10, device="cpu", dtype=F64)
    wall = np.array([(5, y) for y in range(9)])
    door = np.array([[5, 9], [2, 2], [5, 9]])
    want = j_namo_set_state(want, jnp.asarray(wall), jr.NAMO_STATIC, cfg)
    got = tr.namo_set_state(got, wall, tr.NAMO_STATIC)
    for state in (jr.NAMO_MOVABLE, jr.NAMO_UNKNOWN, jr.NAMO_FREE):
        cells = door[:1] if state == jr.NAMO_MOVABLE else np.array([[1 + state, 7]])
        want = j_namo_set_state(want, jnp.asarray(cells), state, cfg)
        got = tr.namo_set_state(got, cells, state)
    for args in ((0.5, 0.01, 0.0), (0.5, 0.01, 0.0), (0.5, 0.01, 0.0), (0.5, 0.4, 1.0),
                 (0.01, 0.0, 0.0), (0.5, 0.4, 1.0), (0.5, 0.4, 1.0)):
        speeds = dict(zip(("commanded_speed", "actual_speed", "odom_delta"), args))
        want, n_want = j_namo_update_movable(want, jnp.asarray(door), cfg=cfg, **speeds)
        got, n_got = tr.namo_update_movable(got, door, *args)
        exact(got[0], want[0])
        exact(got[1], want[1])
        assert int(n_got) == int(n_want)
    for block in (True, False):
        same_channels(tr.namo_to_risk(got, block), jr.namo_to_risk(want, block))


# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------

COVERAGE_CONFIGS = [dict(), dict(distance_type="euclidean"),
                    dict(transform_type="path", alpha=0.5)]


@pytest.mark.parametrize("cfg", COVERAGE_CONFIGS, ids=["chessboard", "euclidean", "path"])
def test_wavefront_cpp_matches_jax(cfg):
    blocked = ~random_free(3, 16, 16, 0.15)
    blocked[0, 0] = blocked[15, 15] = False
    got_t = tc.coverage_transform(blocked, (15, 15), tc.WavefrontCppConfig(**cfg), device="cpu",
                                  dtype=F64)
    close(got_t, jc.coverage_transform(blocked, (15, 15), jc.WavefrontCppConfig(**cfg)))
    got, covered = tc.wavefront_cpp(blocked, (0, 0), (15, 15), tc.WavefrontCppConfig(**cfg),
                                    device="cpu", dtype=F64)
    want, want_covered = jc.wavefront_cpp(blocked, (0, 0), (15, 15), jc.WavefrontCppConfig(**cfg))
    exact(got, want)
    assert covered == want_covered
    assert tc.coverage_metrics(got, blocked) == jc.coverage_metrics(want, blocked)


def test_obstacle_distance_spiral_stc_and_spiral_match_jax():
    blocked = ~random_free(5, 12, 10, 0.1)
    exact(tc.obstacle_distance_transform(blocked, device="cpu", dtype=F64),
          jc.obstacle_distance_transform(jnp.asarray(blocked)))
    exact(tc.obstacle_distance_transform(np.zeros((4, 4), bool), device="cpu", dtype=F64),
          jc.obstacle_distance_transform(jnp.zeros((4, 4), bool)))
    exact(tc.spiral_coverage(blocked, (1, 1)), jc.spiral_coverage(blocked, (1, 1)))
    exact(tc.spiral_coverage(np.zeros((6, 6), bool), (0, 0)),
          jc.spiral_coverage(np.zeros((6, 6), bool), (0, 0)))
    free = np.ones((12, 12), bool)
    free[4, 4] = free[9, 2] = free[7, 10] = False
    for f, start in ((free, (0, 0)), (np.ones((8, 8), bool), (2, 1))):
        got, want = tc.spiral_stc_plan(f, start), jc.spiral_stc_plan(f, start)
        assert got["edges"] == want["edges"]
        exact(got["route"], want["route"])
        exact(got["path_segments"], want["path_segments"])


# ---------------------------------------------------------------------------
# road maps
# ---------------------------------------------------------------------------

def test_prm_matches_jax_with_its_draws():
    key = jax.random.PRNGKey(3)
    obstacles = np.array([[5.0, 5.0], [5.0, 3.0], [5.0, 7.0]])
    radii = np.array([1.2, 1.2, 1.2])
    kw = dict(num_samples=120, connect_radius=2.5)
    draws = np.asarray(jax.random.uniform(key, (120, 2)))
    verts, w = tm.build_prm(None, [1.0, 5.0], [9.0, 5.0], obstacles, radii, draws=draws,
                            device="cpu", dtype=F64, **kw)
    want_verts, want_w = j_build_prm(key, jnp.array([1.0, 5.0]), jnp.array([9.0, 5.0]),
                                     jnp.asarray(obstacles), jnp.asarray(radii), **kw)
    exact(verts, want_verts)
    exact(w, want_w)
    want_cost, want_dist = j_shortest_path(want_w)
    want = (*jm.extract_roadmap_path(want_verts, want_w, want_dist), want_cost)  # prm_plan
    got = tm.prm_plan(None, [1.0, 5.0], [9.0, 5.0], obstacles, radii, draws=draws, device="cpu",
                      dtype=F64, **kw)
    for g, x in zip(got, want):
        exact(g, x)
    assert 8.2 < float(got[2]) < 1e17
    gen = torch.Generator().manual_seed(0)
    verts, _ = tm.build_prm(gen, [1.0, 5.0], [9.0, 5.0], obstacles, radii, device="cpu", **kw)
    assert verts.shape == (122, 2) and bool(((verts >= 0) & (verts <= 10)).all())


def test_visibility_roadmap_matches_jax():
    obstacles = np.array([[5.0, 5.0], [3.0, 7.5], [7.0, 2.0]])
    radii = np.array([1.5, 0.8, 1.0])
    want = j_visibility_roadmap(jnp.array([1.0, 5.0]), jnp.array([9.0, 5.0]),
                                jnp.asarray(obstacles), jnp.asarray(radii))
    got = tm.visibility_roadmap([1.0, 5.0], [9.0, 5.0], obstacles, radii, device="cpu",
                                dtype=F64)
    close(got[0], want[0])  # cos and sin may round an ulp apart
    exact(got[1] < 1e17, np.asarray(want[1]) < 1e17)
    close(got[1], want[1])
    cost, dist = tm.roadmap_shortest_path(got[1])
    want_cost, want_dist = j_shortest_path(want[1])
    close(dist, want_dist)
    assert 8.0 < float(cost) < 1e17
    pts, mask = tm.extract_roadmap_path(got[0], got[1], dist)
    want_pts, want_mask = jm.extract_roadmap_path(want[0], want[1], want_dist)
    exact(mask, want_mask)
    close(pts, want_pts)


@pytest.mark.parametrize("geometry", [(0.0, 0.0, 1.0), (-2.0, -1.0, 0.5)])
def test_voronoi_roadmap_matches_jax(geometry):
    min_x, min_y, res = geometry
    blocked = np.zeros((40, 40), dtype=bool)
    blocked[:, :3] = True
    blocked[:, 37:] = True  # corridor walls along y (tests/test_round2_batch.py)
    blocked[18:22, 15:20] = True
    start = [min_x + 2.0 * res, min_y + 20.3 * res]
    goal = [min_x + 38.0 * res, min_y + 20.3 * res]
    want = j_voronoi_roadmap(jnp.asarray(start), jnp.asarray(goal), jnp.asarray(blocked),
                             min_x=min_x, min_y=min_y, resolution=res, max_vertices=96)
    got = tm.voronoi_roadmap(start, goal, blocked, min_x, min_y, res, max_vertices=96,
                             device="cpu", dtype=F64)
    exact(got[0], want[0])
    exact(got[1], want[1])
    assert int((np.asarray(want[1]) < 1e17).sum()) > 200


@pytest.mark.cuda
def test_flow_field_and_coverage_transform_cuda_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    free = np.stack([random_free(s, 48, 40) for s in range(3)])
    goals = np.zeros_like(free)
    goals[:, 46, 38] = True
    blocked = ~free[0]
    blocked[1, 1] = blocked[46, 38] = False
    cfg = tc.WavefrontCppConfig(distance_type="euclidean")
    for dtype in (torch.float32, F64):
        calls = (lambda dev: tf.flow_field(free, goals, device=dev, dtype=dtype),
                 lambda dev: tc.coverage_transform(blocked, (46, 38), cfg, device=dev, dtype=dtype),
                 lambda dev: tc.obstacle_distance_transform(blocked, device=dev, dtype=dtype))
        for call in calls:
            want = call("cpu")
            wavefront_relax.launches = 0
            got = call("cuda")
            torch.cuda.synchronize()
            assert wavefront_relax.launches == 1
            assert torch.equal(got.cpu(), want)
