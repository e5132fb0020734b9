"""Temporal, conformal and STL planning
(`planning/{temporal,conformal,stl}.py`) against the JAX package's: JAX on
the CPU at x64, torch in float64 on the CPU.

Tolerances: masks, paths, arrivals, counts and flags exactly; float64
fields and robustness values at 1e-12 (0 measured: the time-expanded
fields are sums of the same step costs; distances round as
`jnp.linalg.norm` and XLA's fused `dx² + dy²` do, `_numeric.norm2` and
`fma`). One property of the reference: `jnp.mean` of a bool array is
float32 even at x64, so JAX's confidence field holds float32 values; the
port's float64 field (count / episodes) is held to it within float32's
rounding of values in [0, 1] (3e-8), and its thresholded masks exactly.
The worlds are those of tests/test_temporal_mppi_variants.py,
test_conformal.py and test_stl_mapf.py, and seeded numpy rasters (maps of
at most 16², T <= 30, <= 4 agents).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import conformal as jcf
from rust_robotics_tpu.planning import stl as js
from rust_robotics_tpu.planning import temporal as jt
from rust_robotics_tpu_torch.planning import conformal as tcf
from rust_robotics_tpu_torch.planning import stl as ts
from rust_robotics_tpu_torch.planning import temporal as tt

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
F32_ROUNDING = 3e-8
F64 = torch.float64


def close(got, want, atol=ATOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0.0)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@functools.lru_cache(maxsize=None)
def world(seed=0, n=12, p=0.15):
    rng = np.random.default_rng(seed)
    free = rng.random((n, n)) > p
    free[0, 0] = free[n - 1, n - 1] = free[n - 1, 0] = free[0, n - 1] = True
    traj = np.stack([np.clip(n - 1 - np.arange(20), 0, n - 1), np.full(20, n // 2)], -1)[None]
    traj = np.concatenate([traj, rng.integers(0, n, (2, 20, 2))])
    return free, traj


# ---------------------------------------------------------------------------
# temporal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [0, 1])
def test_time_expanded_costs_arrival_and_path_match_jax(radius):
    free, traj = world()
    want_mask = jt.moving_obstacle_mask(jnp.asarray(free), jnp.asarray(traj), 18, radius=radius)
    mask = tt.moving_obstacle_mask(free, traj, 18, radius=radius, device="cpu")
    exact(mask, want_mask)
    want = jt.time_expanded_costs(want_mask, jnp.array([0, 0]))
    costs = tt.time_expanded_costs(mask, (0, 0), dtype=F64)
    close(costs, want)
    for goal in ((11, 11), (11, 0), (6, 6)):
        t_want, c_want = jt.earliest_arrival(want, jnp.array(goal))
        t_got, c_got = tt.earliest_arrival(costs, goal)
        assert int(t_got) == int(t_want)
        close(c_got, c_want)
        if int(t_want) >= 0:
            exact(tt.extract_time_path(costs, goal, int(t_got)),
                  jt.extract_time_path(want, jnp.array(goal), int(t_want)))
    blocked_goal = np.ones((4, 18, 18), bool)
    blocked_goal[:, 9, 9] = False
    t_got, c_got = tt.earliest_arrival(tt.time_expanded_costs(blocked_goal, (0, 0), device="cpu"),
                                       (9, 9))
    assert int(t_got) == -1 and float(c_got) == float("inf")


def test_corridor_wait_and_prioritized_agents_match_jax():
    # tests/test_temporal_mppi_variants.py's corridor with an obstacle sweeping through
    corridor = np.zeros((7, 3), dtype=bool)
    corridor[:, 1] = True
    traj = np.stack([np.clip(6 - np.arange(14), 0, 6), np.ones(14, int)], -1)[None]
    mask = tt.moving_obstacle_mask(corridor, traj, 14, device="cpu")
    costs = tt.time_expanded_costs(mask, (0, 1), dtype=F64)
    want = jt.time_expanded_costs(jt.moving_obstacle_mask(jnp.asarray(corridor),
                                                          jnp.asarray(traj), 14),
                                  jnp.array([0, 1]))
    close(costs, want)
    free, _ = world()
    starts = [(0, 0), (11, 0), (0, 11), (5, 5)]
    goals = [(11, 11), (0, 11), (11, 0), (6, 0)]
    got = tt.prioritized_multi_agent(free, starts, goals, 24, device="cpu", dtype=F64)
    want = jt.prioritized_multi_agent(jnp.asarray(free), [np.array(s) for s in starts],
                                      [np.array(g) for g in goals], 24)
    exact(got[0], want[0])
    exact(got[1], want[1])
    assert (want[1] >= 0).all()


# ---------------------------------------------------------------------------
# conformal
# ---------------------------------------------------------------------------

def conformal_inputs(seed=1, t_len=16, episodes=5):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(3, t_len, 2))
    obs = pred + 0.3 * rng.normal(size=pred.shape)
    predicted = np.stack([
        np.stack([np.full(t_len, 6.13), 0.9 * np.arange(t_len) + 0.2], -1),  # crosses the map
        rng.uniform(0, 12, (t_len, 2))])
    mask = np.ones((2, t_len), bool)
    mask[1, 5:9] = False
    errs = 0.6 * np.abs(rng.normal(size=(t_len, episodes)))
    return pred, obs, predicted, mask, errs


def test_calibration_quantile_and_radius_match_jax():
    pred, obs, *_ = conformal_inputs()
    want = jcf.calibration_errors_from_trajectories(pred, obs)
    got = tcf.calibration_errors_from_trajectories(pred, obs, device="cpu", dtype=F64)
    exact(got, want)
    for conf in (0.01, 0.5, 0.7, 1.0):
        exact(tcf.empirical_quantile(got[3], conf), jcf.empirical_quantile(want[3], conf))
        exact(tcf.empirical_quantile(got, conf), jcf.empirical_quantile(want, conf))
        exact(tcf.conformal_radius_at(got, 2, conf, 0.4), jcf.conformal_radius_at(want, 2, conf, 0.4))


def test_confidence_field_and_cp_sipp_match_jax():
    _, _, predicted, mask, errs = conformal_inputs()
    want = np.asarray(jcf.confidence_field(jnp.asarray(predicted), jnp.asarray(mask),
                                           jnp.asarray(errs), 0.6, 12, 12))
    got = tcf.confidence_field(predicted, mask, errs, 0.6, 12, 12, device="cpu", dtype=F64)
    assert want.dtype == np.float32  # the reference's bool mean
    close(got, want, atol=F32_ROUNDING)
    for level in (0.2, 0.6, 0.8):
        exact(got.numpy() >= level, want >= np.float32(level))
    blocked = np.zeros((12, 12), bool)
    blocked[3:5, 6:9] = True
    for required in (0.6, 0.8):
        kw = dict(required_confidence=required, obstacle_radius=0.6, predicted_mask=mask)
        want = jcf.conformal_sipp_plan(blocked, predicted, errs, (2, 0), (5, 11), **kw)
        got = tcf.conformal_sipp_plan(blocked, predicted, errs, (2, 0), (5, 11), device="cpu",
                                      dtype=F64, **kw)
        exact(got["path"], want["path"])
        assert got["arrival"] == want["arrival"]
        close(got["cost"], want["cost"])
        for key in ("min_confidence", "trajectory_violation_bound"):
            close(got[key], want[key], atol=16 * F32_ROUNDING)
    # an obstacle parked on the goal with huge scores: no confident path
    parked = np.tile(np.array([3.0, 3.0]), (8, 1))[None]
    assert tcf.conformal_sipp_plan(np.zeros((6, 6), bool), parked, np.full((8, 4), 50.0), (0, 0),
                                   (3, 3), device="cpu", dtype=F64) is None


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------

def test_robustness_primitives_and_first_conflict_match_jax():
    rect = js.StlRectangle(2.0, 6.0, 2.0, 6.0)
    trect = ts.StlRectangle(2.0, 6.0, 2.0, 6.0)
    rng = np.random.default_rng(5)
    path = rng.integers(0, 9, (12, 2))
    exact(trect.as_array(device="cpu", dtype=F64), rect.as_array())
    xy = rng.uniform(0, 8, (2, 7))
    exact(ts.inside_robustness(trect.as_array(device="cpu", dtype=F64), *torch.tensor(xy)),
          js.inside_robustness(rect.as_array(), *jnp.asarray(xy)))
    exact(ts.avoid_robustness(trect.as_array(device="cpu", dtype=F64), *torch.tensor(xy)),
          js.avoid_robustness(rect.as_array(), *jnp.asarray(xy)))
    for iv in ((0, 3), (4, 11), (2, 2)):
        exact(ts.eventually_reach_robustness(path, trect, iv, device="cpu", dtype=F64),
              js.eventually_reach_robustness(jnp.asarray(path), rect.as_array(), iv))
        exact(ts.always_avoid_robustness(path, [2.5, 5.0, 1.0, 7.5], iv, device="cpu", dtype=F64),
              js.always_avoid_robustness(jnp.asarray(path), jnp.array([2.5, 5.0, 1.0, 7.5]), iv))
        paths = rng.integers(0, 6, (4, 12, 2))
        exact(ts.pairwise_separation_robustness(paths, 1.5, iv, device="cpu", dtype=F64),
              js.pairwise_separation_robustness(jnp.asarray(paths), 1.5, iv))
    assert float(ts.pairwise_separation_robustness(path[None], 1.0, (0, 3), device="cpu")) == \
        float("inf")
    for paths in (np.array([[[0, 0], [1, 0], [2, 0]], [[2, 0], [1, 0], [0, 0]]]),
                  np.array([[[0, 0], [1, 0]], [[1, 0], [0, 0]]]), rng.integers(0, 3, (3, 6, 2)),
                  np.array([[[0, 0], [1, 0]], [[3, 3], [2, 2]]])):
        assert ts.first_conflict(paths) == js.first_conflict(paths)


def same_plan(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            exact(got[key], value)
        elif isinstance(value, dict):
            assert set(got[key]) == set(value)
            for k in value:
                close(got[key][k], value[k])
        elif isinstance(value, float):
            close(got[key], value)
        else:
            assert got[key] == value, key


STL_CASES = {
    # tests/test_stl_mapf.py's head-on corridor
    "head-on": (np.ones((9, 3), bool), [(0, 1), (8, 1)], [(8, 1), (0, 1)], 20, {}),
    "geofence, 3 agents": (np.ones((12, 12), bool), [(0, 5), (11, 6), (5, 0)],
                           [(11, 5), (0, 6), (5, 11)], 30,
                           dict(avoid=((4.0, 7.0, 4.0, 7.0), (0, 29)), reach=(0, (9.0, 11.0, 4.0,
                                                                                  6.0), (5, 25)))),
    "kinodynamic": (np.ones((16, 3), bool), [(0, 1)], [(15, 1)], 24, dict(speed=3)),
    "random, 4 agents": (world(2, 12, 0.1)[0], [(0, 0), (11, 11), (0, 11), (11, 0)],
                         [(11, 11), (0, 0), (11, 0), (0, 11)], 30, dict(min_separation=1.5)),
}


@pytest.mark.parametrize("case", sorted(STL_CASES))
def test_stl_cbs_plan_matches_jax(case):
    free, starts, goals, t_max, kw = STL_CASES[case]
    jkw, tkw = {}, {}
    if "avoid" in kw:
        rect, iv = kw["avoid"]
        jkw["avoid_regions"] = ((js.StlRectangle(*rect), iv),)
        tkw["avoid_regions"] = ((ts.StlRectangle(*rect), iv),)
        agent, reach_rect, reach_iv = kw["reach"]
        jkw["reach_specs"] = ((agent, js.StlRectangle(*reach_rect), reach_iv),)
        tkw["reach_specs"] = ((agent, list(reach_rect), reach_iv),)
    for key in ("speed", "min_separation"):
        if key in kw:
            jkw[key] = tkw[key] = kw[key]
    want = js.stl_cbs_plan(jnp.asarray(free), starts, goals, t_max, **jkw)
    got = ts.stl_cbs_plan(free, starts, goals, t_max, device="cpu", dtype=F64, **tkw)
    same_plan(got, want)
    assert js.first_conflict(want["paths"]) is None
    if case == "kinodynamic":
        same_plan(ts.kinodynamic_stl_cbs_plan(free, starts, goals, t_max, speed=3, device="cpu",
                                              dtype=F64), want)


def test_hierarchical_mapf_and_safe_decode_match_jax():
    free = np.ones((10, 10), bool)
    starts, goals = [(0, 0), (3, 0), (9, 9)], [(3, 0), (0, 0), (9, 0)]
    want = js.hierarchical_mapf_plan(jnp.asarray(free), starts, goals, t_max=16, region_size=5)
    got = ts.hierarchical_mapf_plan(free, starts, goals, t_max=16, region_size=5, device="cpu",
                                    dtype=F64)
    same_plan(got, want)
    assert want["groups_replanned"] >= 1
    free = np.ones((12, 12), bool)
    free[9, 2:5] = False
    for reach in (None, ((9.0, 11.0, 0.0, 3.0), (10, 20))):
        jkw = dict(avoid_regions=((js.StlRectangle(3.0, 8.0, 3.0, 8.0), (0, 29)),))
        tkw = dict(avoid_regions=((ts.StlRectangle(3.0, 8.0, 3.0, 8.0), (0, 29)),))
        if reach is not None:
            jkw["reach_spec"] = (js.StlRectangle(*reach[0]), reach[1])
            tkw["reach_spec"] = (list(reach[0]), reach[1])
        want = js.safe_decode_nav(free, (0, 0), (11, 11), t_max=30, **jkw)
        got = ts.safe_decode_nav(free, (0, 0), (11, 11), t_max=30, device="cpu", dtype=F64, **tkw)
        same_plan(got, want)
        assert want["overrides"] >= 1
