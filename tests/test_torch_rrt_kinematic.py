"""The kinematic RRTs (`planning/rrt_kinematic.py`) against the JAX
package's: JAX on the CPU at x64 (its planners are jitted), torch in
float64 on the CPU, on tests/test_rrt_kinematic.py's course with trees of
48 nodes (the JAX tests grow 96-200) and the closed loop cut to 120 of its
600 steps. The port gets JAX's own draws.

Tolerances: parents, active masks, counts, best nodes exactly; poses and
costs within 1e-11 (the Dubins and Reeds-Shepp closed forms go through
atan2/arccos, which XLA and torch may round an ulp apart, and a jitted
XLA fuses multiply-adds); the tracked trajectory within 1e-9. The 4-lane
forests of the Dubins RRT, the Dubins RRT* and the Reeds-Shepp RRT* are
bitwise their 4 solo runs.

Reeds-Shepp: a CCC word and its timeflip tie in exact arithmetic for
about a fifth of pose pairs (tests/test_torch_curves_frenet.py), and
which of the two each package samples is rounding; where an obstacle
clears one and not the other, the trees part. The RS RRT* is therefore
held to JAX's tree exactly on the course without its obstacles (edge
costs do not depend on the tie), and on the course with them to the JAX
test's gates (a path is found and its sampled edges clear the obstacles).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import rrt_kinematic as jk
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.planning import rrt_kinematic as tk

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
START, GOAL = np.array([0.0, 0.0, 0.0]), np.array([9.0, 9.0, np.pi / 2])
OBS, RAD = np.array([[4.5, 4.5], [2.0, 6.5]]), np.array([1.2, 0.9])
N = 48
JCFG = jk.KinematicRRTConfig(max_nodes=N, curvature=0.8, connect_radius=5.0)
TCFG = tk.KinematicRRTConfig(max_nodes=N, curvature=0.8, connect_radius=5.0)
JARGS = (jnp.asarray(START), jnp.asarray(GOAL), jnp.asarray(OBS), jnp.asarray(RAD))


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, atol=1e-11):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


@functools.lru_cache(maxsize=None)
def draws(seed, width=4, split=True):
    """The uniforms iteration i draws: uniform(split(keys[i])[0], (width,)),
    or uniform(keys[i], (width,)) for LQR-RRT*."""
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    fn = (lambda k: jax.random.uniform(jax.random.split(k)[0], (width,))) if split else (
        lambda k: jax.random.uniform(k, (width,)))
    return t64(jax.vmap(fn)(keys)[:N - 1])


def same_tree(got, want):
    for name in ("parents", "active", "count"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    close(got.poses, want.poses)
    close(got.costs, want.costs)


# the Dubins RRT* is held to JAX's inside the closed loop (its first stage)
PLANNERS = {"rrt_dubins": (jk.rrt_dubins_plan, tk.rrt_dubins_plan, False),
            "rrt_star_reeds_shepp": (jk.rrt_star_reeds_shepp_plan, tk.rrt_star_reeds_shepp_plan,
                                     True)}


@functools.lru_cache(maxsize=None)
def jax_plan(name, seed, far=False):
    args = JARGS[:2] + tuple(jnp.asarray(v) for v in FAR) if far else JARGS
    return PLANNERS[name][0](jax.random.PRNGKey(seed), *args, JCFG)


FAR = (np.array([[40.0, 40.0]]), np.array([0.5]))  # outside the sampling area


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_kinematic_rrt_matches_jax_with_its_draws(name):
    _, tfn, rs = PLANNERS[name]
    obs, rad = FAR if rs else (OBS, RAD)
    tree, best, cost = jax_plan(name, 2, rs)
    got = tfn(None, START, GOAL, obs, rad, TCFG, draws=draws(2), dtype=F64, device="cpu")
    same_tree(got[0], tree)
    assert int(got[1]) == int(best)
    close(got[2], cost)
    assert float(cost) < 1e17
    want = jax.jit(lambda t, b: jk.extract_pose_path(t, b, JARGS[1], JCFG.curvature,
                                                     reeds_shepp=rs))(tree, best)
    conv = convert.pose_tree_from_numpy(*(np.asarray(getattr(tree, f)) for f in (
        "poses", "parents", "costs", "active", "count")), device="cpu")
    poses, mask = tk.extract_pose_path(conv, got[1], GOAL, TCFG.curvature, reeds_shepp=rs)
    assert np.array_equal(mask.numpy(), np.asarray(want[1]))
    close(poses.numpy()[mask.numpy()], np.asarray(want[0])[np.asarray(want[1])], 1e-10)


def test_reeds_shepp_rrt_star_on_the_obstacle_course():
    """tests/test_rrt_kinematic.py::test_rrt_star_reeds_shepp_feasible's
    gates on the port's own tree."""
    tree, best, cost = tk.rrt_star_reeds_shepp_plan(None, START, GOAL, OBS, RAD, TCFG,
                                                    draws=draws(2), dtype=F64, device="cpu")
    assert float(cost) < tk.BIG / 2
    poses, mask = tk.extract_pose_path(tree, best, GOAL, TCFG.curvature, reeds_shepp=True)
    pts = poses.numpy()[mask.numpy()]
    d = np.linalg.norm(pts[:, None, :2] - OBS[None], axis=-1)
    assert np.all(d > RAD[None] - 1e-9)


def forest_lanes_equal_solo_runs(tfn):
    """A 4-lane forest of seeds 2-5's draws on the obstacle course, each
    lane bitwise its solo run."""
    d = torch.stack([draws(s) for s in (2, 3, 4, 5)])
    forest = tfn(None, START, GOAL, OBS, RAD, TCFG, draws=d, dtype=F64, device="cpu")
    for lane in range(4):
        solo = tfn(None, START, GOAL, OBS, RAD, TCFG, draws=d[lane], dtype=F64, device="cpu")
        for name in ("poses", "parents", "costs", "active", "count"):
            assert torch.equal(getattr(forest[0], name)[lane], getattr(solo[0], name)), name
        assert torch.equal(forest[1][lane], solo[1]) and torch.equal(forest[2][lane], solo[2])


def test_dubins_rrt_star_forest_lanes_equal_solo_runs():
    forest_lanes_equal_solo_runs(tk.rrt_star_dubins_plan)


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_kinematic_rrt_forest_lanes_equal_solo_runs(name):
    forest_lanes_equal_solo_runs(PLANNERS[name][1])


def test_closed_loop_and_dubins_rrt_star_match_jax():
    steps = 120
    traj, tree, cost, report = jax.jit(lambda k: jk.closed_loop_rrt_star_plan(
        k, *JARGS, JCFG, target_speed=1.2, sim_steps=steps))(jax.random.PRNGKey(3))
    got = tk.closed_loop_rrt_star_plan(None, START, GOAL, OBS, RAD, TCFG, target_speed=1.2,
                                       sim_steps=steps, draws=draws(3), dtype=F64, device="cpu")
    same_tree(got[1], tree)
    close(got[2], cost)
    close(got[0], traj, 1e-9)
    assert bool(got[3]["tracked_collision_free"]) == bool(report["tracked_collision_free"])
    close(got[3]["min_goal_distance"], report["min_goal_distance"], 1e-9)


def test_lqr_rrt_star_matches_jax():
    jcfg, tcfg = jk.LQRRRTConfig(max_nodes=N), tk.LQRRRTConfig(max_nodes=N)
    start, goal = np.array([0.0, 0.0, 0.0, 0.0]), np.array([8.0, 8.0, 0.0, 0.0])
    tree, best, cost = jax.jit(lambda k: jk.lqr_rrt_star_plan(
        k, jnp.asarray(start), jnp.asarray(goal), jnp.asarray(OBS), jnp.asarray(RAD), jcfg))(
        jax.random.PRNGKey(4))
    got = tk.lqr_rrt_star_plan(None, start, goal, OBS, RAD, tcfg, draws=draws(4, 3, False),
                               dtype=F64, device="cpu")
    for name in ("parents", "active", "count"):
        assert np.array_equal(got[0][name].numpy(), np.asarray(tree[name])), name
    close(got[0]["nodes"], tree["nodes"], 1e-10)
    close(got[0]["costs"], tree["costs"], 1e-9)
    assert int(got[1]) == int(best)
    close(got[2], cost, 1e-9)
