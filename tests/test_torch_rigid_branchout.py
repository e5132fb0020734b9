"""The rigid-body and BranchOut planners (`planning/{rigid_body,branchout}.py`)
against the JAX package's: JAX on the CPU at x64, torch in float64 on the
CPU, on tests/test_breadth_planners.py's scenes.

Tolerances: lattice poses, certificates (half-space indices and margins),
costs, paths, iteration counts and the RRT's tree exactly; BranchOut's
rollouts and costs within 1e-12 relative (JAX's jitted rollout fuses
multiply-adds), float32 as stated; Fréchet distances bitwise (min and max
are exact); the closed loop's modes and counts exactly, its floats within
1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import branchout as jb
from rust_robotics_tpu.planning import rigid_body as jr
from rust_robotics_tpu_torch.planning import branchout as tb
from rust_robotics_tpu_torch.planning import rigid_body as tr

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64, F32 = torch.float64, torch.float32
START, GOAL = (1.0, 1.0, 0.0), (9.0, 1.0, 0.0)
WALL = (3.5, 6.5, 0.0, 6.0)  # the JAX tests' obstacle
SCENES = ("simple_overtake", "wide_overtake", "forced_yield")


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, atol=1e-12, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=rtol)


def test_halfspaces_and_certificates_match_jax():
    tri = [(0, 0), (2, 0), (0, 2)]
    assert torch.equal(tr.convex_polygon_halfspaces(tri, F64, "cpu"),
                       t64(jr.convex_polygon_halfspaces(tri)))
    assert torch.equal(tr.convex_polygon_halfspaces(tri[::-1], F64, "cpu"),
                       t64(jr.convex_polygon_halfspaces(tri[::-1])))
    obs = [jr.aabb_obstacle(4.0, 6.0, 4.0, 6.0), jr.convex_polygon_halfspaces([(7, 7), (9, 7),
                                                                               (8, 9)])]
    hs, valid = jr._stack_obstacles(obs)
    ths, tvalid = tr._stack_obstacles([t64(o) for o in obs])
    assert torch.equal(ths, t64(hs)) and torch.equal(tvalid, torch.tensor(np.asarray(valid)))
    rng = np.random.default_rng(7)
    poses = np.concatenate([rng.uniform(0, 10, (64, 2)), rng.uniform(-np.pi, np.pi, (64, 1))], 1)
    cfg = jr.RigidBodyConfig()
    want = jax.jit(lambda p: jr.pose_certificates(p, hs, valid, cfg))(jnp.asarray(poses))
    got = tr.pose_certificates(t64(poses), ths, tvalid, cfg)
    assert torch.equal(got[0], torch.tensor(np.asarray(want[0])))
    assert torch.equal(got[1], torch.tensor(np.asarray(want[1])).long())
    close(got[2], want[2], 1e-12)
    # a pose's certificate does not depend on the batch it is computed in
    for i in (0, 17, 63):
        solo = tr.pose_certificates(t64(poses[i]), ths, tvalid, cfg)
        assert all(torch.equal(s, g[i]) for s, g in zip(solo, got))


@functools.lru_cache(maxsize=None)
def jax_lattice():
    return jr.rigid_body_lattice_plan(START, GOAL, [jr.aabb_obstacle(*WALL)], jr.RigidBodyConfig())


@pytest.mark.parametrize("dtype", [F64, F32])
def test_lattice_plan_matches_jax(dtype):
    want = jax_lattice()
    got = tr.rigid_body_lattice_plan(START, GOAL, [tr.aabb_obstacle(*WALL, dtype=dtype,
                                                                    device="cpu")])
    assert set(got) == set(want) and got["backend"] == "lattice"
    for k in ("certificate_halfspaces", "iterations"):
        np.testing.assert_array_equal(got[k], want[k])
    # float32: poses and margins to a few units of its rounding at 10 m
    atol = 0.0 if dtype == F64 else 1e-5
    for k in ("poses", "certificate_margins", "total_cost", "path_length", "heading_change",
              "min_separation_margin"):
        close(got[k], want[k], atol)
    assert got["min_separation_margin"] > 0.02 and got["total_cost"] > 0


def test_lattice_plan_without_goal_heading_and_unreachable_goal():
    """Any heading at the goal cell: no dearer than the goal heading JAX's
    plan reaches, and ending at the goal cell; a goal inside the obstacle:
    no plan."""
    obs = [tr.aabb_obstacle(*WALL, dtype=F64, device="cpu")]
    want = jax_lattice()
    got = tr.rigid_body_lattice_plan(START, (9.0, 1.0, 1.0), obs, require_goal_heading=False)
    assert got["total_cost"] <= want["total_cost"]
    np.testing.assert_array_equal(got["poses"][-1][:2], [9.0, 1.0])
    np.testing.assert_array_equal(got["poses"][0], want["poses"][0])
    assert tr.rigid_body_lattice_plan(START, (5.0, 3.0, 0.0), obs) is None


def test_rrt_backend_matches_jax_given_its_seed(monkeypatch):
    # JAX's tree checks each pose by an eager call; its jitted self gives
    # the same values at one compile
    monkeypatch.setattr(jr, "pose_certificates", jax.jit(jr.pose_certificates,
                                                         static_argnums=3))
    key = jax.random.PRNGKey(0)
    want = jr.rigid_body_rrt_plan(key, START, GOAL, [jr.aabb_obstacle(*WALL)],
                                  jr.RigidBodyConfig(), max_nodes=600)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got = tr.rigid_body_rrt_plan(seed, START, GOAL, [tr.aabb_obstacle(*WALL, dtype=F64,
                                                                      device="cpu")],
                                 tr.RigidBodyConfig(), max_nodes=600)
    np.testing.assert_array_equal(got["poses"], want["poses"])
    for k in ("backend", "path_length", "heading_change", "iterations", "min_separation_margin"):
        assert got[k] == want[k], k
    assert got["path_length"] >= 8.0 and got["min_separation_margin"] > 0.02
    # a NumPy generator seeds the same tree
    again = tr.rigid_body_rrt_plan(np.random.default_rng(seed), START, GOAL,
                                   [tr.aabb_obstacle(*WALL, dtype=F64, device="cpu")],
                                   max_nodes=600)
    np.testing.assert_array_equal(again["poses"], got["poses"])


@functools.lru_cache(maxsize=None)
def jax_plan(scene):
    return {k: (v if k == "modes" else np.asarray(v))
            for k, v in jb.branchout_plan(getattr(jb.BranchOutScene, scene)()).items()}


@pytest.mark.parametrize("scene", SCENES)
def test_branchout_plan_matches_jax(scene):
    want = jax_plan(scene)
    got = tb.branchout_plan(getattr(tb.BranchOutScene, scene)(), dtype=F64, device="cpu")
    assert got["modes"] == want["modes"]
    for k in ("poses", "cost", "probability", "collision_risk", "comfort_cost",
              "route_completion"):
        close(got[k], want[k], 1e-12 * max(1.0, float(np.abs(want[k]).max())))
    assert int(torch.argmax(got["probability"])) == int(np.argmax(want["probability"]))
    # float32: costs within 1e-4 relative, the same winning mode
    g32 = tb.branchout_plan(getattr(tb.BranchOutScene, scene)(), device="cpu")
    close(g32["cost"], want["cost"], 1e-4 * float(np.abs(want["cost"]).max()))
    assert int(torch.argmax(g32["probability"])) == int(np.argmax(want["probability"]))


def test_discrete_frechet_lanes_bitwise_jax():
    rng = np.random.default_rng(11)
    frechet = jax.jit(jb.discrete_frechet)
    a, b = rng.normal(size=(5, 13, 2)), rng.normal(size=(5, 9, 2))
    got = tb.discrete_frechet(t64(a), t64(b))
    for i in range(5):
        assert float(got[i]) == float(frechet(a[i], b[i]))
        assert torch.equal(tb.discrete_frechet(t64(a[i]), t64(b[i])), got[i])
    line = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    assert float(tb.discrete_frechet(t64(line), t64(line + [0.0, 1.0]))) == 1.0
    assert float(tb.discrete_frechet(t64(line[:1]), t64(line[:1]))) == 0.0


def test_time_to_collision_matches_jax():
    cases = [((0.0, 0.0), (2.0, 0.0), (4.0, 0.0), (0.0, 0.0), 1.0),
             ((0.0, 0.0), (-1.0, 0.0), (4.0, 0.0), (0.0, 0.0), 1.0),
             ((0.0, 0.0), (0.0, 0.0), (0.2, 0.0), (0.0, 0.0), 1.0),
             ((0.0, 0.0), (1.0, 0.5), (3.0, 1.0), (-0.5, 0.2), 0.7)]
    got = tb.time_to_collision(*(t64([c[i] for c in cases]) for i in range(4)),
                               t64([c[4] for c in cases]))
    for g, c in zip(got, cases):
        assert float(g) == float(jb.time_to_collision(*c))
    assert [float(v) for v in got[:3]] == [1.5, np.inf, 0.0]


def test_evaluate_multimodal_matches_jax(monkeypatch):
    # JAX's metrics call its eager row scan 6 + 4G times; its jitted self
    # gives the same values at one compile a shape
    monkeypatch.setattr(jb, "discrete_frechet", jax.jit(jb.discrete_frechet))
    plan = jb.branchout_plan(jb.BranchOutScene.wide_overtake())
    gts = np.asarray(plan["poses"])[[2]] + np.array([0.0, 0.3, 0.1])
    want = jb.evaluate_multimodal(plan, gts)
    got = tb.evaluate_multimodal(tb.branchout_plan(tb.BranchOutScene.wide_overtake(), dtype=F64,
                                                   device="cpu"), gts)
    assert got["mode_count"] == want["mode_count"] == 4
    for k in want:
        close(got[k], want[k], 1e-12)
    assert 0.0 <= got["speed_jsd"] <= np.log(2) + 1e-9


@pytest.mark.parametrize("scene,vels", [("wide_overtake", [(0.0, 0.0)]),
                                        ("forced_yield", [(0.3, 0.0)])])
def test_closed_loop_matches_jax(scene, vels, monkeypatch):
    monkeypatch.setattr(jb, "time_to_collision", jax.jit(jb.time_to_collision))
    steps = 40 if scene == "wide_overtake" else 12
    want = jb.simulate_closed_loop(getattr(jb.BranchOutScene, scene)(), vels, steps=steps)
    got = tb.simulate_closed_loop(getattr(tb.BranchOutScene, scene)(), vels, steps=steps,
                                  dtype=F64, device="cpu")
    assert got["mode_sequence"] == want["mode_sequence"]
    for k in ("steps", "reached_goal", "collision_steps", "risky_ttc_steps"):
        assert got[k] == want[k], k
    for k in ("route_completion", "no_collision_rate", "min_clearance", "mean_comfort_cost",
              "min_time_to_collision", "executed_path"):
        close(got[k], want[k], 1e-9)
    if scene == "wide_overtake":  # tests/test_breadth_planners.py's gates
        assert got["collision_steps"] == 0 and got["route_completion"] > 0.9
        assert got["min_clearance"] > 0 and len(got["mode_sequence"]) == 40
