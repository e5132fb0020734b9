"""DWA (`planning/dwa.py`), the mission behavior trees and state machine
(`control/mission.py`) and the two closed-loop headless demos
(`demos/headless.py`) against the JAX package's, on numpy inputs made from
a seed: JAX on the CPU at x64, torch in float64 on the CPU.

Tolerances: a DWA step takes the same samples of the same window, so the
chosen control is held exactly and the state, trajectory and cost at
1e-12 (torch's CPU sin, cos and sqrt may round an ulp apart from XLA's);
a lane equals its solo run bit for bit. The state machine's history and
blackboard are held exactly. The demos' integer and boolean metrics are
held exactly, their floats at 1e-9 (a 141-step closed loop through the EKF
carries the per-step ulps; 1e-13 measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.control import mission as jm
from rust_robotics_tpu.demos import headless as jh
from rust_robotics_tpu.filters import kalman as jk
from rust_robotics_tpu.planning import dwa as jd
from rust_robotics_tpu_torch.control import mission as tm
from rust_robotics_tpu_torch.demos import headless as th
from rust_robotics_tpu_torch.planning import dwa as td

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
CFG = td.DWAConfig()
F64 = torch.float64
jax_step = jax.jit(jd.dwa_step, static_argnames=("cfg",))
jax_fleet = jax.jit(jax.vmap(jd.dwa_step, in_axes=(0, 0, 0, None, 0)), static_argnums=3)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


@functools.lru_cache(maxsize=None)
def fleet(seed, b=5, m=9):
    """Robots near the origin heading roughly to a goal among obstacles."""
    r = np.random.default_rng(seed)
    state = np.concatenate([r.uniform(-1.0, 1.0, (b, 2)), r.uniform(-np.pi, np.pi, (b, 1)),
                            r.uniform(-0.4, 0.9, (b, 1)), r.uniform(-0.5, 0.5, (b, 1))], -1)
    goal = r.uniform(5.0, 9.0, (b, 2))
    obstacles = r.uniform(-1.0, 8.0, (b, m, 2))
    mask = r.random((b, m)) > 0.25
    return state, goal, obstacles, mask


def test_dwa_parts_match_jax():
    state, goal, _, _ = fleet(0)
    v, w = np.array([0.3, -0.2, 0.8]), np.array([0.1, 0.5, -0.4])
    close(td.dwa_motion(t64(state[:3]), t64(v), t64(w), 0.1),
          jd.dwa_motion(jnp.asarray(state[:3]), v, w, 0.1))
    for g, want in zip(td.dynamic_window(t64(state), CFG), jd.dynamic_window(state, CFG)):
        close(g, want, 0.0)
    close(td.rollout(t64(state[:3]), t64(v), t64(w), CFG),
          jd.rollout(jnp.asarray(state[:3]), jnp.asarray(v), jnp.asarray(w), CFG))
    near = np.concatenate([goal[:2] + 0.5, goal[2:] + 3.0])
    got = td.goal_reached(t64(np.concatenate([near, state[:, 2:]], -1)), t64(goal), CFG)
    want = [bool(jd.goal_reached(jnp.asarray(np.r_[near[k], state[k, 2:]]), goal[k], CFG))
            for k in range(len(goal))]
    assert got.tolist() == want == [True, True, False, False, False]


@pytest.mark.parametrize("masked", [False, True])
def test_dwa_step_matches_jax_and_lanes_equal_solo_runs(masked):
    state, goal, obstacles, mask = fleet(1)
    m = mask if masked else np.ones(mask.shape, bool)
    want = jax_fleet(jnp.asarray(state), jnp.asarray(goal), jnp.asarray(obstacles), CFG,
                     jnp.asarray(m))
    got = td.dwa_step(t64(state), t64(goal), t64(obstacles), CFG,
                      torch.tensor(m) if masked else None)
    close(got[0], want[0], 0.0)
    for g, w in zip(got[1:], want[1:]):
        close(g, w)
    for k in range(len(state)):
        solo = td.dwa_step(t64(state[k]), t64(goal[k]), t64(obstacles[k]), CFG,
                           torch.tensor(m[k]) if masked else None)
        assert all(torch.equal(s, g[k]) for s, g in zip(solo, got)), k
    # a single robot against the unbatched JAX step
    one = jax_step(jnp.asarray(state[0]), jnp.asarray(goal[0]), jnp.asarray(obstacles[0]), CFG,
                   jnp.asarray(m[0]) if masked else None)
    for g, w in zip(got, one):
        close(g[0], w)


def test_dwa_step_all_collide_takes_the_first_sample():
    state = np.array([0.0, 0.0, 0.3, 0.5, 0.1])
    obstacles = np.array([[0.2, 0.1], [3.0, 3.0]])  # within the robot radius
    want = jax_step(jnp.asarray(state), jnp.asarray([5.0, 5.0]), jnp.asarray(obstacles), CFG)
    got = td.dwa_step(t64(state), t64([5.0, 5.0]), t64(obstacles), CFG)
    assert np.isinf(float(want[3])) and torch.isinf(got[3])
    close(got[0], want[0], 0.0)
    close(got[0], [0.5 - CFG.max_accel * CFG.dt, 0.1 - CFG.max_delta_yaw_rate * CFG.dt], 0.0)


# ---------------------------------------------------------------------------
# behavior trees and the mission state machine
# ---------------------------------------------------------------------------

def test_behavior_tree_nodes_match_jax():
    def tree(mod, log):
        def act(name, status):
            return mod.Action(lambda bb: (log.append(name), getattr(mod.Status, status))[1], name)

        cond = mod.Condition(lambda bb: bb["battery"] > 0.2, "battery_ok")
        return mod.Selector([
            mod.Sequence([cond, act("work", "RUNNING")]),
            mod.Sequence([mod.Inverter(cond), act("dock", "SUCCESS")]),
            act("idle", "FAILURE"),
        ])

    for battery in (0.9, 0.1):
        j_log, t_log = [], []
        j = tree(jm, j_log).tick({"battery": battery})
        t = tree(tm, t_log).tick({"battery": battery})
        assert (t.value, t_log) == (j.value, j_log)


def scripted_positions():
    """A robot that closes on waypoint 0, stalls short of it, recovers, and
    then reaches both waypoints."""
    pos = [np.array([4.0 - 0.3 * k, 0.0]) for k in range(5)][::-1]
    pos += [np.array([2.9, 0.05])] * 14
    pos += [np.array([2.9, 0.05])] * 10
    pos += [np.array([3.6, 0.0]), np.array([3.9, 0.1]), np.array([6.0, 2.5]),
            np.array([7.6, 3.7]), np.array([8.0, 4.0])]
    return pos


def run_mission(mod, as_tensor):
    waypoints = [np.array([4.0, 0.0]), np.array([8.0, 4.0])]
    sm = mod.make_waypoint_mission(waypoints, goal_tolerance=0.6, stuck_window=12,
                                   stuck_min_progress=0.05, recovery_steps=10)
    bb = {"position": np.zeros(2), "wp_index": 0, "recovery_count": 0}
    states = []
    for p in scripted_positions():
        bb["position"] = t64(p) if as_tensor else p
        states.append(sm.step(bb))
    bb.pop("position")
    return sm.history, states, bb


def test_waypoint_mission_matches_jax():
    j_hist, j_states, j_bb = run_mission(jm, False)
    for as_tensor in (False, True):
        t_hist, t_states, t_bb = run_mission(tm, as_tensor)
        assert (t_hist, t_states) == (j_hist, j_states)
        assert t_bb == j_bb
    assert "recover" in j_hist and j_states[-1] == "done" and j_bb["recovery_count"] == 1


# ---------------------------------------------------------------------------
# the two closed-loop demos
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_demo(name):
    """A JAX demo's metrics, with its per-step DWA and EKF calls under
    `jax.jit` (the demo calls them eagerly: ~40 s against ~2 s)."""
    patched = {(jd, "dwa_step"): jax.jit(jd.dwa_step, static_argnames=("cfg",)),
               (jk, "ekf_step"): jax.jit(jk.ekf_step, static_argnames=("model",))}
    saved = {key: getattr(*key) for key in patched}
    try:
        for (mod, attr), fn in patched.items():
            setattr(mod, attr, fn)
        return getattr(jh, name)()
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


@pytest.mark.parametrize("name", ["headless_navigation_loop", "headless_mission_recovery"])
def test_headless_demo_matches_jax(name):
    want = jax_demo(name)
    got = getattr(th, name)(device="cpu", dtype=F64)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, (bool, int, np.bool_)):
            assert g == w, key
        else:
            close(g, w, 1e-9)
    assert want.get("goal_reached", True) and want.get("mission_done", True)


@pytest.mark.cuda
def test_dwa_step_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state, goal, obstacles, mask = fleet(2, b=16)
    args = (t64(state), t64(goal), t64(obstacles), CFG, torch.tensor(mask))
    want = td.dwa_step(*args)
    got = td.dwa_step(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        close(g.cpu(), w, 1e-9)
