"""The reactive planners, hybrid A*, the lattice, CHOMP and the bipedal
planner (`planning/{reactive,hybrid_astar,lattice,chomp,bipedal}.py`)
against the JAX package's: JAX on the CPU at x64 (under `jax.jit`), torch
in float64 on the CPU, on the JAX tests' problems (tests/test_reactive.py,
test_hybrid_astar.py, test_lattice.py, test_chomp_risk.py,
test_breadth_planners.py) at their sizes or smaller, as stated.

Tolerances: cells, paths, counts and iteration counts exactly; float64
values within 1e-12 where one pass computes them, and as stated where an
iteration carries rounding (a jitted XLA rounds a division by a constant
as a product by its reciprocal, and fuses multiply-adds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import bipedal as jb
from rust_robotics_tpu.planning import chomp as jch
from rust_robotics_tpu.planning import hybrid_astar as jh
from rust_robotics_tpu.planning import lattice as jl
from rust_robotics_tpu.planning import reactive as jr
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.planning import bipedal as tb
from rust_robotics_tpu_torch.planning import chomp as tch
from rust_robotics_tpu_torch.planning import hybrid_astar as th
from rust_robotics_tpu_torch.planning import lattice as tl
from rust_robotics_tpu_torch.planning import reactive as tr

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def test_elastic_band_dmp_and_lqr_plan_match_jax():
    xs = np.linspace(0.0, 10.0, 21)
    pts = np.stack([xs, 0.3 * np.sin(xs)], -1)
    obs, rad = np.array([[5.0, 0.0], [2.0, 1.0]]), np.array([1.0, 0.5])
    want = jax.jit(lambda p: jr.elastic_band_optimize(p, jnp.asarray(obs), jnp.asarray(rad),
                                                      iterations=40))(jnp.asarray(pts))
    got = tr.elastic_band_optimize(t64(pts), obs, rad, iterations=40)
    close(got, want, 1e-11)
    lanes = tr.elastic_band_optimize(torch.stack([t64(pts), t64(pts[::-1].copy())]), obs, rad,
                                     iterations=40)
    assert torch.equal(lanes[0], got)

    dt = 0.01
    t = np.arange(0, 1.0, dt)
    demo = np.stack([np.sin(2 * np.pi * t), t**2], -1)
    w, (y0, g) = jax.jit(lambda d: jr.dmp_fit(d, dt))(jnp.asarray(demo))
    tw, (ty0, tg) = tr.dmp_fit(t64(demo), dt)
    close(tw, w, 1e-7 * float(jnp.abs(w).max()))  # sums of 100 products in another order
    roll = jax.jit(lambda w, a, b: jr.dmp_rollout(w, a, b, len(t), dt))(w, y0, g)
    cw, cy0, cg = convert.dmp_from_numpy(np.asarray(w), np.asarray(y0), np.asarray(g),
                                         device="cpu")
    close(tr.dmp_rollout(cw, cy0, cg, len(t), dt), roll, 1e-10)

    want = jax.jit(lambda a, b: jr.lqr_plan(a, b, steps=60))(jnp.array([0.0, 0.0]),
                                                              jnp.array([6.0, -4.0]))
    got = tr.lqr_plan([0.0, 0.0], [6.0, -4.0], steps=60, dtype=F64, device="cpu")
    close(got, want, 1e-10)


def test_pso_matches_jax_with_its_draws():
    iters, p = 20, 64
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    x0 = jax.random.uniform(k1, (p, 2), minval=-10.0, maxval=10.0)
    keys = jax.random.split(k2, iters)
    r1 = jax.vmap(lambda k: jax.random.uniform(k, (p, 2)))(keys)
    r2 = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (p, 2)))(keys)
    jobj = lambda x: jnp.sum((x - jnp.array([2.0, -3.0])) ** 2, axis=-1)  # noqa: E731
    want = jax.jit(lambda k: jr.pso_minimize(k, jobj, dim=2, iterations=iters))(key)
    target = t64([2.0, -3.0])
    tobj = lambda x: ((x - target) ** 2)[..., 0] + ((x - target) ** 2)[..., 1]  # noqa: E731
    got = tr.pso_minimize(None, tobj, 2, iterations=iters, draws=(t64(x0), t64(r1), t64(r2)))
    close(got[0], want[0], 1e-11)
    close(got[1], want[1], 1e-11)


def test_bug_planners_match_jax():
    blocked = np.zeros((30, 30), dtype=bool)
    blocked[14:16, 0:22] = True
    want = jr.bug2_plan(blocked, (2, 10), (28, 10))
    got = tr.bug2_plan(torch.from_numpy(blocked), (2, 10), (28, 10))
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    blocked = np.zeros((20, 20), bool)
    blocked[8:12, 5:15] = True
    want = jr.tangent_bug_plan(blocked, (2, 10), (18, 10), sensor_range=5.0)
    got = tr.tangent_bug_plan(blocked, (2, 10), (18, 10), sensor_range=5.0)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


HYBRID = dict(n_theta=8, steer_angles=(-0.6, 0.0, 0.6))


@functools.lru_cache(maxsize=None)
def jax_hybrid(goal_bin):
    blocked = np.zeros((32, 32), dtype=bool)
    blocked[14:18, 4:28] = True
    return blocked, np.asarray(jh.hybrid_astar_costs(jnp.asarray(~blocked), jnp.array([16, 30]),
                                                     goal_theta_bin=goal_bin, **HYBRID))


@pytest.mark.parametrize("goal_bin", [2, 4])
def test_hybrid_astar_costs_and_path_match_jax(goal_bin):
    """tests/test_hybrid_astar.py's wall on a 32² map (the JAX test's 40²)
    with 8 headings and 3 steering angles (its 16 and 5: JAX compiles a
    roll per heading and primitive, which sets this test's time there)."""
    blocked, want = jax_hybrid(goal_bin)
    got = th.hybrid_astar_costs(~blocked, (16, 30), goal_bin, dtype=F64, device="cpu", **HYBRID)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got.numpy()), fin)
    close(got.numpy()[fin], want[fin])
    ws, wm, wc = jh.extract_hybrid_path(want, ~blocked, (16, 2), start_theta_bin=2, **HYBRID)
    gs, gm, gc = th.extract_hybrid_path(got, ~blocked, (16, 2), start_theta_bin=2, **HYBRID)
    assert len(ws) > 10
    assert np.array_equal(gs, ws) and gc == pytest.approx(wc, abs=1e-12)


def test_lattice_matches_jax():
    poses = jax.jit(jl.integrate_curvature_poly)(jnp.array([5.0, 0.3, -0.2]), 0.1)
    close(tl.integrate_curvature_poly(t64([5.0, 0.3, -0.2]), 0.1), poses)
    # optimize_trajectory over a lookup table's targets (vmapped in JAX)
    want = jax.jit(lambda: jl.generate_lookup_table([4.0, 6.0], [-1.0, 1.0], [0.0, 0.3]))()
    got = tl.generate_lookup_table([4.0, 6.0], [-1.0, 1.0], [0.0, 0.3], dtype=F64, device="cpu")
    close(got[0], want[0], 1e-10)
    close(got[2], want[2])
    assert float(got[1].max()) < 1e-3
    solo = tl.optimize_trajectory(got[2][5], dtype=F64, device="cpu")
    assert torch.equal(solo[0], got[0][5])

    want = jax.jit(lambda: jl.state_lattice_plan(jnp.array([8.0, 0.0, 0.0]), jnp.array([[4.0, 0.0]]),
                                                 jnp.array([0.6]), n_lateral=5, n_yaw=3,
                                                 lateral_spread=4.0))()
    got = tl.state_lattice_plan([8.0, 0.0, 0.0], [[4.0, 0.0]], [0.6], n_lateral=5, n_yaw=3,
                                lateral_spread=4.0, dtype=F64, device="cpu")
    close(got[1], want[1], 1e-10)
    close(got[0], want[0], 1e-10)

    want = jax.jit(lambda t: jl.clothoid_path(t, iterations=20))(jnp.array([5.0, 2.0, 0.6]))
    got = tl.clothoid_path([5.0, 2.0, 0.6], iterations=20, dtype=F64, device="cpu")
    close(got[1], want[1], 1e-10)
    assert float(got[2]) < 5e-3


def test_chomp_and_bipedal_match_jax():
    cfg = jch.ChompConfig(n_waypoints=30, max_iterations=40)
    tcfg = tch.ChompConfig(n_waypoints=30, max_iterations=40)
    want = jch.chomp_optimize(jnp.array([0.0, 0.0]), jnp.array([10.0, 0.0]),
                              jnp.array([[5.0, 0.0]]), jnp.array([1.0]), cfg)
    got = tch.chomp_optimize([0.0, 0.0], [10.0, 0.0], [[5.0, 0.0]], [1.0], tcfg, dtype=F64,
                             device="cpu")
    assert int(got[2]) == int(want[2])
    close(got[0], want[0], 1e-10)
    close(got[1], want[1], 1e-9)

    steps = np.array([[0.0, 0.2, 0.0]] + [[0.3, 0.2, 0.1]] * 4 + [[0.0, 0.2, 0.0]])
    want = jb.bipedal_plan(jnp.asarray(steps), jb.BipedalConfig(time_split=50))
    got = tb.bipedal_plan(steps, tb.BipedalConfig(time_split=50), dtype=F64, device="cpu")
    for k in want:
        close(got[k], want[k], 1e-11)
    lanes = tb.bipedal_plan(t64(np.stack([steps, steps[::-1].copy()])),
                            tb.BipedalConfig(time_split=50))
    assert torch.equal(lanes["com_trajectory"][0], got["com_trajectory"])
