"""MPPI, its variants, the terminal-value machinery, gate racing and the
pusher-slider (`control/{mppi,mppi_variants,mppi_value,racing,
pusher_slider}.py`) against the JAX package's: JAX on the CPU at x64, its
pure functions under `jax.jit`, torch in float64 on the CPU, on seeded
numpy inputs.

The port takes MPPI's noise as `draws=`: each test builds the standard
normals JAX draws from its keys (split as `simulate_gate_race` and
`simulate_push` split them) and hands them over. The closed loops run
2–3 steps at K ≤ 32 samples and H ≤ 6 (the JAX tests run 40–120 steps),
with JAX's `mppi_plan` jitted inside them.

Tolerances: faces, modes, gate counts, cells and indices exactly; float64
values at 1e-9. Discrete choices that turn on a float (the best face, the
gate crossing, the nearest centerline sample, the two-contact mode) are
taken on inputs whose margins are far above rounding: the per-face costs
differ by more than 1e-3, the seeded rollouts keep off the gate planes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.control import mppi as jm
from rust_robotics_tpu.control import mppi_value as jv
from rust_robotics_tpu.control import mppi_variants as jmv
from rust_robotics_tpu.control import pusher_slider as jp
from rust_robotics_tpu.control import racing as jr
from rust_robotics_tpu_torch.control import mppi as tm
from rust_robotics_tpu_torch.control import mppi_value as tv
from rust_robotics_tpu_torch.control import mppi_variants as tmv
from rust_robotics_tpu_torch.control import pusher_slider as tp
from rust_robotics_tpu_torch.control import racing as tr

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-9
F64 = torch.float64


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def normals(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


@functools.lru_cache(maxsize=None)
def j_mppi(dynamics, stage, terminal, cfg):
    return jax.jit(lambda k, s, u: jm.mppi_plan(k, dynamics, stage, terminal, s, u, cfg))


def test_mppi_plan_goal_costs_and_fleet_match_jax():
    cfg = jm.MPPIConfig(horizon=6, num_samples=32)
    tcfg = tm.MPPIConfig(horizon=6, num_samples=32)
    obstacles = np.array([[1.0, 1.2], [2.5, 0.5], [3.0, 3.0]])
    goal = np.array([4.0, 3.5])
    jstage, jterm = jm.make_goal_costs(jnp.asarray(goal), jnp.asarray(obstacles), 0.6)
    tstage, tterm = tm.make_goal_costs(t64(goal), t64(obstacles), 0.6)
    rng = np.random.default_rng(0)
    states = np.concatenate([rng.uniform(0, 2, (3, 2)), rng.normal(0, 0.3, (3, 2))], -1)
    u0 = rng.normal(0, 0.2, (3, 6, 2))
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    draws = np.stack([normals(k, (32, 6, 2)) for k in keys])
    got = tm.mppi_plan(None, tm.double_integrator_dynamics, tstage, tterm, t64(states), t64(u0),
                       tcfg, draws=t64(draws))
    plan = j_mppi(jm.double_integrator_dynamics, jstage, jterm, cfg)
    for lane in range(3):
        want = plan(keys[lane], jnp.asarray(states[lane]), jnp.asarray(u0[lane]))
        close(got[0][lane], want[0])
        close(got[1][lane], want[1])
        close(got[2].best_cost[lane], want[2].best_cost)
        close(got[2].mean_cost[lane], want[2].mean_cost)
        close(got[2].effective_sample_size[lane], want[2].effective_sample_size)
    solo = tm.mppi_plan(None, tm.double_integrator_dynamics, tstage, tterm, t64(states[1]),
                        t64(u0[1]), tcfg, draws=t64(draws[1]))
    assert torch.equal(solo[0], got[0][1])
    close(tm.shift_nominal(t64(u0[0])), jm.shift_nominal(jnp.asarray(u0[0])))
    close(tm.shift_nominal(t64(u0[0]), t64([0.5, -0.5])),
          jm.shift_nominal(jnp.asarray(u0[0]), jnp.array([0.5, -0.5])))
    # a generator draws its own noise, on the state's device
    g = torch.Generator().manual_seed(0)
    out = tm.mppi_plan(g, tm.double_integrator_dynamics, tstage, tterm, t64(states[0]),
                       t64(u0[0]), tcfg)
    assert out[0].shape == (6, 2) and bool(torch.isfinite(out[0]).all())


def test_person_following_and_racing_costs_match_jax():
    rng = np.random.default_rng(1)
    target = np.stack([np.linspace(0, 3, 6), 0.5 * np.sin(np.linspace(0, 3, 6))], -1)
    x = rng.normal(0, 1.5, (40, 4))
    u = rng.normal(0, 0.5, (40, 2))
    th = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    centerline = np.stack([3 * np.cos(th), 2 * np.sin(th)], -1) + rng.normal(0, 1e-3, (40, 2))
    pairs = ((jmv.make_person_following_costs(jnp.asarray(target)),
              tmv.make_person_following_costs(t64(target))),
             (jmv.make_racing_costs(jnp.asarray(centerline)),
              tmv.make_racing_costs(t64(centerline))))
    for (js, jt), (ts, tt) in pairs:
        close(ts(t64(x), t64(u)), jax.jit(js)(jnp.asarray(x), jnp.asarray(u)))
        close(tt(t64(x)), jax.jit(jt)(jnp.asarray(x)))
    close(tmv.lap_progress(t64(x), t64(centerline)),
          jax.jit(jmv.lap_progress)(jnp.asarray(x), jnp.asarray(centerline)))


def test_value_grids_and_tracks_match_jax():
    rng = np.random.default_rng(2)
    g = tv.grid_from_goal_distance(9, 7, (-1.0, -0.5), 0.5, (2.3, 1.1), dtype=F64, device="cpu")
    gj = jax.jit(jv.grid_from_goal_distance, static_argnums=(0, 1, 3))(
        9, 7, jnp.array([-1.0, -0.5]), 0.5, jnp.array([2.3, 1.1]))
    close(g.values, gj.values)
    xy = rng.uniform(-3, 5, (50, 2))
    close(tv.grid_value_at(g, t64(xy)), jax.jit(jv.grid_value_at)(gj, jnp.asarray(xy)))
    vals = jax.jit(jv.grid_value_at)(gj, jnp.asarray(xy))
    close(tv.grid_value_at(g, t64(xy[0])), vals[0])  # a single point: the 0-d gathers
    exact(tv.nearest_cell_indices(g, t64(xy)), jax.jit(jv.nearest_cell_indices)(gj, jnp.asarray(xy)))
    vj = jv.make_value_terminal_cost(gj, 3.0, lambda s: jnp.sum(s[..., 2:] ** 2, -1))
    vt = tv.make_value_terminal_cost(g, 3.0, lambda s: torch.sum(s[..., 2:] ** 2, -1))
    states = rng.normal(0, 2, (20, 4))
    close(vt(t64(states)), jax.jit(vj)(jnp.asarray(states)))

    wps = [[0.0, 0.0], [4.0, 0.0], [4.0, 3.0], [7.0, 5.0]]
    track, trackj = tv.make_track(wps, dtype=F64, device="cpu"), jv.make_track(wps)
    close(tv.track_total_length(track), jv.track_total_length(trackj))
    projected = jax.jit(jv.track_project)(trackj, jnp.asarray(xy))
    for got, want in zip(tv.track_project(track, t64(xy)), projected):
        close(got, want)
    close(tv.track_remaining_distance(track, t64(xy[3])),
          np.maximum(float(jv.track_total_length(trackj)) - float(projected[0][3]), 0.0))
    close(tv.track_terminal_value_grid(track, 12, 9, (-1.0, -1.0), 0.75, 1.5, 2.0).values,
          jax.jit(jv.track_terminal_value_grid, static_argnums=(1, 2, 4, 5, 6))(
              trackj, 12, 9, jnp.array([-1.0, -1.0]), 0.75, 1.5, 2.0).values)
    with pytest.raises(ValueError):
        tv.ValueUpdateConfig(learning_rate=0.0).validate()


def test_value_updates_and_replay_match_jax():
    """Rollouts that revisit cells, so the sequential visits compose."""
    rng = np.random.default_rng(3)
    g = tv.grid_from_goal_distance(8, 8, (0.0, 0.0), 0.5, (3.0, 3.0), dtype=F64, device="cpu")
    gj = jv.grid_from_goal_distance(8, 8, (0.0, 0.0), 0.5, (3.0, 3.0))
    costs = rng.uniform(0, 2, 10)
    close(tv.discounted_cost_to_go(t64(costs), 0.9), jv.discounted_cost_to_go(jnp.asarray(costs),
                                                                               0.9))
    states = np.repeat(rng.uniform(0, 4, (5, 4)), 2, axis=0)  # every cell twice
    valid = np.arange(10) != 7
    cfg = jv.ValueUpdateConfig(learning_rate=0.5, discount=0.9)
    tcfg = tv.ValueUpdateConfig(learning_rate=0.5, discount=0.9)
    got = tv.update_grid_from_rollout(g, t64(states), t64(costs), tcfg, torch.tensor(valid))
    want = jax.jit(jv.update_grid_from_rollout, static_argnums=3)(
        gj, jnp.asarray(states), jnp.asarray(costs), cfg, jnp.asarray(valid))
    close(got[0].values, want[0].values)
    for key in want[1]:
        close(got[1][key], want[1][key])

    buf, bufj = tv.make_replay_buffer(3, 10, 4, dtype=F64, device="cpu"), jv.make_replay_buffer(
        3, 10, 4)
    for i in range(4):  # wraps: the oldest rollout is overwritten
        s, c = rng.uniform(0, 4, (10, 4)), rng.uniform(0, 2, 10)
        buf, bufj = tv.replay_push(buf, t64(s), t64(c)), jv.replay_push(bufj, jnp.asarray(s),
                                                                          jnp.asarray(c))
    exact(buf.head, bufj.head)
    exact(buf.count, bufj.count)
    close(buf.states, bufj.states)
    got = tv.replay_update_grid(buf, g, tcfg)
    want = jax.jit(jv.replay_update_grid, static_argnums=2)(bufj, gj, cfg)
    close(got[0].values, want[0].values)
    for key in want[1]:
        close(got[1][key], want[1][key])
    half = tv.make_replay_buffer(4, 10, 4, dtype=F64, device="cpu")
    half = tv.replay_push(half, t64(s), t64(c))
    halfj = jv.replay_push(jv.make_replay_buffer(4, 10, 4), jnp.asarray(s), jnp.asarray(c))
    close(tv.replay_update_grid(half, g, tcfg)[0].values,
          jax.jit(jv.replay_update_grid, static_argnums=2)(halfj, gj, cfg)[0].values)


def square_gates(radius=3.0, height=1.5, aperture=1.2):
    """demos/benchmarks.py's square lap."""
    out = []
    for center, normal in (((radius, 0.0, height), (0.0, 1.0, 0.0)),
                           ((0.0, radius, height), (-1.0, 0.0, 0.0)),
                           ((-radius, 0.0, height), (0.0, -1.0, 0.0)),
                           ((0.0, -radius, height), (1.0, 0.0, 0.0))):
        out.append((jr.GatePlane(center, normal, half_width=aperture, half_height=aperture),
                    tr.GatePlane(center, normal, half_width=aperture, half_height=aperture)))
    return [j for j, _ in out], [t for _, t in out]


def test_quad_powertrain_and_gate_costs_match_jax():
    rng = np.random.default_rng(4)
    p, tpar = jr.PowertrainParams(), tr.PowertrainParams()
    s0 = tr.powertrain_init(tr.hover_state(3.0, -3.0, 1.5, tpar.base, dtype=F64, device="cpu"),
                            tpar, soc=0.8)
    s0j = jr.powertrain_init(jr.hover_state(3.0, -3.0, 1.5, p.base), p, soc=0.8)
    close(s0, s0j)
    states = np.asarray(s0j) + np.concatenate(
        [rng.normal(0, 0.3, (30, 6)), rng.normal(0, 0.05, (30, 4)), rng.normal(0, 0.3, (30, 3)),
         np.zeros((30, 1)), rng.uniform(-1, 1, (30, 4)), rng.uniform(-0.5, 0.1, (30, 1)),
         rng.uniform(0, 0.4, (30, 1))], -1)
    states[:, 13] = rng.integers(0, 6, 30)
    cmd = rng.uniform(0, 6.5, (30, 4))
    for params, tparams in ((p, tpar), (jr.PowertrainParams.ideal(), tr.PowertrainParams.ideal()),
                            (jr.PowertrainParams(relax_build=0.5, relax_recover=0.2,
                                                 relax_coeff=0.3),
                             tr.PowertrainParams(relax_build=0.5, relax_recover=0.2,
                                                 relax_coeff=0.3))):
        close(tr.powertrain_step(tparams, t64(states), t64(cmd), 0.05),
              jax.jit(jr.powertrain_step, static_argnums=(0, 3))(params, jnp.asarray(states),
                                                                  jnp.asarray(cmd), 0.05))
        close(tr.effective_max_rotor(tparams, t64(states)),
              jr.effective_max_rotor(params, jnp.asarray(states)))
    close(tr.motor_quad_step(tpar.base, t64(states[:, :14]), t64(cmd), 0.01),
          jax.jit(jr.motor_quad_step, static_argnums=(0, 3))(p.base, jnp.asarray(states[:, :14]),
                                                             jnp.asarray(cmd), 0.01))
    jgates, tgates = square_gates()
    js, jt, jadv = jr.make_gate_lap_costs(jgates, hover_thrust=2.45)
    ts, tt, tadv = tr.make_gate_lap_costs(tgates, hover_thrust=2.45, dtype=F64, device="cpu")
    close(ts(t64(states), t64(cmd)), jax.jit(js)(jnp.asarray(states), jnp.asarray(cmd)))
    close(tt(t64(states)), jax.jit(jt)(jnp.asarray(states)))
    # crossings of gate 0's plane (y = 0 near x = 3), inside and outside
    prev = np.array([[3.0, -0.2, 1.5], [3.5, -0.1, 1.4], [5.0, -0.1, 1.5], [3.0, 0.3, 1.5]])
    new = prev + np.array([[0.0, 0.4, 0.0], [0.1, 0.3, 0.2], [0.0, 0.3, 0.0], [0.0, 0.3, 0.0]])
    idx = np.zeros(4)
    got, want = tadv(t64(prev), t64(new), t64(idx)), jax.jit(jadv)(jnp.asarray(prev),
                                                                   jnp.asarray(new),
                                                                   jnp.asarray(idx))
    exact(got[1], want[1])
    close(got[0], want[0])
    exact(got[1], [True, True, False, False])


@pytest.fixture
def jitted_mppi(monkeypatch):
    """JAX's closed loops call `mppi_plan` (`pusher_mppi_plan`) and the
    powertrain from the host each step; here they call their jitted selves."""
    monkeypatch.setattr(jr, "mppi_plan", jax.jit(jm.mppi_plan, static_argnums=(1, 2, 3, 6)))
    monkeypatch.setattr(jr, "powertrain_step", jax.jit(jr.powertrain_step, static_argnums=(0, 3)))
    monkeypatch.setattr(jr, "effective_max_rotor", jax.jit(jr.effective_max_rotor,
                                                           static_argnums=0))
    monkeypatch.setattr(jp, "pusher_mppi_plan",
                        jax.jit(jp.pusher_mppi_plan, static_argnums=(1, 4)))


def test_simulate_gate_race_matches_jax_for_two_steps(jitted_mppi):
    jgates, tgates = square_gates()
    steps, k, h = 2, 24, 5
    key = jax.random.PRNGKey(5)
    draws = np.stack([normals(kk, (k, h, 4)) for kk in jax.random.split(key, steps)])
    for aware, charge in ((True, 0.0), (False, 2.0)):
        kw = dict(start=(3.0, -3.0, 1.5), steps=steps, horizon=h, num_samples=k, aware=aware,
                  charge_weight=charge, charge_reserve=0.95)
        want = jr.simulate_gate_race(key, jgates, jr.PowertrainParams(), **kw)
        got = tr.simulate_gate_race(None, tgates, tr.PowertrainParams(), draws=t64(draws),
                                    dtype=F64, device="cpu", **kw)
        close(got["trajectory"], want["trajectory"])
        for name in ("gates_passed", "laps_completed", "saturation_fraction"):
            assert got[name] == want[name], name
        for name in ("mean_speed", "max_speed", "final_soc", "min_soc", "lap_fraction"):
            close(got[name], want[name])


def test_pusher_modes_twists_and_two_contacts_match_jax():
    rng = np.random.default_rng(6)
    p, tpar = jp.PusherSliderParams(), tp.PusherSliderParams()
    n = 64
    faces = rng.integers(0, 4, n)
    contact, push, tang = rng.uniform(-0.6, 0.6, n), rng.uniform(-0.1, 0.6, n), rng.normal(0, 0.3, n)
    pose = rng.normal(0, 1, (n, 3))
    want = jax.jit(jax.vmap(lambda f, c, v, w, q: jp.pusher_step(p, q, f, c, v, w, 0.1)))(
        jnp.asarray(faces), jnp.asarray(contact), jnp.asarray(push), jnp.asarray(tang),
        jnp.asarray(pose))
    got = tp.pusher_step(tpar, t64(pose), torch.tensor(faces), t64(contact), t64(push), t64(tang),
                         0.1)
    close(got[0], want[0])
    exact(got[1], want[1])
    assert len(set(np.asarray(want[1]).tolist())) == 4  # every mode occurs
    for face in range(4):
        for a, b in zip(tp.contact_frame(face, t64(contact[:5]), 0.5),
                        jp.contact_frame(face, jnp.asarray(contact[:5]), 0.5)):
            close(a, np.broadcast_to(b, a.shape))  # JAX's d and t do not broadcast
    twist, mode = tp.pusher_twist(tpar, 2, t64(0.1), t64(0.3), t64(-0.2))
    twist_j, mode_j = jp.pusher_twist(p, 2, jnp.asarray(0.1), jnp.asarray(0.3), jnp.asarray(-0.2))
    close(twist, twist_j)
    exact(mode, mode_j)

    cases = (((0, 2), (0.0, 0.0), (0.05, 0.05), (0.5, 0.5)),
             ((0, 1), (0.2, -0.1), (0.3, 0.2), (0.05, -0.1)),
             ((1, 3), (0.3, 0.3), (0.2, 0.25), (-0.4, 0.3)),
             ((0, 0), (0.1, -0.3), (0.4, 0.0), (0.2, 0.0)))
    j_two = jax.jit(jp.two_contact_twist, static_argnums=0)  # one compile, faces traced
    for faces2, contacts, pushes, tangs in cases:
        got = tp.two_contact_twist(tpar, faces2, contacts, pushes, tangs, dtype=F64,
                                   device="cpu")
        want = j_two(p, jnp.asarray(faces2), jnp.asarray(contacts), jnp.asarray(pushes),
                     jnp.asarray(tangs))
        close(got[0], want[0])
        exact(got[1], want[1])
        exact(got[2], want[2])
        # the step turns the body twist into the world frame
        th = 0.3
        step = tp.two_contact_step(tpar, t64([0.1, 0.2, th]), faces2, contacts, pushes, tangs,
                                   0.1)
        tw = np.asarray(want[0])
        close(step[0], [0.1 + (np.cos(th) * tw[0] - np.sin(th) * tw[1]) * 0.1,
                        0.2 + (np.sin(th) * tw[0] + np.cos(th) * tw[1]) * 0.1, th + tw[2] * 0.1])
    spin = tp.two_contact_twist(tpar, (0, 2), (0.0, 0.0), (0.05, 0.05), (0.5, 0.5), dtype=F64,
                                device="cpu")
    assert bool(spin[2]) and abs(float(spin[0][2])) > 0.1


def test_pusher_mppi_and_simulate_push_match_jax(jitted_mppi):
    p, tpar = jp.PusherSliderParams(), tp.PusherSliderParams()
    cfg = jp.PusherMppiConfig(horizon=6, num_samples=24)
    tcfg = tp.PusherMppiConfig(horizon=6, num_samples=24)
    obstacles = np.array([[0.8, 1.2]])
    key = jax.random.PRNGKey(7)
    face_draws = np.stack([normals(kk, (24, 6, 3)) for kk in jax.random.split(key, 4)])
    pose, goal = np.array([0.0, 0.0, 0.0]), np.array([1.2, 0.6, 0.0])
    want = jp.pusher_mppi_plan(key, p, jnp.asarray(pose), jnp.asarray(goal), cfg,
                               jnp.asarray(obstacles))
    got = tp.pusher_mppi_plan(None, tpar, pose, goal, tcfg, obstacles, draws=t64(face_draws),
                              dtype=F64, device="cpu")
    exact(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2])
    costs = np.sort(np.asarray(want[2]))
    assert costs[1] - costs[0] > 1e-3

    steps = 3
    draws = np.stack([np.stack([normals(kf, (24, 6, 3)) for kf in jax.random.split(ks, 4)])
                      for ks in jax.random.split(key, steps)])
    want = jp.simulate_push(key, p, jnp.asarray(pose), jnp.asarray(goal), steps, cfg,
                            jnp.asarray(obstacles))
    got = tp.simulate_push(None, tpar, pose, goal, steps, tcfg, obstacles, draws=t64(draws),
                           dtype=F64, device="cpu")
    close(got["trajectory"], want["trajectory"])
    exact(got["faces"], want["faces"])
    exact(got["modes"], want["modes"])
    for name in ("reached", "steps_used"):
        assert got[name] == want[name]
    close(got["final_position_error"], want["final_position_error"])
