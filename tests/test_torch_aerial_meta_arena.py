"""The aerial, meta and arena controllers (`control/{aerial,meta,arena}.py`)
against the JAX package's: JAX on the CPU at x64 (its loops under
`jax.jit`), torch in float64 on the CPU, on the JAX tests' problems
(tests/test_control_families.py::TestAerial, tests/test_meta_p2p.py,
tests/test_aux.py) at their sizes or shorter, as stated.

Tolerances: float64 within 1e-12 where a few operations separate the
values, 1e-9 relative for the minimum-snap solve (its system's powers of
t reach t⁷) and the closed loops (JAX's compiled loop bodies fuse
multiply-adds); float32 against the float64 reference as stated beside
each check; segment indices, latches and the arena's CSV exactly (the
gate ignores `_ms`). Fleet lanes equal their solo runs bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rust_robotics_tpu.control import aerial as ja
from rust_robotics_tpu.control import arena as jar
from rust_robotics_tpu.control import meta as jm
from rust_robotics_tpu.control import trackers as jt
from rust_robotics_tpu.utils.bench_gate import compare_csv as j_compare_csv
from rust_robotics_tpu_torch.control import aerial as ta
from rust_robotics_tpu_torch.control import arena as tar
from rust_robotics_tpu_torch.control import meta as tm
from rust_robotics_tpu_torch.control import trackers as tt
from rust_robotics_tpu_torch.utils.bench_gate import write_csv

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64, F32 = torch.float64, torch.float32
WPS = np.array([[0.0, 0.0, 1.0], [2.0, 1.0, 2.0], [4.0, -1.0, 1.5], [6.0, 0.0, 1.0]])


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, atol=1e-12, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def jax_flight():
    coeffs = jax.jit(ja.quintic_3d_segments, static_argnums=1)(jnp.asarray(WPS), 2.0)
    ps, refs = jax.jit(lambda c: ja.simulate_quadrotor(c, 2.0))(coeffs)
    return np.asarray(coeffs), np.asarray(ps), np.asarray(refs)


def test_quintic_flight_matches_jax_and_its_gates():
    coeffs, ps, refs = jax_flight()
    got = ta.quintic_3d_segments(t64(WPS), 2.0)
    close(got, coeffs)
    tps, trefs = ta.simulate_quadrotor(got, 2.0)
    assert tps.shape == (300, 3)
    close(tps, ps, 1e-12)
    close(trefs, refs, 1e-12)
    # tests/test_control_families.py's gates
    assert float(torch.linalg.vector_norm(tps - trefs, dim=-1).max()) < 0.3
    close(tps[-1], WPS[-1], 0.2)
    # position, velocity and acceleration of one segment at a local time
    want = jax.jit(ja.eval_quintic_3d)(jnp.asarray(coeffs), jnp.asarray(1), jnp.asarray(0.7))
    for g, w in zip(ta.eval_quintic_3d(got, 1, 0.7), want):
        close(g, w, 1e-12)
    # float32: the flight within 1e-5 m of the float64 reference
    p32, _ = ta.simulate_quadrotor(ta.quintic_3d_segments(torch.tensor(WPS, dtype=F32), 2.0), 2.0)
    close(p32, ps, 1e-5)


def test_quadrotor_fleet_lanes_bitwise_their_solo_flights():
    rng = np.random.default_rng(3)
    wps = np.stack([WPS, WPS + rng.uniform(-0.5, 0.5, WPS.shape), WPS[::-1].copy()])
    coeffs = ta.quintic_3d_segments(t64(wps), 2.0)
    ps, refs = ta.simulate_quadrotor(coeffs, 2.0, dt=0.05)
    for i in range(3):
        p1, r1 = ta.simulate_quadrotor(coeffs[i], 2.0, dt=0.05)
        assert torch.equal(ps[i], p1) and torch.equal(refs[i], r1)


def test_segment_index_is_a_true_division():
    """A step on a segment boundary belongs to the next segment: t = 0.3
    with segment_time 0.1 is segment 3, which a product by the reciprocal
    (CUDA's division by a number) puts at 2.999... -> 2."""
    coeffs = ta.quintic_3d_segments(t64(np.arange(15.0).reshape(5, 3)), 0.1)
    ps, refs = ta.simulate_quadrotor(coeffs, 0.1, dt=0.1)
    jps, jrefs = jax.jit(lambda c: ja.simulate_quadrotor(c, 0.1, dt=0.1))(jnp.asarray(
        coeffs.numpy()))
    close(refs, jrefs, 1e-12)
    close(ps, jps, 1e-12)


def test_minimum_snap_matches_jax_and_interpolates():
    w, ts = np.array([0.0, 1.0, -0.5, 2.0]), np.array([1.0, 1.0, 1.5])
    want = np.asarray(jax.jit(ja.minimum_snap_coeffs)(jnp.asarray(w), jnp.asarray(ts)))
    got = ta.minimum_snap_coeffs(t64(w), t64(ts))
    close(got, want, 1e-9 * np.abs(want).max())
    poly8 = jax.jit(jax.vmap(ja.eval_poly8, (None, 0, None)), static_argnums=2)
    for i in range(3):
        for order in range(3):
            t = np.array([0.0, 0.37, ts[i]])
            close(ta.eval_poly8(got[i], t64(t), order),
                  poly8(jnp.asarray(want[i]), jnp.asarray(t), order), 1e-9)
        close(ta.eval_poly8(got[i], 0.0), w[i], 1e-7)
        close(ta.eval_poly8(got[i], ts[i]), w[i + 1], 1e-7)
    close(ta.eval_poly8(got[0], ts[0], 1), ta.eval_poly8(got[1], 0.0, 1), 1e-6)
    # batched evaluation: the three segments at once
    close(ta.eval_poly8(got, t64([0.2, 0.4, 0.6]), 2),
          [ta.eval_poly8(got[i], v, 2) for i, v in enumerate((0.2, 0.4, 0.6))], 1e-15)
    # float32 against the float64 solve
    close(ta.minimum_snap_coeffs(torch.tensor(w, dtype=F32), torch.tensor(ts, dtype=F32)), want,
          2e-4)


def test_meta_select_hysteresis_matches_jax():
    use, ema = jnp.asarray(False), jnp.asarray(0.0)
    tuse, tema = torch.tensor(False), torch.zeros((), dtype=F64)
    for err in [2.0] * 40 + [0.05] * 60:
        use, ema = jm.meta_select(use, ema, jnp.asarray(err))
        tuse, tema = tm.meta_select(tuse, tema, torch.tensor(err, dtype=F64))
        assert bool(use) == bool(tuse)
        close(tema, ema, 1e-15)
    assert not bool(tuse)


def _meta_course(n=401):
    xs = np.linspace(0.0, 40.0, n)
    return np.stack([xs, 2.0 * np.sin(xs / 8.0)], -1), np.ones(n)


def test_meta_control_closed_loop_matches_jax():
    pts, mask = _meta_course()
    jp, jmk = jnp.asarray(pts), jnp.asarray(mask)

    @jax.jit
    def jstep(state, use, ema):
        a, s, use, ema = jm.meta_control_step(
            state, jp, jmk, 3.0, use, ema,
            lambda q: jt.pure_pursuit_control(q, jp, jmk, 3.0),
            lambda q: jt.stanley_control(q, jp, jmk, 3.0))
        return jt.bicycle_kinematics(state, a, s, 0.1, 2.9), use, ema

    tp, tmk = t64(pts), t64(mask)
    state, use, ema = jnp.array([0.0, -1.0, 0.2, 1.0]), jnp.asarray(False), jnp.asarray(0.0)
    tstate = t64([0.0, -1.0, 0.2, 1.0])
    tuse, tema = torch.tensor(False), torch.zeros((), dtype=F64)
    for _ in range(60):
        state, use, ema = jstep(state, use, ema)
        a, s, tuse, tema = tm.meta_control_step(
            tstate, tp, tmk, 3.0, tuse, tema,
            lambda q: tt.pure_pursuit_control(q, tp, tmk, 3.0),
            lambda q: tt.stanley_control(q, tp, tmk, 3.0))
        tstate = tt.bicycle_kinematics(tstate, a, s, 0.1, 2.9)
        assert bool(use) == bool(tuse)
    close(tstate, state, 1e-9)
    close(tema, ema, 1e-9)


@functools.lru_cache(maxsize=None)
def jax_speed_steer(steps):
    cfg = jm.LQRSpeedSteerConfig(wheelbase=2.9)
    xs = np.linspace(0.0, 50.0, 501)
    pts = np.stack([xs, 2.0 * np.sin(xs / 10.0)], -1)

    def step(carry, _):
        state, pe, pth = carry
        a, s, (e, th) = jm.lqr_speed_steer_control(state, jnp.asarray(pts), jnp.ones(501),
                                                   jnp.full((501,), 2.5), pe, pth, cfg)
        return (jt.bicycle_kinematics(state, a, s, cfg.dt, cfg.wheelbase), e, th), state

    run = jax.jit(lambda s0: jax.lax.scan(step, (s0, jnp.asarray(0.0), jnp.asarray(0.0)), None,
                                          length=steps)[1])
    return pts, np.asarray(run(jnp.array([0.0, -0.5, 0.1, 0.5])))


def test_lqr_speed_steer_matches_jax_and_fleet_lanes_are_solo():
    steps = 40
    pts, want = jax_speed_steer(steps)
    cfg = tm.LQRSpeedSteerConfig(wheelbase=2.9)
    p, mask, sp = t64(pts), torch.ones(501, dtype=F64), torch.full((501,), 2.5, dtype=F64)
    state, pe, pth = t64([0.0, -0.5, 0.1, 0.5]), torch.zeros((), dtype=F64), torch.zeros(
        (), dtype=F64)
    traj = []
    for _ in range(steps):
        traj.append(state)
        a, s, (pe, pth) = tm.lqr_speed_steer_control(state, p, mask, sp, pe, pth, cfg)
        state = tt.bicycle_kinematics(state, a, s, cfg.dt, cfg.wheelbase)
    close(torch.stack(traj), want, 1e-9)
    # a fleet of four vehicles: each lane bitwise its solo call
    fleet = t64([[0.0, -0.5, 0.1, 0.5], [5.0, 1.0, -0.2, 2.0], [20.0, 0.0, 0.3, 3.0],
                 [1.0, 0.2, 0.0, 0.0]])
    prev = t64([0.1, -0.2, 0.0, 0.3])
    got = tm.lqr_speed_steer_control(fleet, p, mask, sp, prev, -prev, cfg)
    for i in range(4):
        solo = tm.lqr_speed_steer_control(fleet[i], p, mask, sp, prev[i], -prev[i], cfg)
        assert torch.equal(got[0][i], solo[0]) and torch.equal(got[1][i], solo[1])
        assert torch.equal(got[2][0][i], solo[2][0]) and torch.equal(got[2][1][i], solo[2][1])


def test_controller_arena_matches_jax_and_its_csv_gate(tmp_path):
    steps = 80
    want, (jh, jrows) = jar.run_controller_arena(steps=steps)
    got, (th, trows) = tar.run_controller_arena(steps=steps, dtype=F64, device="cpu")
    assert set(got) == {"pure_pursuit", "stanley", "lqr_steer"} and th == jh
    for name in want:
        assert got[name]["goal_reached"] == want[name]["goal_reached"]
        for k in ("cross_track_rmse", "max_cross_track", "progress"):
            close(got[name][k], want[name][k], 1e-9)
    # the port's CSV passes the gate against the JAX package's (wall
    # clock ignored), under both packages' gates
    a = open(write_csv(tmp_path / "jax.csv", jh, jrows)).read()
    b = open(write_csv(tmp_path / "torch.csv", th, trows)).read()
    assert j_compare_csv(a, b) == []
    assert all(row[-1] > 0.0 for row in trows)  # elapsed_ms read after a sync
