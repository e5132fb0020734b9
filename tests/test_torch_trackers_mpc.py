"""The trackers, the nonlinear laws, the CBF filter, ADMM and the linear MPC
(`control/{trackers,nonlinear,cbf,admm,mpc}.py`) against the JAX
package's: JAX on the CPU at x64 under `jax.jit`, torch in float64 on the
CPU, on seeded numpy inputs.

Tolerances: indices and flags exactly; float64 values at 1e-9 (the
measured differences are rounding: a jitted XLA fuses products into
multiply-adds and sums in its own order), the MPC's 80 projected-gradient
steps at 1e-8, and one float32 run of each batched law at 2e-5 against
JAX's float64. A fleet runs as one batch in torch and as `jax.vmap` of the
single-vehicle law in JAX; a lane of the fleet must equal its solo run
bitwise. The paths are smooth curves sampled with a seeded offset, so no
two path points tie for the nearest one, and the DARE's convergence test
(max |ΔP| < 0.01) stays far from its threshold on these states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.control import admm as ja
from rust_robotics_tpu.control import cbf as jc
from rust_robotics_tpu.control import mpc as jm
from rust_robotics_tpu.control import nonlinear as jn
from rust_robotics_tpu.control import trackers as jt
from rust_robotics_tpu_torch.control import admm as ta
from rust_robotics_tpu_torch.control import cbf as tc
from rust_robotics_tpu_torch.control import mpc as tm
from rust_robotics_tpu_torch.control import nonlinear as tn
from rust_robotics_tpu_torch.control import trackers as tt

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


def path(n=201, seed=0):
    """A sine course with a small seeded jitter along x."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 40.0, n) + rng.uniform(-0.01, 0.01, n)
    return np.stack([xs, 2.0 * np.sin(xs / 8.0)], axis=-1), np.ones(n)


def states(b, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.0, 38.0, b), rng.uniform(-2.5, 2.5, b),
                     rng.uniform(-0.6, 0.6, b), rng.uniform(0.5, 4.0, b)], axis=-1)


TRACKERS = {
    "pure_pursuit": (jt.pure_pursuit_control, tt.pure_pursuit_control),
    "stanley": (jt.stanley_control, tt.stanley_control),
    "rear_wheel_feedback": (jt.rear_wheel_feedback_control, tt.rear_wheel_feedback_control),
}


@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_path_trackers_match_jax_over_a_fleet(name):
    jfn, tfn = TRACKERS[name]
    pts, mask = path()
    s = states(16)
    want = jax.jit(jax.vmap(lambda st: jfn(st, jnp.asarray(pts), jnp.asarray(mask), 3.0)))(
        jnp.asarray(s))
    got = tfn(t64(s), t64(pts), t64(mask), 3.0)
    close(got[0], want[0])
    close(got[1], want[1])
    exact(got[2], want[2])
    # a lane equals its solo run, bit for bit, in float32
    f32 = tfn(torch.tensor(s, dtype=torch.float32), torch.tensor(pts, dtype=torch.float32),
              torch.tensor(mask, dtype=torch.float32), 3.0)
    solo = tfn(torch.tensor(s[5], dtype=torch.float32), torch.tensor(pts, dtype=torch.float32),
               torch.tensor(mask, dtype=torch.float32), 3.0)
    assert all(torch.equal(a[5], b) for a, b in zip(f32, solo))
    close(f32[1], want[1], atol=2e-5)


def test_lqr_steer_and_dare_match_jax():
    pts, mask = path()
    s = states(12, seed=2)
    rng = np.random.default_rng(3)
    pe, pth = rng.normal(0, 0.2, 12), rng.normal(0, 0.1, 12)
    cfg = jt.LQRSteerConfig(wheelbase=2.9)
    want = jax.jit(jax.vmap(lambda st, e0, t0: jt.lqr_steer_control(
        st, jnp.asarray(pts), jnp.asarray(mask), 3.0, e0, t0, cfg)))(
        jnp.asarray(s), jnp.asarray(pe), jnp.asarray(pth))
    tcfg = tt.LQRSteerConfig(wheelbase=2.9)
    got = tt.lqr_steer_control(t64(s), t64(pts), t64(mask), 3.0, t64(pe), t64(pth), tcfg)
    close(got[0], want[0])
    close(got[1], want[1])
    close(got[2][0], want[2][0])
    close(got[2][1], want[2][1])
    solo = tt.lqr_steer_control(t64(s[4]), t64(pts), t64(mask), 3.0, t64(pe[4]), t64(pth[4]),
                                tcfg)
    assert torch.equal(got[1][4], solo[1])
    # the DARE alone, lanes of other speeds stopping at other iterations
    a = np.tile(np.eye(4), (3, 1, 1))
    a[:, 0, 1] = a[:, 2, 3] = 0.1
    a[:, 1, 2] = [0.5, 2.0, 6.0]
    a[:, 1, 1] = a[:, 3, 3] = 0.0
    b = np.zeros((3, 4, 1))
    b[:, 3, 0] = np.array([0.5, 2.0, 6.0]) / 2.9
    want = jax.jit(jax.vmap(lambda aa, bb: jt.solve_dare(aa, bb, jnp.eye(4), jnp.eye(1))))(
        jnp.asarray(a), jnp.asarray(b))
    got = tt.solve_dare(t64(a), t64(b), torch.eye(4, dtype=F64), torch.eye(1, dtype=F64))
    close(got, want, atol=1e-8)
    close(tt.path_curvatures(t64(pts), t64(mask)),
          jax.jit(jt.path_curvatures)(jnp.asarray(pts), jnp.asarray(mask)))


def test_kinematics_pid_and_move_to_pose_match_jax():
    rng = np.random.default_rng(4)
    s = states(8, seed=5)
    accel, steer = rng.normal(0, 1, 8), rng.normal(0, 0.3, 8)
    close(tt.bicycle_kinematics(t64(s), t64(accel), t64(steer), 0.1, 2.9),
          jax.jit(jt.bicycle_kinematics, static_argnums=(3, 4))(
              jnp.asarray(s), jnp.asarray(accel), jnp.asarray(steer), 0.1, 2.9))
    close(tt.rear_axle(t64(s), 2.9), jax.jit(jt.rear_axle, static_argnums=1)(jnp.asarray(s), 2.9))
    pts, mask = path(50)
    close(tt.path_yaws(t64(pts), t64(mask)), jt.path_yaws(jnp.asarray(pts), jnp.asarray(mask)))

    cfg = jt.PIDConfig(kp=1.5, ki=0.3, kd=0.05, dt=0.1)
    tcfg = tt.PIDConfig(kp=1.5, ki=0.3, kd=0.05, dt=0.1)
    errors = rng.normal(0, 3.0, (30, 4))
    js = jt.pid_reset((4,), jnp.float64)
    ts = tt.pid_reset((4,), F64, device="cpu")
    jstep = jax.jit(jt.pid_step, static_argnums=2)
    for e in errors:
        js, jout = jstep(js, jnp.asarray(e), cfg)
        ts, tout = tt.pid_step(ts, t64(e), tcfg)
        close(tout, jout)
    close(ts[0], js[0])

    pose = np.stack([rng.uniform(-5, 5, 16), rng.uniform(-5, 5, 16), rng.uniform(-3, 3, 16)], -1)
    goal = np.stack([rng.uniform(-5, 5, 16), rng.uniform(-5, 5, 16), rng.uniform(-3, 3, 16)], -1)
    want = jax.jit(jt.move_to_pose_control)(jnp.asarray(pose), jnp.asarray(goal))
    got = tt.move_to_pose_control(t64(pose), t64(goal))
    close(got[0], want[0])
    close(got[1], want[1])


def test_nonlinear_laws_match_jax():
    rng = np.random.default_rng(6)
    e, ed = rng.normal(0, 0.3, 64), rng.normal(0, 0.3, 64)
    close(tn.sliding_mode_control(t64(e), t64(ed))[0],
          jax.jit(jn.sliding_mode_control)(jnp.asarray(e), jnp.asarray(ed))[0])
    pose = np.stack([rng.normal(0, 2, 64), rng.normal(0, 2, 64), rng.uniform(-3, 3, 64)], -1)
    txy, tv = rng.normal(0, 2, (64, 2)), rng.normal(0, 1, (64, 2))
    for got, want in zip(tn.feedback_linearization_control(t64(pose), t64(txy), t64(tv)),
                         jax.jit(jn.feedback_linearization_control)(
                             jnp.asarray(pose), jnp.asarray(txy), jnp.asarray(tv))):
        close(got, want)
    ref = pose + rng.normal(0, 0.5, pose.shape)
    rv, rw = rng.uniform(0.5, 2, 64), rng.normal(0, 0.5, 64)
    for got, want in zip(tn.backstepping_control(t64(pose), t64(ref), t64(rv), t64(rw)),
                         jax.jit(jn.backstepping_control)(
                             jnp.asarray(pose), jnp.asarray(ref), jnp.asarray(rv),
                             jnp.asarray(rw))):
        close(got, want)


def test_cbf_filter_matches_jax_and_keeps_the_barrier():
    """tests/test_control_misc.py's run for 60 steps, step by step."""
    cfg = jc.CBFConfig(alpha=2.0)
    tcfg = tc.CBFConfig(alpha=2.0)
    obstacles, radii = np.array([[2.0, 0.0], [3.0, 1.5]]), np.array([1.0, 0.5])
    jfilter = jax.jit(jc.cbf_filter_single_integrator, static_argnums=4)
    jpos, tpos = jnp.zeros(2), torch.zeros(2, dtype=F64)
    for _ in range(60):
        ju = jfilter(jpos, jnp.array([1.5, 0.2]), jnp.asarray(obstacles), jnp.asarray(radii), cfg)
        tu = tc.cbf_filter_single_integrator(tpos, t64([1.5, 0.2]), t64(obstacles), t64(radii),
                                             tcfg)
        close(tu, ju)
        jpos, tpos = jpos + 0.05 * ju, tpos + 0.05 * tu
        assert float(torch.sum((tpos - t64(obstacles[0])) ** 2) - 1.0) > -0.05
    rng = np.random.default_rng(7)
    a, b = rng.normal(0, 1, (3, 2)), rng.normal(0, 1, 3)
    close(tc.solve_qp_dual(t64([0.3, -0.2]), t64(a), t64(b)),
          jax.jit(jc.solve_qp_dual)(jnp.array([0.3, -0.2]), jnp.asarray(a), jnp.asarray(b)))


def test_admm_consensus_formation_and_horizon_match_jax():
    rng = np.random.default_rng(8)
    targets, w = rng.normal(0, 3, (6, 2)), rng.uniform(0.5, 2, 6)
    cfg = ja.ADMMConfig(iterations=150)
    tcfg = ta.ADMMConfig(iterations=150)
    want = jax.jit(ja.solve_consensus, static_argnums=2)(jnp.asarray(targets), jnp.asarray(w),
                                                         cfg)
    got = ta.solve_consensus(t64(targets), t64(w), tcfg)
    for field in ("x", "z", "primal_residual", "dual_residual"):
        close(getattr(got, field), getattr(want, field))
    offsets = rng.normal(0, 1, (6, 2))
    want = jax.jit(ja.solve_formation_consensus)(jnp.asarray(targets), jnp.asarray(offsets))
    got = ta.solve_formation_consensus(t64(targets), t64(offsets))
    close(got[0], want[0])
    close(got[1], want[1])

    goals = rng.normal(0, 1, (4, 10, 2)) + np.linspace(0, 3, 10)[None, :, None]
    hcfg, thcfg = ja.ADMMConfig(iterations=120), ta.ADMMConfig(iterations=120)
    for anchor, weight, h in ((None, 0.0, 10), (np.array([0.1, -0.2]), 40.0, 10),
                              (np.array([0.1, -0.2]), 5.0, 1), (None, 3.0, 2)):
        g = goals[:, :h]
        want = jax.jit(ja.solve_horizon_consensus, static_argnums=(2, 3))(
            jnp.asarray(g), None if anchor is None else jnp.asarray(anchor), weight, hcfg)
        got = ta.solve_horizon_consensus(t64(g), None if anchor is None else t64(anchor), weight,
                                         thcfg)
        close(got[0], want[0], atol=1e-8)
        close(got[1].primal_residual, want[1].primal_residual, atol=1e-8)
        close(got[1].dual_residual, want[1].dual_residual, atol=1e-8)


def test_mpc_helpers_and_control_match_jax():
    rng = np.random.default_rng(9)
    # 2 x 40 projected-gradient steps (MPCConfig() takes 3 x 120)
    cfg = jm.MPCConfig(outer_iterations=2, qp_iterations=40)
    tcfg = tm.MPCConfig(outer_iterations=2, qp_iterations=40)
    s = np.stack([rng.uniform(0, 5, 6), rng.uniform(-1, 1, 6), rng.uniform(0.5, 3, 6),
                  rng.uniform(-0.5, 0.5, 6)], -1)
    u = rng.normal(0, 0.3, (6, 2))
    close(tm.bicycle_model(t64(s), t64(u), 0.2, 2.5),
          jax.jit(jm.bicycle_model, static_argnums=(2, 3))(jnp.asarray(s), jnp.asarray(u), 0.2,
                                                           2.5))
    got = tm.linear_model_matrices(t64(s[:, 2]), t64(s[:, 3]), t64(u[:, 1]), tcfg)
    want = jax.jit(jax.vmap(lambda v, p, d: jm.linear_model_matrices(v, p, d, cfg)))(
        jnp.asarray(s[:, 2]), jnp.asarray(s[:, 3]), jnp.asarray(u[:, 1]))
    for g, w in zip(got, want):
        close(g, w)

    cx = np.linspace(0, 30, 31)
    cy, cyaw = np.sin(cx / 5.0), np.cos(cx / 5.0) / 5.0
    sp = tm.calc_speed_profile(t64(cyaw), 10.0 / 3.6)
    close(sp, jm.calc_speed_profile(jnp.asarray(cyaw), 10.0 / 3.6))
    st = np.array([4.3, 0.7, 2.0, 0.1])
    ind = tm.nearest_index(t64(st), t64(cx), t64(cy), 2)
    exact(ind, jax.jit(jm.nearest_index)(jnp.asarray(st), jnp.asarray(cx), jnp.asarray(cy), 2))
    xref = tm.calc_ref_trajectory(t64(st), t64(cx), t64(cy), t64(cyaw), sp, ind, tcfg)
    close(xref, jax.jit(jm.calc_ref_trajectory, static_argnums=6)(
        jnp.asarray(st), jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cyaw),
        jnp.asarray(sp.numpy()), jnp.asarray(int(ind)), cfg))

    # mpc_control on a fleet: JAX vmaps the single-vehicle solve
    x0 = s[:4]
    refs = np.stack([np.stack([x[0] + 0.5 * np.arange(6), x[1] + 0.1 * np.arange(6),
                               np.full(6, 2.5), np.full(6, x[3] + 0.05)], -1) for x in x0])
    u0 = np.zeros((4, 5, 2))
    want = jax.jit(jax.vmap(lambda a, b, c: jm.mpc_control(a, b, c, cfg)[:2]))(
        jnp.asarray(x0), jnp.asarray(refs), jnp.asarray(u0))
    got = tm.mpc_control(t64(x0), t64(refs), t64(u0), tcfg)
    close(got[0], want[0], atol=1e-8)
    close(got[1], want[1], atol=1e-8)
    solo = tm.mpc_control(t64(x0[2]), t64(refs[2]), t64(u0[2]), tcfg)
    assert torch.equal(got[0][2], solo[0])
