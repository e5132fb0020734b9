"""iLQR/DDP and the LQR regulator, C/GMRES, the rocket landing and the arm
(`control/{trajopt,cgmres,rocket,arm}.py`) against the JAX package's: JAX
on the CPU at x64 under `jax.jit`, torch in float64 on the CPU, on seeded
numpy inputs and tests/test_control_misc.py's and test_cgmres_rocket.py's
problems.

Tolerances: flags, counts and paths exactly; float64 values at 1e-9, the
iterative solvers (300 projected-gradient steps, 200 IK steps, the
Riccati fixpoint) at 1e-8 or 1e-7 as stated (the measured differences are
rounding: the derivatives come from other autodiff systems, and a jitted
XLA sums in its own order). C/GMRES runs 2 closed-loop steps of the 1200 the JAX test
runs. The RRT* gets JAX's own draws (the uniforms of its split keys) and
plans on tests' sphere worlds, where no two nodes tie for the nearest and
no cost comparison is within rounding of a tie.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.control import arm as jarm
from rust_robotics_tpu.control import cgmres as jcg
from rust_robotics_tpu.control import rocket as jr
from rust_robotics_tpu.control import trajopt as jt
from rust_robotics_tpu_torch.control import arm as tarm
from rust_robotics_tpu_torch.control import cgmres as tcg
from rust_robotics_tpu_torch.control import rocket as tr
from rust_robotics_tpu_torch.control import trajopt as tt

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-9
F64 = torch.float64


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def j_pendulum(x, u, dt):
    thdd = 9.81 * jnp.sin(x[0]) + u[0]
    return jnp.array([x[0] + x[1] * dt, x[1] + thdd * dt])


def t_pendulum(x, u, dt):
    thdd = 9.81 * torch.sin(x[0]) + u[0]
    return torch.stack([x[0] + x[1] * dt, x[1] + thdd * dt])


def stage(x, u):
    return 0.5 * (x[0] ** 2 + 0.1 * x[1] ** 2 + 0.01 * u[0] ** 2)


def terminal(x):
    return 50.0 * (x[0] ** 2 + x[1] ** 2)


@functools.lru_cache(maxsize=None)
def jax_trajopt(use_ddp, x0):
    cfg = jt.ILQRConfig(iterations=ILQR_ITERATIONS)
    fn = jax.jit(lambda x: jt.ilqr_solve(j_pendulum, stage, terminal, x, jnp.zeros((30, 1)), 0.02,
                                         cfg, use_ddp=use_ddp))
    return fn(jnp.asarray(x0))


# from about the 8th iteration on, a step's cost improvement is itself
# rounding (1e-15), so whether it is taken is a tie, and the flat optimum's
# controls may then move by 1e-7 either way
ILQR_ITERATIONS = 6


def test_ilqr_and_ddp_match_jax_and_lanes_match_solo():
    """The pendulum of tests/test_control_misc.py at 30 knots, 6
    iterations; three problems in one batch."""
    x0s = ((0.5, 0.0), (0.8, 0.0), (-0.3, 0.4))
    cfg = tt.ILQRConfig(iterations=ILQR_ITERATIONS)
    us0 = torch.zeros((3, 30, 1), dtype=F64)
    for use_ddp, solve in ((False, tt.ilqr_solve), (True, tt.ddp_solve)):
        xs, us, cost = solve(t_pendulum, stage, terminal, t64(x0s), us0, 0.02, cfg)
        for lane, x0 in enumerate(x0s):
            wxs, wus, wcost = jax_trajopt(use_ddp, x0)
            close(cost[lane], wcost, atol=1e-12)
            close(xs[lane], wxs)
            close(us[lane], wus)
        assert float(cost[0]) < 10.0
    solo = tt.ilqr_solve(t_pendulum, stage, terminal, t64(x0s[1]), us0[0], 0.02, cfg)
    xs, us, cost = tt.ilqr_solve(t_pendulum, stage, terminal, t64(x0s), us0, 0.02, cfg)
    assert torch.equal(solo[1], us[1]) and torch.equal(solo[2], cost[1])


def test_lqr_regulator_matches_jax():
    dt = 0.02
    a = np.array([[1.0, dt], [9.81 * dt, 1.0]])
    b = np.array([[0.0], [dt]])
    want = jax.jit(jt.lqr_regulator)(jnp.asarray(a), jnp.asarray(b), jnp.eye(2), jnp.eye(1))
    got = tt.lqr_regulator(t64(a), t64(b), torch.eye(2, dtype=F64), torch.eye(1, dtype=F64))
    close(got, want, atol=1e-7)
    rng = np.random.default_rng(0)
    a2, b2 = np.eye(3) + rng.normal(0, 0.05, (3, 3)), rng.normal(0, 0.3, (3, 2))
    want = jax.jit(jt.lqr_regulator)(jnp.asarray(a2), jnp.asarray(b2), jnp.eye(3), jnp.eye(2))
    got = tt.lqr_regulator(t64(a2), t64(b2), torch.eye(3, dtype=F64), torch.eye(2, dtype=F64))
    close(got, want, atol=1e-7)


def j_vdp(x, u):
    return jnp.array([x[1], -x[0] + (1.0 - x[0] ** 2) * x[1] + u[0]])


def t_vdp(x, u):
    return torch.stack([x[1], -x[0] + (1.0 - x[0] ** 2) * x[1] + u[0]])


def vdp_stage(x, u):
    return 0.5 * (2.0 * x[0] ** 2 + x[1] ** 2 + 0.1 * u[0] ** 2)


def vdp_terminal(x):
    return 0.5 * (2.0 * x[0] ** 2 + x[1] ** 2)


def test_cgmres_residual_gmres_and_two_steps_match_jax():
    cfg = jcg.CGMRESConfig(sampling_dt=0.01)
    tcfg = tcg.CGMRESConfig(sampling_dt=0.01)
    jres = jcg.make_optimality_residual(j_vdp, jax.grad(vdp_stage, argnums=1),
                                        jax.grad(vdp_stage, argnums=0), jax.grad(vdp_terminal),
                                        cfg)
    tres = tcg.make_optimality_residual(t_vdp, torch.func.grad(vdp_stage, argnums=1),
                                        torch.func.grad(vdp_stage, argnums=0),
                                        torch.func.grad(vdp_terminal), tcfg)
    rng = np.random.default_rng(1)
    u, x = rng.normal(0, 0.5, 20), np.array([1.5, 0.0])
    close(tres(t64(u), t64(x)), jax.jit(jres)(jnp.asarray(u), jnp.asarray(x)))
    # gmres on a dense nonsymmetric system, restarted
    m = np.eye(12) * 3.0 + rng.normal(0, 1.0, (12, 12))
    bvec = rng.normal(0, 1, 12)
    want = jax.jit(lambda bb: jax.scipy.sparse.linalg.gmres(
        lambda v: jnp.asarray(m) @ v, bb, maxiter=3, restart=5, solve_method="incremental")[0])(
        jnp.asarray(bvec))
    got = tcg.gmres(lambda v: t64(m) @ v, t64(bvec), maxiter=3, restart=5)
    close(got, want, atol=1e-8)

    steps = 2
    jxs, jus = jax.jit(lambda x0: jcg.run_cgmres(j_vdp, vdp_stage, vdp_terminal, x0, steps, cfg))(
        jnp.array([1.5, 0.0]))
    txs, tus = tcg.run_cgmres(t_vdp, vdp_stage, vdp_terminal, [1.5, 0.0], steps, tcfg,
                              dtype=F64, device="cpu")
    close(txs, jxs, atol=1e-8)
    close(tus, jus, atol=1e-8)


def test_rocket_landing_matches_jax():
    cfg = jr.RocketConfig(horizon=20, dt=0.5, outer_iterations=1, inner_iterations=80)
    tcfg = tr.RocketConfig(horizon=20, dt=0.5, outer_iterations=1, inner_iterations=80)
    x0, target = np.array([20.0, 60.0, -3.0, -8.0]), np.array([0.0, 0.0])
    want = jax.jit(lambda a, b: jr.plan_landing(a, b, cfg))(jnp.asarray(x0), jnp.asarray(target))
    got = tr.plan_landing(x0, target, tcfg, dtype=F64, device="cpu")
    close(got[0], want[0], atol=1e-8)
    close(got[1], want[1], atol=1e-8)
    close(got[2], want[2], atol=1e-13 * abs(float(want[2])))  # the cost is ~2e7 here
    close(tr.rocket_dynamics(t64(x0), t64([3.0, 120.0]), tcfg),
          jr.rocket_dynamics(jnp.asarray(x0), jnp.array([3.0, 120.0]), cfg))


@pytest.mark.parametrize("horizon,inner", [(40, 1), (20, 5)])
def test_rocket_landing_float32_adds_in_jax_order(horizon, inner):
    """float32 against JAX's float32 run under `jax.jit`: the rollout adds
    step after step as JAX's scan does (a one-op cumsum, which torch's CPU
    accumulates in float64, was 8.8e-4 m and 2.7e-4 N off at horizon 40
    after one step). Measured here: states within 1.5e-5, thrusts within
    3.1e-5 N (a few float32 ulps of ~100 N: XLA fuses the jitted
    multiply-adds), the cost to its float32 rounding."""
    cfg = jr.RocketConfig(horizon=horizon, outer_iterations=1, inner_iterations=inner)
    tcfg = tr.RocketConfig(horizon=horizon, outer_iterations=1, inner_iterations=inner)
    x0 = [20.0, 60.0, -3.0, -8.0]
    with jax.enable_x64(False):
        want = jax.jit(lambda a, b: jr.plan_landing(a, b, cfg))(
            jnp.asarray(x0, jnp.float32), jnp.zeros(2, jnp.float32))
        want = [np.asarray(w) for w in want]
    got = tr.plan_landing(x0, [0.0, 0.0], tcfg, dtype=torch.float32, device="cpu")
    close(got[0], want[0], atol=2e-5)
    close(got[1], want[1], atol=5e-5)
    close(got[2], want[2], atol=2e-7 * abs(float(want[2])))


def test_planar_arm_and_3d_kinematics_match_jax():
    rng = np.random.default_rng(2)
    ang, lengths = rng.uniform(-1, 1, 4), np.array([1.0, 0.8, 0.6, 0.4])
    close(tarm.forward_kinematics(t64(ang), t64(lengths)),
          jax.jit(jarm.forward_kinematics)(jnp.asarray(ang), jnp.asarray(lengths)))
    tgt = np.array([1.2, 0.9])
    close(tarm.two_joint_ik(t64(tgt), 1.0, 0.8), jarm.two_joint_ik(jnp.asarray(tgt), 1.0, 0.8))
    close(tarm.two_joint_ik(t64(tgt), 1.0, 0.8, elbow_up=False),
          jarm.two_joint_ik(jnp.asarray(tgt), 1.0, 0.8, elbow_up=False))
    close(tarm.resolved_rate_ik(t64(ang), t64([1.5, 1.0]), t64(lengths)),
          jax.jit(jarm.resolved_rate_ik)(jnp.asarray(ang), jnp.array([1.5, 1.0]),
                                         jnp.asarray(lengths)), atol=1e-8)
    obstacles, radii = np.array([[1.0, 1.0], [-0.5, 1.5]]), np.array([0.3, 0.4])
    configs = rng.uniform(-2, 2, (32, 4))
    want = jax.jit(jax.vmap(lambda a: jarm.arm_collides(a, jnp.asarray(lengths),
                                                        jnp.asarray(obstacles),
                                                        jnp.asarray(radii))))(jnp.asarray(configs))
    got = tarm.arm_collides(t64(configs), t64(lengths), t64(obstacles), t64(radii))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 32
    cj, fj = jax.jit(jarm.joint_space_plan)(jnp.asarray(ang), jnp.asarray(-ang),
                                            jnp.asarray(lengths), jnp.asarray(obstacles),
                                            jnp.asarray(radii))
    ct, ft = tarm.joint_space_plan(t64(ang), t64(-ang), t64(lengths), t64(obstacles), t64(radii))
    close(ct, cj)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))

    ang7, len7 = rng.uniform(-1, 1, (8, 7)), np.full(7, 0.5)
    close(tarm.forward_kinematics_3d(t64(ang7), t64(len7)),
          jax.jit(jax.vmap(lambda a: jarm.forward_kinematics_3d(a, jnp.asarray(len7))))(
              jnp.asarray(ang7)))
    close(tarm.jacobian_3d(t64(ang7[0]), t64(len7)),
          jax.jit(jarm.jacobian_3d)(jnp.asarray(ang7[0]), jnp.asarray(len7)))
    targets = rng.uniform(-1, 1, (8, 3)) + np.array([1.5, 0.0, 0.5])
    want = jax.jit(jax.vmap(lambda a, t: jarm.inverse_kinematics_3d(a, t, jnp.asarray(len7), 40)))(
        jnp.asarray(ang7), jnp.asarray(targets))
    got = tarm.inverse_kinematics_3d(t64(ang7), t64(targets), t64(len7), 40)
    close(got[0], want[0], atol=1e-8)
    close(got[1], want[1], atol=1e-8)
    solo = tarm.inverse_kinematics_3d(t64(ang7[3]), t64(targets[3]), t64(len7), 40)
    assert torch.equal(solo[0], got[0][3])


def rrt_draws(key, iters, d, lo=-np.pi, hi=np.pi):
    """The uniforms `rrt_star_arm_plan`'s fori_loop draws from `key`."""
    rand, bias = [], []
    for _ in range(iters):
        key, k1, k2 = jax.random.split(key, 3)
        rand.append(jax.random.uniform(k1, (d,), jnp.float64, lo, hi))
        bias.append(jax.random.uniform(k2))
    return np.stack(rand), np.asarray(bias)


def test_rrt_star_arm_matches_jax_with_its_draws():
    """bench_arm_rrt_star's problem at 32 nodes."""
    lengths = np.full(7, 0.5)
    centers, radii = np.array([[1.2, 0.6, 0.3], [0.8, -0.8, 0.5]]), np.array([0.25, 0.25])
    kw = dict(max_nodes=32, step_size=0.5, rewire_radius=1.2, edge_checks=6, path_len=32)
    key = jax.random.PRNGKey(0)
    start, goal = np.zeros(7), np.full(7, 0.6)
    want = jax.jit(lambda k: jarm.rrt_star_arm_plan(
        k, jnp.asarray(start), jnp.asarray(goal), jnp.asarray(lengths), jnp.asarray(centers),
        jnp.asarray(radii), **kw))(key)
    rand, bias = rrt_draws(key, kw["max_nodes"] - 2, 7)
    got = tarm.rrt_star_arm_plan(None, t64(start), t64(goal), t64(lengths), t64(centers),
                                 t64(radii), draws=(t64(rand), t64(bias)), **kw)
    assert bool(got["found"]) and bool(want["found"])
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    close(got["waypoints"], want["waypoints"])
    close(got["cost"], want["cost"])
    assert bool(tarm.arm_collides_3d(t64(np.full(7, 0.6)), t64(lengths), t64(centers),
                                     t64(radii))) == bool(jarm.arm_collides_3d(
        jnp.full(7, 0.6), jnp.asarray(lengths), jnp.asarray(centers), jnp.asarray(radii)))
