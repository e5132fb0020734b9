"""IMU preintegration, the IMU factors and trajectory optimization
(`slam/imu.py`) against the JAX package's, on seeded numpy inputs: JAX on
the CPU at x64, torch in float64 on the CPU.

Tolerances:
- `transform_imu`, `corrected_delta`, `predict_nav_state`, `nav_retract`
  and every residual: atol 1e-12 (the same closed forms; sums in another
  order, values of order 1-10, ~1e-15 measured);
- `preintegrate`: atol 1e-12 (a 100-sample scan of 3×3 and 9×9 products);
- padded lanes: a lane padded at the end with dt = 0 is bitwise its solo
  run (the port's claim: a padded step is an exact no-op, and the lanes'
  arithmetic does not depend on the batch);
- `optimize_imu_trajectory` on tests/test_imu.py:150's problem: costs at
  rtol 1e-9 (atol 1e-12), values within 1e-8, as tests/test_torch_nlls.py
  holds LM runs near the rounding floor; with step_tolerance=1e-7, where
  both stop above the floor, the termination and every count equal too;
- the gradient of the dead-reckoned terminal position error with respect
  to the bias, through `preintegrate` and `predict_nav_state`, on
  tests/fixture_gen.py's sequence (its intervals as lanes padded with
  dt = 0 in both packages): torch autograd against `jax.grad` at
  rtol 1e-9, and against a central finite difference at rtol 1e-4 as
  tests/test_vio_gradients.py:42 holds JAX (which skips without the
  reference's euroc_mini).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_gen import make_euroc_fixture

from rust_robotics_tpu.core.lie import so3_log as j_so3_log
from rust_robotics_tpu.data.euroc import EurocDataset as JEuroc
from rust_robotics_tpu.data.euroc import quat_to_rot as j_quat_to_rot
from rust_robotics_tpu.nlls import SolverConfig as JConfig
from rust_robotics_tpu.slam import imu as ji
from rust_robotics_tpu_torch.convert import preintegrated_from_numpy
from rust_robotics_tpu_torch.nlls import SolverConfig
from rust_robotics_tpu_torch.slam import imu as ti
from rust_robotics_tpu_torch.slam.vio import interval_lanes

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
FIELDS = [f.name for f in dataclasses.fields(ti.Preintegrated)]


def t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _samples(rng, n, lead=()):
    accel = rng.normal(size=(*lead, n, 3)) + [0.0, 0.0, 9.81]
    gyro = 0.4 * rng.normal(size=(*lead, n, 3))
    dts = rng.uniform(0.004, 0.006, size=(*lead, n))
    return accel, gyro, dts


def test_transform_imu_matches_jax():
    rng = np.random.default_rng(0)
    accel, gyro, gdot, lever = rng.normal(size=(4, 3))
    rot = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0.0, -0.3, 0.2], [0.3, 0.0, -0.1], [-0.2, 0.1, 0.0]])))
    want = ji.transform_imu(*(jnp.asarray(x) for x in (accel, gyro, gdot, rot, lever)))
    got = ti.transform_imu(*(t(x) for x in (accel, gyro, gdot, rot, lever)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    # leading batch dims: every lane its own call
    accel_b = rng.normal(size=(5, 3))
    got_b = ti.transform_imu(t(accel_b), t(gyro), t(gdot), t(rot), t(lever))
    for i in range(5):
        one = ti.transform_imu(t(accel_b[i]), t(gyro), t(gdot), t(rot), t(lever))
        np.testing.assert_allclose(got_b[0][i].numpy(), one[0].numpy(), rtol=0, atol=1e-15)


@functools.lru_cache(maxsize=None)
def _jax_preintegration(seed, n):
    rng = np.random.default_rng(seed)
    accel, gyro, dts = _samples(rng, n)
    bias = 0.02 * rng.normal(size=6)
    pre = ji.preintegrate(jnp.asarray(accel), jnp.asarray(gyro), jnp.asarray(dts),
                          jnp.asarray(bias), 0.02, 0.002)
    return (accel, gyro, dts, bias), {f: np.asarray(getattr(pre, f)) for f in FIELDS}


def test_preintegrate_matches_jax():
    (accel, gyro, dts, bias), want = _jax_preintegration(0, 100)
    got = ti.preintegrate(t(accel), t(gyro), t(dts), t(bias), 0.02, 0.002)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], rtol=0, atol=1e-12,
                                   err_msg=f)


def test_padded_lanes_equal_their_solo_runs_bitwise():
    rng = np.random.default_rng(1)
    lengths = [17, 9, 1, 0, 17]
    accel, gyro, dts = (np.zeros(s) for s in ((5, 17, 3), (5, 17, 3), (5, 17)))
    for i, n in enumerate(lengths):
        accel[i, :n], gyro[i, :n], dts[i, :n] = _samples(rng, n)
    bias = t(0.02 * rng.normal(size=6))
    lanes = ti.preintegrate(t(accel), t(gyro), t(dts), bias, 0.02, 0.002)
    for i, n in enumerate(lengths):
        solo = ti.preintegrate(t(accel[i, :n]), t(gyro[i, :n]), t(dts[i, :n]), bias,
                               0.02, 0.002)
        for f in FIELDS:
            assert torch.equal(getattr(lanes, f)[i], getattr(solo, f)), (i, f)
    # an empty interval is the identity
    assert torch.equal(lanes.delta_rotation[3], torch.eye(3, dtype=F64))
    assert not lanes.covariance[3].any() and not lanes.delta_position[3].any()


def _nav(rng):
    return np.concatenate([0.3 * rng.normal(size=3), rng.normal(size=3), rng.normal(size=3)])


def test_predict_and_corrected_delta_match_jax():
    (_, _, _, bias), pre_np = _jax_preintegration(0, 100)
    rng = np.random.default_rng(2)
    nav, bias2 = _nav(rng), bias + 0.003 * rng.normal(size=6)
    jpre = ji.Preintegrated(*(jnp.asarray(pre_np[f]) for f in FIELDS[:-1]), jnp.asarray(bias))
    tpre = preintegrated_from_numpy(jpre, device="cpu")
    got, want = ti.corrected_delta(tpre, t(bias2)), ji.corrected_delta(jpre, jnp.asarray(bias2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    for gravity in (ji.GRAVITY, jnp.array([0.1, -0.2, -9.7])):
        want = ji.predict_nav_state(jpre, jnp.asarray(nav), jnp.asarray(bias2), gravity)
        got = ti.predict_nav_state(tpre, t(nav), t(bias2),
                                   ti.GRAVITY if gravity is ji.GRAVITY else t(gravity))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # a batch of nav states: every lane its own call
    navs = np.stack([_nav(rng) for _ in range(4)])
    got_b = ti.predict_nav_state(tpre, t(navs), t(bias2))
    for i in range(4):
        want = ji.predict_nav_state(jpre, jnp.asarray(navs[i]), jnp.asarray(bias2))
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_retract_and_residuals_match_jax():
    (_, _, _, bias), pre_np = _jax_preintegration(0, 100)
    rng = np.random.default_rng(3)
    nav_i, nav_j, delta = _nav(rng), _nav(rng), 0.2 * rng.normal(size=9)
    b_i, b_j = 0.01 * rng.normal(size=(2, 6))
    meas = {f: pre_np[f] for f in FIELDS if f != "covariance"}
    meas["lin_bias"] = bias
    meas["gravity"] = np.array([0.0, 0.0, -9.81])
    jmeas = {k: jnp.asarray(v) for k, v in meas.items()}
    tmeas = {k: t(v) for k, v in meas.items()}
    prior, posvel, m6 = _nav(rng), rng.normal(size=6), 0.01 * rng.normal(size=6)
    cases = [
        (ji.nav_retract, ti.nav_retract, (nav_i, delta)),
        (ji.nav_prior_residual, ti.nav_prior_residual, (nav_i, prior)),
        (ji.position_velocity_residual, ti.position_velocity_residual, (nav_i, posvel)),
        (ji.bias_prior_residual, ti.bias_prior_residual, (b_i, m6)),
        (ji.bias_between_residual, ti.bias_between_residual, (b_i, b_j, m6)),
    ]
    for jf, tf, args in cases:
        want = jf(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(tf(*(t(a) for a in args)).numpy(), np.asarray(want),
                                   rtol=0, atol=1e-12, err_msg=tf.__name__)
    want = ji.imu_factor_residual(jnp.asarray(nav_i), jnp.asarray(nav_j), jnp.asarray(b_j), jmeas)
    got = ti.imu_factor_residual(t(nav_i), t(nav_j), t(b_j), tmeas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def simulate_trajectory(steps=5, samples=20, dt=0.01):
    """tests/test_imu.py:117's construction (piecewise-constant world
    acceleration and body rate, the truth integrated with the
    preintegration's discretisation), through the port's Lie functions and
    `preintegrate`: (truth navs [steps + 1, 9], stacked Preintegrated)."""
    from rust_robotics_tpu_torch.core.lie import so3_exp, so3_log

    rng = np.random.default_rng(0)
    gravity = t(ti.GRAVITY)
    nav = torch.zeros(9, dtype=F64)
    navs, accels, gyros = [nav], [], []
    for _ in range(steps):
        a_w, w_b = t(rng.uniform(-0.5, 0.5, 3)), t(rng.uniform(-0.3, 0.3, 3))
        cur = nav
        for _ in range(samples):
            rot = so3_exp(cur[0:3])
            accels.append(rot.T @ (a_w - gravity))
            pos = cur[3:6] + cur[6:9] * dt + 0.5 * a_w * dt * dt
            vel = cur[6:9] + a_w * dt
            cur = torch.cat([so3_log(rot @ so3_exp(w_b * dt)), pos, vel])
        gyros.append(w_b.expand(samples, 3))
        nav = cur
        navs.append(nav)
    # the steps as lanes of one call (each lane is bitwise its solo run)
    pres = ti.preintegrate(torch.stack(accels).reshape(steps, samples, 3), torch.stack(gyros),
                           torch.full((steps, samples), dt, dtype=F64),
                           torch.zeros(6, dtype=F64), 0.01, 0.001)
    return torch.stack(navs), pres


@functools.lru_cache(maxsize=None)
def _trajectory_problem():
    """tests/test_imu.py:150's problem, as numpy."""
    navs, pres = simulate_trajectory()
    navs = navs.numpy()
    n = navs.shape[0]
    rng = np.random.default_rng(1)
    noisy = navs + 0.05 * rng.standard_normal(navs.shape)
    noisy[0] = navs[0]
    return navs, noisy, pres.map(lambda x: x.numpy()), n


@functools.lru_cache(maxsize=None)
def _jax_trajectory(step_tolerance):
    navs, noisy, pres, n = _trajectory_problem()
    kw = _trajectory_kwargs(navs, n, np.asarray)
    out_navs, out_biases, summary = ji.optimize_imu_trajectory(
        jnp.asarray(noisy), jnp.zeros((n, 6)),
        ji.Preintegrated(*(jnp.asarray(getattr(pres, f)) for f in FIELDS)),
        config=JConfig(step_tolerance=step_tolerance), **kw)
    return np.asarray(out_navs), np.asarray(out_biases), summary


def _trajectory_kwargs(navs, n, conv):
    return dict(
        nav_prior=conv(navs[0]), nav_prior_info=conv(1e6 * np.eye(9)),
        bias_prior=conv(np.zeros(6)), bias_prior_info=conv(1e4 * np.eye(6)),
        bias_between_info=conv(1e6 * np.eye(6)),
        posvel_meas=conv(np.concatenate([navs[:, 3:6], navs[:, 6:9]], axis=-1)),
        posvel_indices=conv(np.arange(n)),
        posvel_info=conv(np.tile(1e2 * np.eye(6), (n, 1, 1))),
    )


@pytest.mark.parametrize("counts,step_tolerance", [(False, 1e-10), (True, 1e-7)])
def test_optimize_imu_trajectory_matches_jax(counts, step_tolerance):
    navs, noisy, pres, n = _trajectory_problem()
    want_navs, want_biases, want = _jax_trajectory(step_tolerance)
    got_navs, got_biases, got = ti.optimize_imu_trajectory(
        t(noisy), torch.zeros((n, 6), dtype=F64), pres.map(t),
        config=SolverConfig(step_tolerance=step_tolerance),
        **_trajectory_kwargs(navs, n, t))
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(got_navs.numpy(), want_navs, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_biases.numpy(), want_biases, rtol=0, atol=1e-8)
    if counts:
        for name in ("termination", "iterations", "accepted_steps", "linear_iterations"):
            assert getattr(got, name) == getattr(want, name), name
    assert got.final_cost < got.initial_cost
    assert np.abs(got_navs.numpy()[:, 3:6] - navs[:, 3:6]).max() < 0.02


@pytest.fixture(scope="module")
def euroc_segments(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_grad"))
    make_euroc_fixture(root)
    ds = JEuroc.load(root)
    gt = ds.ground_truth
    nav0 = np.concatenate([np.asarray(j_so3_log(jnp.asarray(j_quat_to_rot(gt.quaternions[0])))),
                           gt.positions[0], gt.velocities[0]])
    return ds, nav0, gt.positions[-1]


def test_grad_of_dead_reckoned_error_wrt_bias_matches_jax(euroc_segments):
    ds, nav0, target = euroc_segments
    cam_ts = ds.cam.timestamps

    # the intervals as lanes padded with dt = 0 (an exact no-op in both
    # packages), preintegrated under jax.vmap and chained by lax.scan, so
    # that one compiled program holds the JAX side
    lanes_np = interval_lanes(ds, cam_ts)

    def j_terminal_error(bias):
        pres = jax.vmap(lambda a, g, d: ji.preintegrate(a, g, d, bias, 0.02, 0.002))(
            *(jnp.asarray(x) for x in lanes_np))

        def chain(nav, pre):
            return ji.predict_nav_state(pre, nav, bias, ji.GRAVITY), None

        nav, _ = jax.lax.scan(chain, jnp.asarray(nav0), pres)
        return jnp.sum((nav[3:6] - jnp.asarray(target)) ** 2)

    lanes = [t(x) for x in lanes_np]

    def t_terminal_error(bias):
        pres = ti.preintegrate(*lanes, bias, 0.02, 0.002)
        nav = t(nav0)
        for i in range(len(cam_ts) - 1):
            nav = ti.predict_nav_state(pres.map(lambda x, i=i: x[i]), nav, bias)
        return torch.sum((nav[3:6] - t(target)) ** 2)

    bias0 = np.zeros(6)
    want = np.asarray(jax.jit(jax.grad(j_terminal_error))(jnp.asarray(bias0)))
    bias = t(bias0).requires_grad_(True)
    t_terminal_error(bias).backward()
    got = bias.grad.numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    eps = 1e-6
    for k in (0, 2, 4):
        e = np.zeros(6)
        e[k] = eps
        with torch.no_grad():
            up, down = t_terminal_error(t(bias0 + e)), t_terminal_error(t(bias0 - e))
            fd = (float(up) - float(down)) / (2 * eps)
        np.testing.assert_allclose(got[k], fd, rtol=1e-4, atol=1e-9)
