"""EKF-SLAM and FastSLAM 1.0/2.0 (`slam/ekf_slam.py`, `slam/fastslam.py`)
against the JAX package's, on the reference simulation of
tests/test_slam_filters.py (a circle drive past four range-bearing
landmarks, numpy noise from a seed): JAX on the CPU at x64, torch in
float64 on the CPU.

FastSLAM draws its motion noise and resampling uniform from JAX's keys and
feeds them to the port (`draws=`), so both run on the same numbers; the
generator path is held by behaviour (finite, normalised weights).
Tolerances: 1e-12 for one function call; 1e-9 over a run of steps (each
EKF update divides by innovation covariances of ~1e-2, so the rounding
of the two packages' matrix products, ~1e-16, grows along the run; up to
~1e-11 measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.slam import ekf_slam as je
from rust_robotics_tpu.slam import fastslam as jf
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.slam import ekf_slam as te
from rust_robotics_tpu_torch.slam import fastslam as tf

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

LANDMARKS = np.array([[10.0, -2.0], [15.0, 10.0], [3.0, 15.0], [-5.0, 20.0]])
DT = 0.1
U = np.array([1.0, 0.1])
ATOL = 1e-12
RUN_ATOL = 1e-9
Q_EKF = np.diag([0.2, (5 * np.pi / 180) ** 2])
R_EKF = np.diag(np.array([0.05, 0.01]) ** 2 * 25)
CHOL = np.diag(np.array([0.3, 0.0305]) ** 0.5)
R_FAST = np.diag([0.1, 0.05])
P = 32
STEPS = 40


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


@functools.lru_cache(maxsize=None)
def simulate(steps=STEPS, seed=0):
    """Observations [steps, 4, 3] (range, bearing, id) and masks [steps, 4]."""
    rng = np.random.default_rng(seed)
    truth = np.zeros(3)
    obs = np.zeros((steps, 4, 3))
    mask = np.zeros((steps, 4), bool)
    for k in range(steps):
        truth[0] += U[0] * DT * np.cos(truth[2])
        truth[1] += U[0] * DT * np.sin(truth[2])
        truth[2] = (truth[2] + U[1] * DT + np.pi) % (2 * np.pi) - np.pi
        d = LANDMARKS - truth[:2]
        rngs = np.linalg.norm(d, axis=-1)
        bearing = (np.arctan2(d[:, 1], d[:, 0]) - truth[2] + np.pi) % (2 * np.pi) - np.pi
        seen = [i for i in range(4) if rngs[i] <= 20.0]
        for j, i in enumerate(seen):
            obs[k, j] = [rngs[i] + 0.05 * rng.standard_normal(),
                         bearing[i] + 0.01 * rng.standard_normal(), i]
            mask[k, j] = True
    return obs, mask, truth


def _ekf_belief(seed=0, n_lm=2, cap=4):
    """A random belief with n_lm mapped landmarks near the true ones."""
    rng = np.random.default_rng(seed)
    n = 3 + 2 * cap
    mean = np.zeros(n)
    mean[:3] = [0.3, -0.2, 0.1]
    mean[3:3 + 2 * n_lm] = (LANDMARKS[:n_lm] + 0.1 * rng.normal(size=(n_lm, 2))).ravel()
    a = 0.1 * rng.normal(size=(n, n))
    cov = a @ a.T + 0.05 * np.eye(n)
    return mean, cov, n_lm


jax_update_one = jax.jit(lambda b, z: je.ekf_slam_update_one(b, z, jnp.asarray(R_EKF)))


def both_ekf(mean, cov, n_lm):
    return (je.EKFSLAMBelief(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(n_lm)),
            convert.ekf_slam_from_numpy(mean, cov, n_lm, device="cpu"))


def assert_ekf_close(got, want, atol=ATOL):
    close(got.mean, want.mean, atol)
    close(got.cov, want.cov, atol)
    np.testing.assert_array_equal(got.n_lm.numpy(), np.asarray(want.n_lm))


def test_motion_and_predict_match_jax():
    pose = np.array([[0.3, -0.2, 3.1], [1.0, 2.0, -0.4]])
    close(te.motion_model(t64(pose), t64(U), DT),
          jax.vmap(lambda p: je.motion_model(p, jnp.asarray(U), DT))(jnp.asarray(pose)))
    jb, tb = both_ekf(*_ekf_belief())
    assert_ekf_close(te.ekf_slam_predict(tb, t64(U), DT, t64(Q_EKF)),
                     je.ekf_slam_predict(jb, jnp.asarray(U), DT, jnp.asarray(Q_EKF)))


def test_innovations_and_add_landmark_match_jax():
    jb, tb = both_ekf(*_ekf_belief(1))
    z = np.array([9.0, -0.3])
    for g, w in zip(te._landmark_innovations(tb, t64(z)), je._landmark_innovations(jb,
                                                                                     jnp.asarray(z))):
        close(g, w)
    assert_ekf_close(te._add_landmark(tb, t64(z), t64(R_EKF)),
                     je._add_landmark(jb, jnp.asarray(z), jnp.asarray(R_EKF)))


@pytest.mark.parametrize("case", ["update", "new", "full", "empty"])
def test_update_one_matches_jax(case):
    """Association to a mapped landmark; a far observation adds one; at
    capacity it updates instead; with no landmark it adds the first."""
    n_lm = {"update": 2, "new": 2, "full": 4, "empty": 0}[case]
    jb, tb = both_ekf(*_ekf_belief(2, n_lm=n_lm))
    d = LANDMARKS[0] - np.array([0.3, -0.2])
    z = np.array([np.linalg.norm(d), np.arctan2(d[1], d[0]) - 0.1])
    if case in ("new", "full"):
        z = np.array([3.0, 2.5])
    want = jax_update_one(jb, jnp.asarray(z))
    got = te.ekf_slam_update_one(tb, t64(z), t64(R_EKF))
    assert_ekf_close(got, want)
    assert int(got.n_lm) == n_lm + (case in ("new", "empty"))


def test_association_tie_takes_the_first_as_jax():
    """Two slots hold the same landmark: equal Mahalanobis distances, and
    the update goes to the first, as `jnp.argmin` picks it."""
    mean, cov, _ = _ekf_belief(3, n_lm=2)
    mean[5:7] = mean[3:5]
    cov[5:7, :] = cov[3:5, :]
    cov[:, 5:7] = cov[:, 3:5]
    jb, tb = both_ekf(mean, cov, 2)
    d = mean[3:5] - mean[:2]
    z = np.array([np.linalg.norm(d) + 0.05, np.arctan2(d[1], d[0]) - mean[2]])
    y, s, _ = te._landmark_innovations(tb, t64(z))
    assert torch.equal(y[0], y[1]) and torch.equal(s[0], s[1])
    want = jax_update_one(jb, jnp.asarray(z))
    got = te.ekf_slam_update_one(tb, t64(z), t64(R_EKF))
    assert_ekf_close(got, want)
    assert not torch.equal(got.mean[3:5], tb.mean[3:5])


@functools.lru_cache(maxsize=None)
def jax_ekf_run():
    obs, mask, _ = simulate()
    step = jax.jit(lambda b, o, m: je.ekf_slam_step(b, jnp.asarray(U), o, m, DT,
                                                    jnp.asarray(Q_EKF), jnp.asarray(R_EKF)))
    b = je.init_ekf_slam(capacity=8)
    for k in range(STEPS):
        b = step(b, jnp.asarray(obs[k, :, :2]), jnp.asarray(mask[k]))
    return b, step


def test_ekf_slam_run_matches_jax():
    obs, mask, truth = simulate()
    b = te.init_ekf_slam(capacity=8, device="cpu")
    for k in range(STEPS):
        b = te.ekf_slam_step(b, t64(U), t64(obs[k, :, :2]), torch.tensor(mask[k]), DT,
                             t64(Q_EKF), t64(R_EKF))
    want, _ = jax_ekf_run()
    assert_ekf_close(b, want, RUN_ATOL)
    assert int(b.n_lm) >= 3
    assert np.linalg.norm(b.mean[:2].numpy() - truth[:2]) < 1.5


def test_ekf_slam_batch_matches_vmap():
    """Three worlds in lock-step with different masks: each lane takes its
    own add-or-update branch."""
    obs, mask, _ = simulate()
    _, step = jax_ekf_run()
    masks = np.stack([mask, mask & (np.arange(4) != 1), mask & (np.arange(STEPS) % 3 != 0)[:, None]])
    tb = te.init_ekf_slam(capacity=4, device="cpu", batch_shape=(3,))
    jb = jax.vmap(lambda _: je.init_ekf_slam(capacity=4))(jnp.arange(3))
    vstep = jax.jit(jax.vmap(step, in_axes=(0, None, 0)))
    for k in range(12):
        jb = vstep(jb, jnp.asarray(obs[k, :, :2]), jnp.asarray(masks[:, k]))
        tb = te.ekf_slam_step(tb, t64(U), t64(obs[k, :, :2]), torch.tensor(masks[:, k]), DT,
                              t64(Q_EKF), t64(R_EKF))
    assert_ekf_close(tb, jb, RUN_ATOL)
    assert len(set(tb.n_lm.tolist())) > 1


def _fast_draws(key, kind):
    """JAX's draws of one step: the motion (or proposal) normals and the
    resampling uniform, split from the step's key as the JAX step does."""
    k1, k2 = jax.random.split(key)
    noise = jax.random.normal(k1, (P, 2 if kind == 1 else 3), jnp.float64)
    return t64(noise), t64(jax.random.uniform(k2, (1,), jnp.float64))


@pytest.mark.parametrize("kind", [1, 2])
def test_fastslam_run_matches_jax(kind):
    obs, mask, truth = simulate()
    jstep_fn = jf.fastslam1_step if kind == 1 else jf.fastslam2_step
    tstep_fn = tf.fastslam1_step if kind == 1 else tf.fastslam2_step
    step = jax.jit(lambda p, o, m, key: jstep_fn(p, jnp.asarray(U), o, m, DT, jnp.asarray(CHOL),
                                                 jnp.asarray(R_FAST), key))
    keys = jax.random.split(jax.random.PRNGKey(kind), STEPS)
    jp = jf.init_fastslam(P, 4)
    tp = tf.init_fastslam(P, 4, device="cpu")
    for k in range(STEPS):
        jp = step(jp, jnp.asarray(obs[k]), jnp.asarray(mask[k]), keys[k])
        tp = tstep_fn(tp, t64(U), t64(obs[k]), torch.tensor(mask[k]), DT, t64(CHOL), t64(R_FAST),
                      draws=_fast_draws(keys[k], kind))
    for name in ("poses", "weights", "lm_mean", "lm_cov", "lm_seen"):
        close(getattr(tp, name), getattr(jp, name), RUN_ATOL)
    pose, best = tf.estimate(tp)
    want_pose, want_best = jf.estimate(jp)
    close(pose, want_pose, RUN_ATOL)
    assert int(best) == int(want_best)


def _cloud(seed, lead=()):
    rng = np.random.default_rng(seed)
    poses = 0.3 * rng.normal(size=lead + (P, 3))
    w = rng.uniform(0.1, 1.0, size=lead + (P,))
    lm_mean = LANDMARKS + 0.2 * rng.normal(size=lead + (P, 4, 2))
    a = 0.3 * rng.normal(size=lead + (P, 4, 2, 2))
    lm_cov = a @ np.swapaxes(a, -1, -2) + 0.01 * np.eye(2)
    seen = rng.uniform(size=lead + (P, 4)) < 0.5
    return poses, w / w.sum(-1, keepdims=True), lm_mean, lm_cov, seen


def both_fast(*arrays):
    return (jf.FastSLAMParticles(*map(jnp.asarray, arrays)),
            convert.fastslam_from_numpy(*arrays, device="cpu"))


def assert_fast_close(got, want, atol=ATOL):
    for name in ("poses", "weights", "lm_mean", "lm_cov", "lm_seen"):
        close(getattr(got, name), getattr(want, name), atol)


def test_fastslam_pieces_match_jax():
    jp, tp = both_fast(*_cloud(4))
    key = jax.random.PRNGKey(7)
    noise = jax.random.normal(key, (P, 2), jnp.float64)
    want = jf.predict_particles(jp, jnp.asarray(U), DT, jnp.asarray(CHOL), key)
    close(tf.predict_particles(tp, t64(U), DT, t64(CHOL), noise=t64(noise)).poses, want.poses)
    update = jax.jit(lambda p, z, i: jf.update_with_observation(p, z, i, jnp.asarray(R_FAST)))
    for lm_id in (0, 3):
        z = np.array([8.0, -0.4])
        assert_fast_close(tf.update_with_observation(tp, t64(z), lm_id, t64(R_FAST)),
                          update(jp, jnp.asarray(z), lm_id))
    u = jax.random.uniform(key, (1,), jnp.float64)
    skewed = jf.FastSLAMParticles(jp.poses, jp.weights ** 8, *(jp.lm_mean, jp.lm_cov, jp.lm_seen))
    tskew = tf.FastSLAMParticles(tp.poses, tp.weights ** 8, tp.lm_mean, tp.lm_cov, tp.lm_seen)
    resample = jax.jit(jf.normalize_and_resample)
    for jpart, tpart in ((jp, tp), (skewed, tskew)):
        assert_fast_close(tf.normalize_and_resample(tpart, uniform=t64(u)), resample(jpart, key))
    for g, w in zip(tf._observe_pose_jacobian(tp.poses, tp.lm_mean[:, 1]),
                    jf._observe_pose_jacobian(jp.poses, jp.lm_mean[:, 1])):
        close(g, w)


def test_fastslam_batch_matches_vmap_and_generator_path():
    """Two filters in lock-step with per-filter landmark ids and masks,
    against `jax.vmap`; then the generator path's weights."""
    arrays = _cloud(5, lead=(2,))
    jp, tp = both_fast(*arrays)
    obs = np.array([[[8.0, -0.4, 0], [12.0, 0.8, 2]], [[9.0, 0.3, 3], [7.0, -1.0, 1]]])
    mask = np.array([[True, True], [False, True]])
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = jax.vmap(lambda p, o, m, k: jf.fastslam1_step(
        p, jnp.asarray(U), o, m, DT, jnp.asarray(CHOL), jnp.asarray(R_FAST), k))(
        jp, jnp.asarray(obs), jnp.asarray(mask), keys)
    draws = [_fast_draws(k, 1) for k in keys]
    got = tf.fastslam1_step(tp, t64(U), t64(obs), torch.tensor(mask), DT, t64(CHOL), t64(R_FAST),
                            draws=tuple(torch.stack(d) for d in zip(*draws)))
    assert_fast_close(got, want, RUN_ATOL)
    gen = torch.Generator().manual_seed(0)
    for step in (tf.fastslam1_step, tf.fastslam2_step):
        out = step(tp, t64(U), t64(obs), torch.tensor(mask), DT, t64(CHOL), t64(R_FAST),
                   generator=gen)
        assert torch.isfinite(out.weights).all()
        close(out.weights.sum(-1), np.ones(2), 1e-12)
