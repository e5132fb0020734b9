"""The port's core types, angles, models and small-matrix algebra against
the JAX package, on the same numpy inputs made from a seed.

Both sides run in float64 on the CPU; every comparison is at 1e-12 unless a
test says otherwise.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core import angles as j_angles
from rust_robotics_tpu.models import motion as j_motion
from rust_robotics_tpu.models import observation as j_obs
from rust_robotics_tpu.ops import smallmat as j_smallmat
from rust_robotics_tpu_torch.core import angles, types
from rust_robotics_tpu_torch.models import motion, observation
from rust_robotics_tpu_torch.ops import smallmat

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
DT = 0.1


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def spd(rng, b, n):
    a = rng.standard_normal((b, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


# --- angles -----------------------------------------------------------------

EDGE = np.array([
    -math.pi, math.pi, np.nextafter(-math.pi, 0), np.nextafter(-math.pi, -4),
    np.nextafter(math.pi, 0), np.nextafter(math.pi, 4), 3 * math.pi, -3 * math.pi,
    0.0, -0.0, 2 * math.pi, -2 * math.pi, 20.0, -20.0, 1e-17, -1e-17,
])


def test_normalize_angle_edges_match_jax():
    got = angles.normalize_angle(t64(EDGE))
    close(got, j_angles.normalize_angle(jnp.asarray(EDGE)), atol=0.0)
    assert torch.all(got > -math.pi) and torch.all(got <= math.pi)
    # the (-pi, pi] edge: -pi maps to +pi
    assert float(angles.normalize_angle(t64(-math.pi))) == math.pi
    assert float(angles.normalize_angle(t64(math.pi))) == math.pi


def test_normalize_angle_sweep_and_angle_diff():
    thetas = np.linspace(-20.0, 20.0, 1001)
    got = angles.normalize_angle(t64(thetas))
    close(got, j_angles.normalize_angle(jnp.asarray(thetas)))
    close(torch.cos(got), np.cos(thetas))
    a, b = thetas, thetas[::-1] * 0.7
    close(angles.angle_diff(t64(a), t64(b)), j_angles.angle_diff(jnp.asarray(a), jnp.asarray(b)))


# --- types ------------------------------------------------------------------

def test_pose_and_state_types():
    p = types.Pose2D(torch.ones(4), torch.zeros(4), torch.full((4,), 4.0, dtype=torch.float64))
    close(p.normalized().yaw, np.full(4, 4.0 - 2 * math.pi))
    q = types.Pose2D.from_array(p.as_array())
    assert torch.equal(q.as_array(), p.as_array())
    with pytest.raises(Exception):
        p.x = torch.zeros(4)  # frozen
    s = types.State2D(*(torch.tensor(v, dtype=torch.float64) for v in (1.0, 2.0, 0.5, 3.0)))
    assert torch.equal(types.State2D.from_array(s.as_array()).as_array(), s.as_array())
    belief = types.GaussianBelief(torch.zeros(5, 4), torch.eye(4).expand(5, 4, 4))
    assert belief.dim == 4


def test_path2d_matches_jax():
    from rust_robotics_tpu.core.types import Path2D as JPath2D

    pts = np.array([[0.0, 0.0], [3.0, 4.0], [3.0, 4.0], [100.0, 100.0]])
    mask = np.array([1.0, 1.0, 1.0, 0.0])
    path = types.Path2D(t64(pts), t64(mask))
    jpath = JPath2D(jnp.asarray(pts), jnp.asarray(mask))
    close(path.total_length(), jpath.total_length())
    assert int(path.num_valid()) == int(jpath.num_valid()) == 3


def test_gridspec_matches_jax():
    from rust_robotics_tpu.core.types import GridSpec2D as JGridSpec2D

    g = types.GridSpec2D(min_x=-5.0, min_y=-5.0, resolution=0.5, width=20, height=20)
    jg = JGridSpec2D(min_x=-5.0, min_y=-5.0, resolution=0.5, width=20, height=20)
    xy = np.array([[0.0, 0.0], [-4.9, 4.9], [7.3, -6.0]])
    idx = g.world_to_index(t64(xy))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jg.world_to_index(jnp.asarray(xy))))
    centers = g.index_to_world(idx, dtype=torch.float64)
    close(centers, jg.index_to_world(jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(g.world_to_index(centers).numpy(), idx.numpy())
    np.testing.assert_array_equal(g.in_bounds(idx).numpy(), [True, True, False])
    assert (g.max_x, g.max_y) == (jg.max_x, jg.max_y)


# --- motion and observation -------------------------------------------------

def _states(rng, b=16):
    s = rng.standard_normal((b, 4))
    s[:, 2] *= 3.0
    u = np.stack([1.0 + 0.3 * rng.standard_normal(b), 0.2 * rng.standard_normal(b)], -1)
    return s, u


def test_motion_matches_jax():
    s, u = _states(np.random.default_rng(1))
    close(motion.unicycle_propagate(t64(s), t64(u), DT),
          j_motion.unicycle_propagate(jnp.asarray(s), jnp.asarray(u), DT))
    close(motion.unicycle_jacobian(t64(s), t64(u), DT),
          j_motion.unicycle_jacobian(jnp.asarray(s), jnp.asarray(u), DT))
    # a shared control broadcasts over the batch, as in JAX
    close(motion.unicycle_propagate(t64(s), t64(u[0]), DT),
          j_motion.unicycle_propagate(jnp.asarray(s), jnp.asarray(u[0]), DT))


def test_analytic_jacobian_matches_jacrev():
    s, u = _states(np.random.default_rng(2), b=3)
    for i in range(len(s)):
        analytic = motion.unicycle_jacobian(t64(s[i]), t64(u[i]), DT)
        close(analytic, motion.unicycle_jacobian_autodiff(t64(s[i]), t64(u[i]), DT), atol=1e-14)
        close(analytic, j_motion.unicycle_jacobian_autodiff(jnp.asarray(s[i]), jnp.asarray(u[i]), DT))


def test_observation_matches_jax():
    rng = np.random.default_rng(3)
    s, _ = _states(rng)
    landmarks = 5.0 * rng.standard_normal((7, 2))
    close(observation.position_observe(t64(s)), j_obs.position_observe(jnp.asarray(s)))
    h = observation.position_jacobian(t64(s))
    assert h.shape == (16, 2, 4) and h.dtype == torch.float64
    close(h, j_obs.position_jacobian(jnp.asarray(s)))
    close(observation.range_observe(t64(s[:, :2]), t64(landmarks)),
          j_obs.range_observe(jnp.asarray(s[:, :2]), jnp.asarray(landmarks)))
    rng_t, bearing_t = observation.range_bearing_observe(t64(s[:, :3]), t64(landmarks))
    rng_j, bearing_j = j_obs.range_bearing_observe(jnp.asarray(s[:, :3]), jnp.asarray(landmarks))
    close(rng_t, rng_j)
    close(bearing_t, bearing_j)


# --- small-matrix algebra ---------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_smallmat_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    m = spd(rng, 16, n)
    rhs = rng.standard_normal((16, n, 3))
    tm, jm = t64(m), jnp.asarray(m)
    # closed forms reproduce the JAX closed forms to rounding; relative
    # tolerance because det and the inverse scale with the entries
    close(smallmat.det_small(tm), j_smallmat.det_small(jm), atol=0.0, rtol=1e-12)
    close(smallmat.inv_spd_small(tm), j_smallmat.inv_spd_small(jm), rtol=1e-12)
    close(smallmat.solve_spd_small(tm, t64(rhs)), j_smallmat.solve_spd_small(jm, jnp.asarray(rhs)),
          rtol=1e-12)
    close(smallmat.cholesky_small(tm), j_smallmat.cholesky_small(jm), rtol=1e-12)
    close(smallmat.cholesky_small(tm), np.linalg.cholesky(m), atol=1e-11, rtol=1e-9)


def test_cholesky_small_clips_non_positive_pivot():
    m = np.zeros((2, 3, 3))
    m[1] = np.diag([4.0, -1.0, 9.0])
    got = smallmat.cholesky_small(t64(m))
    close(got, j_smallmat.cholesky_small(jnp.asarray(m)), atol=0.0)
    tiny = torch.finfo(torch.float64).tiny
    assert float(got[0, 0, 0]) == math.sqrt(tiny)
    assert torch.isfinite(got).all()
