"""core/lie.py: every function of the port against the JAX package's, on the
same seeded numpy inputs, in f64 at rtol 1e-12 (atol 1e-15 for entries that
are exactly zero on one side): random inputs, small angles (theta² < 1e-12,
the Taylor branches), exact zeros and rotations near pi (so3_log's
symmetric-part branch). Also batched under `torch.func.vmap`, and the
tangent Jacobian of the SE(3) retraction under `torch.func.jacfwd` against
`jax.jacfwd`, finite at the identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core import lie as jlie
from rust_robotics_tpu_torch.core import lie as tlie

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

RTOL, ATOL = 1e-12, 1e-15


def _axes(rng, n):
    a = rng.standard_normal((n, 3))
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def phis(seed=0):
    """Rotation vectors: random, small (theta² < 1e-12), zero, near pi."""
    rng = np.random.default_rng(seed)
    random = 0.8 * rng.standard_normal((8, 3))
    small = 1e-7 * _axes(rng, 4)
    near_pi = _axes(rng, 4) * (np.pi - np.array([1e-6, 1e-5, 5e-5, 1e-3]))[:, None]
    return np.concatenate([random, small, np.zeros((1, 3)), near_pi])


def tangents6(seed=1):
    rng = np.random.default_rng(seed)
    p = phis(seed)
    rho = rng.standard_normal((len(p), 3))
    return np.concatenate([rho, p], axis=-1)


def tangents2(seed=2):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((10, 3))
    xi[6:8, 2] = [1e-9, -3e-9]  # |w| < 1e-8: the Taylor fallbacks
    xi[8, 2] = 0.0
    xi[9, 2] = np.pi - 1e-7
    return xi


def rotations():
    return np.asarray(jlie.so3_exp(jnp.asarray(phis(3))))


def se3_mats():
    return np.asarray(jlie.se3_exp(jnp.asarray(tangents6(4))))


def se2_mats():
    return np.asarray(jlie.se2_exp(jnp.asarray(tangents2(5))))


def devs(seed):
    xi = 0.1 * np.random.default_rng(seed).standard_normal((6, 6))
    return np.asarray(jlie.se3_expm1(jnp.asarray(xi)))


CASES = {
    "so2_exp": lambda: (np.concatenate([np.linspace(-3.2, 3.2, 9), [0.0, 1e-9]]),),
    "so2_log": lambda: (np.asarray(jlie.so2_exp(jnp.linspace(-3.1, 3.1, 9))),),
    "skew": lambda: (np.random.default_rng(6).standard_normal((5, 3)),),
    "unskew": lambda: (np.random.default_rng(7).standard_normal((5, 3, 3)),),
    "so3_exp": lambda: (phis(),),
    "so3_log": lambda: (rotations(),),
    "so3_left_jacobian": lambda: (phis(),),
    "so3_left_jacobian_inverse": lambda: (phis()[:-4],),  # its coefficient diverges at pi
    "se2_exp": lambda: (tangents2(),),
    "se2_log": lambda: (se2_mats(),),
    "se2_inverse": lambda: (se2_mats(),),
    "se2_adjoint": lambda: (se2_mats(),),
    "se2_from_pose": lambda: tuple(np.random.default_rng(8).standard_normal((3, 6))),
    "se2_to_pose": lambda: (se2_mats(),),
    "se3_exp": lambda: (tangents6(),),
    "se3_log": lambda: (se3_mats()[:-4],),  # J_l^-1 diverges at pi, as above
    "se3_inverse": lambda: (se3_mats(),),
    "se3_adjoint": lambda: (se3_mats(),),
    "se3_hat": lambda: (tangents6(),),
    "se3_expm1": lambda: (0.1 * np.random.default_rng(9).standard_normal((6, 6)),),
    "se3_compose_dev": lambda: (devs(10), devs(11)),
    "se3_logm1": lambda: (devs(12),),
}


def _leaves(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_in_f64(name):
    args = CASES[name]()
    want = _leaves(getattr(jlie, name)(*(jnp.asarray(a) for a in args)))
    got = _leaves(getattr(tlie, name)(*(torch.from_numpy(np.array(a)) for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_vmap_equals_the_batched_call(name):
    args = [torch.from_numpy(np.array(a)) for a in CASES[name]()]
    fn = getattr(tlie, name)
    for g, w in zip(_leaves(torch.func.vmap(fn)(*args)), _leaves(fn(*args))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)


def test_near_pi_log_recovers_the_rotation():
    """exp(log(R)) gives R back near pi to the atol of tests/test_lie.py's
    near-pi case (the branch is first order in the distance from pi)."""
    rot = torch.from_numpy(np.array(rotations()[-4:]))
    np.testing.assert_allclose(tlie.so3_exp(tlie.so3_log(rot)).numpy(), rot.numpy(), atol=1e-4)


def _retraction_jacobians(v):
    """d/dδ se3_log(se3_exp(v) @ se3_exp(δ)) at δ=0, in both packages."""
    want = jax.jacfwd(lambda d: jlie.se3_log(jlie.se3_exp(jnp.asarray(v)) @ jlie.se3_exp(d)))(
        jnp.zeros(6))
    vt = torch.from_numpy(v)
    got = torch.func.jacfwd(lambda d: tlie.se3_log(tlie.se3_exp(vt) @ tlie.se3_exp(d)))(
        torch.zeros(6, dtype=torch.float64))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("row", range(len(tangents6()) - 4))
def test_retraction_jacfwd_matches_jax(row):
    got, want = _retraction_jacobians(tangents6()[row])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_retraction_jacfwd_is_finite_at_the_identity():
    got, want = _retraction_jacobians(np.zeros(6))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.eye(6), atol=1e-15)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_jacfwd_under_vmap_matches_jax():
    v = tangents6()[:8]
    jfn = jax.vmap(jax.jacfwd(lambda d, x: jlie.se3_log(jlie.se3_exp(x) @ jlie.se3_exp(d))),
                   in_axes=(None, 0))
    tfn = torch.func.vmap(torch.func.jacfwd(
        lambda d, x: tlie.se3_log(tlie.se3_exp(x) @ tlie.se3_exp(d))), in_dims=(None, 0))
    want = jfn(jnp.zeros(6), jnp.asarray(v))
    got = tfn(torch.zeros(6, dtype=torch.float64), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_constants_follow_the_input_dtype():
    xi = torch.zeros(2, 6, dtype=torch.float32)
    for out in (tlie.se3_exp(xi), tlie.se3_expm1(xi), tlie.se3_hat(xi),
                tlie.se3_inverse(tlie.se3_exp(xi))):
        assert out.dtype == torch.float32
