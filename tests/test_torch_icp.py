"""ICP scan matching (`slam/icp.py`) against the JAX package's, on seeded
numpy clouds: JAX on the CPU at x64 (under `jax.vmap` for a batch of scan
pairs, as tests/test_icp_ba.py runs it), torch in float64 on the CPU, plus
a float32 case.

The current clouds carry 0.01 noise, so every error field sits well away
from zero. (On an exact transform the final distances are the rounding of
|c|² + |p|² − 2c·p near zero: sqrt of ~1e-15, noise at ~1e-8 whose digits
differ with the order of the sums.) Tolerances: iterations and
`converged` equal; the transform at atol 1e-9; every other `ICPResult`
field at rtol 1e-9 (the same association and the same closed-form steps;
~1e-15 measured). float32: the same iterations and convergence, the
transform within 1e-5 of JAX's f64 one (f32 rounding of 300-point sums of
coordinates up to ~15)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core.lie import se3_exp as j_se3_exp
from rust_robotics_tpu.slam import icp as ji
from rust_robotics_tpu_torch.slam import icp as ti

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
FIELDS = ("transform", "iterations", "final_error", "final_error_mean", "initial_error_mean",
          "final_error_median", "final_error_p90", "inlier_ratio_5cm",
          "relative_error_reduction", "converged")


def _rot2(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])


def _pair(d, seed, n=300):
    """prev [n, d]; cur = R prev + t + 0.01 noise."""
    rng = np.random.default_rng(seed)
    prev = 5.0 * rng.normal(size=(n, d))
    if d == 2:
        rot, t = _rot2(0.08), np.array([0.3, -0.2])
    else:
        m = np.asarray(j_se3_exp(jnp.array([0.2, -0.1, 0.15, 0.05, -0.04, 0.06])))
        rot, t = m[:3, :3], m[:3, 3]
    return prev, prev @ rot.T + t + 0.01 * rng.normal(size=(n, d))


def _assert_same(got, want):
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in ("iterations", "converged"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "transform":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-15, err_msg=name)


def test_nearest_neighbor_matches_jax():
    prev, cur = _pair(2, 0)
    want_idx, want_dist = ji.nearest_neighbor(jnp.asarray(prev), jnp.asarray(cur))
    idx, dist = ti.nearest_neighbor(torch.tensor(prev), torch.tensor(cur))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist), rtol=1e-9)


@pytest.mark.parametrize("d", [2, 3])
def test_svd_motion_estimation_matches_jax(d):
    prev, cur = _pair(d, 1)
    want_r, want_t = ji.svd_motion_estimation(jnp.asarray(prev), jnp.asarray(cur))
    r, t = ti.svd_motion_estimation(torch.tensor(prev), torch.tensor(cur))
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), atol=1e-12)
    np.testing.assert_allclose(r.numpy() @ r.numpy().T, np.eye(d), atol=1e-12)
    assert np.linalg.det(r.numpy()) > 0


@pytest.mark.parametrize("d", [2, 3])
def test_icp_matches_jax(d):
    prev, cur = _pair(d, 2)
    want = ji.icp_matching(jnp.asarray(prev), jnp.asarray(cur))
    got = ti.icp_matching(prev, cur, device="cpu", dtype=F64)
    _assert_same(got, want)
    assert bool(got.converged) and 2 < int(got.iterations) < ti.MAX_ITER
    assert got.transform.shape == (d + 1, d + 1)


@pytest.mark.parametrize("shared_prev", [True, False])
def test_icp_batched_matches_jax_vmap(shared_prev):
    """Three scan pairs in lock-step: against `jax.vmap` of the JAX loop
    (one reference cloud shared, or one per pair), and each lane against its
    own solo run, bitwise (the freeze rule and batch-invariant arithmetic)."""
    rng = np.random.default_rng(3)
    prevs = 5.0 * rng.normal(size=(3, 100, 2))
    if shared_prev:
        prevs = np.broadcast_to(prevs[0], prevs.shape)
    curs = np.stack([p @ _rot2(th).T + 0.1 + 0.01 * rng.normal(size=(100, 2))
                     for p, th in zip(prevs, (0.05, -0.07, 0.2))])
    if shared_prev:
        want = jax.vmap(lambda c: ji.icp_matching(jnp.asarray(prevs[0]), c))(jnp.asarray(curs))
        got = ti.icp_matching(prevs[0], curs, device="cpu", dtype=F64)
    else:
        want = jax.vmap(ji.icp_matching)(jnp.asarray(prevs), jnp.asarray(curs))
        got = ti.icp_matching(prevs, curs, device="cpu", dtype=F64)
    _assert_same(got, want)
    assert len(set(got.iterations.tolist())) > 1  # the lanes stop at different steps
    for k in range(3):
        solo = ti.icp_matching(prevs[k], curs[k], device="cpu", dtype=F64)
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(solo, name).numpy(),
                                          getattr(got, name)[k].numpy(), err_msg=name)


def test_icp_float32():
    prev, cur = _pair(2, 2)
    want = ji.icp_matching(jnp.asarray(prev), jnp.asarray(cur))
    got = ti.icp_matching(torch.tensor(prev, dtype=torch.float32),
                          torch.tensor(cur, dtype=torch.float32), device="cpu")
    assert got.transform.dtype == torch.float32 and got.final_error.dtype == torch.float32
    assert (int(got.iterations), bool(got.converged)) == \
        (int(want.iterations), bool(want.converged))
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-5)
