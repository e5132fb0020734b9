"""The remaining localizers (`filters/extra.py`) against the JAX package's,
on numpy inputs made from a seed: JAX on the CPU at x64, torch in float64
on the CPU.

Tolerances: 1e-12 for the complementary, histogram and adaptive filters
(the same elementwise formulas; the histogram's box convolution and sums
reorder a few additions of O(1/W·H) values, ~1e-18 measured). The SR-UKF
at 1e-8: its default weights (α = 1e-3) reach ~1e6 in magnitude with
opposite signs, so each weighted sum over sigma points of magnitude ~10
carries a cancellation error of ~1e6 · 10 · 1.1e-16 ≈ 1e-9 on either side
(1.3e-9 measured); tests/test_filters_extra.py holds the JAX SR-UKF to the
UKF at the same 1e-8. Batches are held to `jax.vmap` of the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core.types import GaussianBelief as JBelief
from rust_robotics_tpu.filters import extra as je
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters import extra as te
from rust_robotics_tpu_torch.filters.kalman import ukf_step
from rust_robotics_tpu_torch.ops.smallmat import householder_r

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

DT = 0.1
ATOL = 1e-12
SR_ATOL = 1e-8
Q = np.diag([0.1, 0.1, np.deg2rad(1.0), 1.0]) ** 2
R = np.diag([1.0, 1.0]) ** 2


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0.0)


def test_complementary_step_matches_jax_batched():
    rng = np.random.default_rng(0)
    state, z, u = rng.normal(size=(5, 4)), rng.normal(size=(5, 2)), rng.normal(size=(5, 2))
    for alpha in (0.98, 0.5, 1.0):
        want = jax.vmap(lambda s, zz, uu: je.complementary_step(s, zz, uu, DT, alpha))(
            jnp.asarray(state), jnp.asarray(z), jnp.asarray(u))
        close(te.complementary_step(t64(state), t64(z), t64(u), DT, alpha), want)


def _raster(seed, shape=(20, 16)):
    b = np.random.default_rng(seed).uniform(size=shape)
    return b / b.sum(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_histogram_predict_matches_jax(k):
    """The rounded shift (halves to even: 0.25 / 0.5 rounds 0.5 to 0) and the
    "same" box convolution, odd and even k."""
    cfg = je.HistogramConfig(width=20, height=16, motion_noise_kernel=k)
    b = _raster(k)
    predict = jax.jit(lambda bb, d: je.histogram_predict(bb, d, cfg))
    for du in ([1.0, -0.5], [0.25, 0.75], [-3.2, 2.6], [0.0, 0.0]):
        want = predict(jnp.asarray(b), jnp.asarray(du))
        close(te.histogram_predict(t64(b), t64(du), cfg), want)


def test_histogram_predict_batch_matches_vmap():
    cfg = je.HistogramConfig(width=20, height=16)
    b = _raster(7, (3, 20, 16))
    du = np.array([[1.0, -0.5], [-2.2, 0.4], [0.6, 3.1]])
    want = jax.vmap(lambda bb, d: je.histogram_predict(bb, d, cfg))(jnp.asarray(b), jnp.asarray(du))
    close(te.histogram_predict(t64(b), t64(du), cfg), want)


def test_histogram_update_and_estimate_match_jax_batched():
    cfg = je.HistogramConfig(width=20, height=16)
    lm = np.array([[5.0, 5.0], [-5.0, 5.0], [0.0, -5.0]])
    b = _raster(3, (2, 20, 16))
    z = np.array([[7.0, 8.0, 6.0], [5.5, 9.0, 4.0]])
    want = jax.vmap(lambda bb, zz: je.histogram_update_ranges(bb, zz, jnp.asarray(lm), cfg))(
        jnp.asarray(b), jnp.asarray(z))
    got = te.histogram_update_ranges(t64(b), t64(z), t64(lm), cfg)
    close(got, want)
    close(te.histogram_estimate(got, cfg),
          jax.vmap(lambda bb: je.histogram_estimate(bb, cfg))(want))


def test_histogram_filter_localizes_as_jax():
    """tests/test_filters_extra.py's run, both packages, on the default 80×80
    raster."""
    cfg = je.HistogramConfig()
    lm = np.array([[5.0, 5.0], [-5.0, 5.0], [0.0, -5.0]])
    truth = np.array([2.0, 1.0])
    jb = je.histogram_init(cfg, jnp.float64)
    tb = te.histogram_init(cfg, torch.float64, device="cpu")
    close(tb, jb)
    rng = np.random.default_rng(0)
    for _ in range(4):
        z = np.linalg.norm(lm - truth, axis=-1) + 0.1 * rng.standard_normal(3)
        jb = je.histogram_predict(je.histogram_update_ranges(jb, jnp.asarray(z), jnp.asarray(lm),
                                                             cfg), jnp.zeros(2), cfg)
        tb = te.histogram_predict(te.histogram_update_ranges(tb, t64(z), t64(lm), cfg),
                                  torch.zeros(2, dtype=torch.float64), cfg)
    close(tb, jb)
    est = te.histogram_estimate(tb, cfg).numpy()
    assert np.linalg.norm(est - truth) < 0.5, est


def test_householder_r_gives_the_gram_matrix_of_lapack_qr():
    a = np.random.default_rng(1).normal(size=(3, 12, 4))
    r = householder_r(t64(a)).numpy()
    want = np.asarray(jnp.linalg.qr(jnp.asarray(a), mode="r"))
    np.testing.assert_array_equal(r, np.triu(r))
    np.testing.assert_allclose(np.swapaxes(r, -1, -2) @ r, np.swapaxes(want, -1, -2) @ want,
                               atol=1e-12, rtol=0.0)
    # a zero column leaves its reflection out
    a[:, :, 2] = 0.0
    r = householder_r(t64(a)).numpy()
    np.testing.assert_allclose(np.swapaxes(r, -1, -2) @ r, np.swapaxes(a, -1, -2) @ a, atol=1e-12)


def _sr_case(b=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    mean = np.array([10.0, 0.0, np.pi / 2, 0.0]) + 0.3 * rng.normal(size=lead + (4,))
    a = rng.normal(size=lead + (4, 4))
    cov = a @ np.swapaxes(a, -1, -2) + np.eye(4)
    z = np.array([10.1, 0.2]) + 0.1 * rng.normal(size=lead + (2,))
    u = np.array([1.0, 0.1]) + 0.05 * rng.normal(size=lead + (2,))
    return mean, np.linalg.cholesky(cov), z, u


QC, RC = np.linalg.cholesky(Q), np.linalg.cholesky(R)
# the JAX oracles under jax.jit: one compile per function, shared by the cases
jax_sr_ukf = jax.jit(lambda m, s, z, u: je.sr_ukf_step(m, s, z, u, DT, jnp.asarray(QC),
                                                       jnp.asarray(RC)))
jax_adaptive = jax.jit(lambda m, c, use, z, u: je.adaptive_step(
    JBelief(m, c), use, z, u, DT, jnp.asarray(Q), jnp.asarray(R)))


def test_sr_ukf_step_matches_jax_and_the_ukf():
    mean, l_cov, z, u = _sr_case()
    wm, ws = jax_sr_ukf(*map(jnp.asarray, (mean, l_cov, z, u)))
    gm, gs = te.sr_ukf_step(*map(t64, (mean, l_cov, z, u)), DT, t64(QC), t64(RC))
    close(gm, wm, SR_ATOL)
    close(gs, ws, SR_ATOL)
    ref = ukf_step(GaussianBelief(t64(mean), t64(l_cov @ l_cov.T)), t64(z), t64(u), DT,
                   t64(Q), t64(R))
    close(gm, ref.mean.numpy(), SR_ATOL)
    close(gs @ gs.T, ref.cov.numpy(), SR_ATOL)


def test_sr_ukf_step_batch_matches_vmap_and_stays_pd():
    mean, l_cov, z, u = _sr_case(b=4, seed=2)
    wm, ws = jax.vmap(jax_sr_ukf)(*map(jnp.asarray, (mean, l_cov, z, u)))
    m, s = convert.sqrt_belief_from_numpy(mean, l_cov, device="cpu", dtype=torch.float64)
    gm, gs = te.sr_ukf_step(m, s, t64(z), t64(u), DT, t64(QC), t64(RC))
    close(gm, wm, SR_ATOL)
    close(gs, ws, SR_ATOL)
    for k in range(10):
        gm, gs = te.sr_ukf_step(gm, gs, gm[..., :2] + 0.1 * np.sin(k), t64(u), DT, t64(QC),
                                t64(RC))
    diag = torch.diagonal(gs, dim1=-2, dim2=-1)
    assert torch.isfinite(diag).all() and (diag > 0).all()


@pytest.mark.parametrize("use_ckf", [False, True])
@pytest.mark.parametrize("z", [[0.1, 0.0], [50.0, -30.0], [3.2, 1.0]])
def test_adaptive_step_matches_jax(use_ckf, z):
    u = np.array([1.0, 0.0])
    jb, ju, jn = jax_adaptive(jnp.zeros(4), jnp.eye(4), jnp.asarray(use_ckf), jnp.asarray(z),
                              jnp.asarray(u))
    tb, tu, tn = te.adaptive_step(GaussianBelief(torch.zeros(4, dtype=torch.float64),
                                                 torch.eye(4, dtype=torch.float64)),
                                  torch.tensor(use_ckf), t64(z), t64(u), DT, t64(Q), t64(R))
    close(tb.mean, jb.mean)
    close(tb.cov, jb.cov)
    close(tn, jn)
    assert bool(tu) == bool(ju)


def test_adaptive_step_batch_matches_vmap():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(6, 4))
    cov = np.broadcast_to(np.eye(4), (6, 4, 4)).copy()
    use = np.array([False, True, False, True, False, True])
    z = mean[:, :2] + np.concatenate([0.1 * rng.normal(size=(3, 2)),
                                      30.0 * rng.normal(size=(3, 2))])
    u = np.tile([1.0, 0.1], (6, 1))
    jb, ju, jn = jax.vmap(jax_adaptive)(*map(jnp.asarray, (mean, cov, use, z, u)))
    tb, tu, tn = te.adaptive_step(GaussianBelief(t64(mean), t64(cov)), torch.tensor(use),
                                  t64(z), t64(u), DT, t64(Q), t64(R))
    close(tb.mean, jb.mean)
    close(tb.cov, jb.cov)
    close(tn, jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
