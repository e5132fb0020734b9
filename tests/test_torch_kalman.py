"""The port's Kalman family against the JAX package, on the same numpy
inputs made from a seed.

EKF steps (analytic and autodiff Jacobians), IEKF, CKF and the information
filter are held at 1e-12 in float64. The UKF's default weights (α = 1e-3)
sum to ~2e6 in magnitude with opposite signs, so each weighted sum over
sigma points of magnitude ~10 carries a cancellation error of up to
2e6 · 10 · 1.1e-16 ≈ 2e-9 on either side; it is held at 1e-8, and at 1e-12
with α = 1, where the weights are O(1). The EnKF
draws from torch's generator, whose bits differ from JAX's, so it is checked
by behaviour: it tracks the demo circle, as tests/test_kalman.py does.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core.types import GaussianBelief as JBelief
from rust_robotics_tpu.filters import kalman as jk
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters import kalman as tk
from rust_robotics_tpu_torch.models.motion import unicycle_propagate
from rust_robotics_tpu_torch.models.observation import position_observe

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

DT = 0.1
ATOL = 1e-12


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), atol=atol, rtol=0.0)


def make_case(seed, b=8, sensors=None):
    """A batch of beliefs near the demo circle, with measurements, controls
    and the demo's noise model, as numpy f64."""
    rng = np.random.default_rng(seed)
    mean = np.stack([10 + rng.standard_normal(b), rng.standard_normal(b),
                     math.pi / 2 + 0.3 * rng.standard_normal(b), rng.random(b)], -1)
    a = 0.3 * rng.standard_normal((b, 4, 4))
    cov = a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(4)
    zshape = (b, 2) if sensors is None else (b, sensors, 2)
    z = mean[..., None, :2] if sensors else mean[:, :2]
    z = z + 0.5 * rng.standard_normal(zshape)
    u = np.stack([1.0 + 0.1 * rng.standard_normal(b), 0.1 + 0.02 * rng.standard_normal(b)], -1)
    q = np.diag([0.01, 0.01, np.deg2rad(1.0) ** 2, 0.01])
    r = np.eye(2) + 0.1 * np.array([[0.0, 1.0], [1.0, 0.0]])
    return mean, cov, z, u, q, r


def both(case):
    """(torch args, jax args) for (belief, z, u, dt, q, r)."""
    mean, cov, z, u, q, r = case
    t = (GaussianBelief(t64(mean), t64(cov)), t64(z), t64(u), DT, t64(q), t64(r))
    j = (JBelief(jnp.asarray(mean), jnp.asarray(cov)), jnp.asarray(z), jnp.asarray(u), DT,
         jnp.asarray(q), jnp.asarray(r))
    return t, j


def models():
    """(port model, JAX model) pairs: analytic Jacobians, and autodiff
    Jacobians derived from the nonlinear maps."""
    from rust_robotics_tpu.models.motion import unicycle_propagate as j_prop
    from rust_robotics_tpu.models.observation import position_observe as j_obs

    return {
        "analytic": (tk.unicycle_position_model(), jk.unicycle_position_model()),
        "autodiff": (tk.StateSpaceModel(unicycle_propagate, position_observe),
                     jk.StateSpaceModel(j_prop, j_obs)),
    }


def close_belief(got, want, atol=ATOL):
    close(got.mean, want.mean, atol)
    close(got.cov, want.cov, atol)


@pytest.mark.parametrize("kind", ["analytic", "autodiff"])
def test_ekf_predict_update_step_match_jax(kind):
    tm, jm = models()[kind]
    (tb, tz, tu, dt, tq, tr), (jb, jz, ju, _, jq, jr) = both(make_case(0))
    close_belief(tk.ekf_predict(tb, tu, dt, tq, tm), jk.ekf_predict(jb, ju, dt, jq, jm))
    close_belief(tk.ekf_update(tb, tz, tr, tm), jk.ekf_update(jb, jz, jr, jm))
    close_belief(tk.ekf_step(tb, tz, tu, dt, tq, tr, tm), jk.ekf_step(jb, jz, ju, dt, jq, jr, jm))
    got, y, s = tk.ekf_step_with_innovation(tb, tz, tu, dt, tq, tr, tm)
    want, jy, js = jk.ekf_step_with_innovation(jb, jz, ju, dt, jq, jr, jm)
    close_belief(got, want)
    close(y, jy)
    close(s, js)


def test_autodiff_model_jacobians_match_analytic():
    analytic, autodiff = models()["analytic"][0], models()["autodiff"][0]
    mean, _, _, u, _, _ = make_case(1)
    # a [2, 4]-batched state exercises the flatten/reshape around vmap(jacrev)
    state, control = t64(mean.reshape(2, 4, 4)), t64(u.reshape(2, 4, 2))
    close(autodiff.motion_jac(state, control, DT), analytic.motion_jac(state, control, DT))
    close(autodiff.obs_jac(state), analytic.obs_jac(state))
    assert autodiff.motion_jac(state, control, DT).shape == (2, 4, 4, 4)


def test_ekf_step_unbatched_and_default_model():
    (tb, tz, tu, dt, tq, tr), (jb, jz, ju, _, jq, jr) = both(make_case(2, b=1))
    one_t = GaussianBelief(tb.mean[0], tb.cov[0])
    one_j = JBelief(jb.mean[0], jb.cov[0])
    close_belief(tk.ekf_step(one_t, tz[0], tu[0], dt, tq, tr),
                 jk.ekf_step(one_j, jz[0], ju[0], dt, jq, jr))


def test_ekf_step_f32_matches_jax_f64():
    mean, cov, z, u, q, r = make_case(3, b=64)
    t32 = [torch.tensor(a, dtype=torch.float32) for a in (mean, cov, z, u, q, r)]
    got = tk.ekf_step(GaussianBelief(t32[0], t32[1]), t32[2], t32[3], DT, t32[4], t32[5])
    _, (jb, jz, ju, _, jq, jr) = both((mean, cov, z, u, q, r))
    want = jk.ekf_step(jb, jz, ju, DT, jq, jr)
    # float32 rounding of values of order 10 (mean) and 1 (cov)
    close(got.mean.double(), want.mean, atol=1e-5)
    close(got.cov.double(), want.cov, atol=1e-6)


@pytest.mark.parametrize("kind", ["analytic", "autodiff"])
def test_iekf_matches_jax(kind):
    tm, jm = models()[kind]
    (tb, tz, tu, dt, tq, tr), (jb, jz, ju, _, jq, jr) = both(make_case(4))
    close_belief(tk.iekf_step(tb, tz, tu, dt, tq, tr, tm, iterations=3),
                 jk.iekf_step(jb, jz, ju, dt, jq, jr, jm, iterations=3))


def test_ukf_weights_match_jax():
    for args in ((4,), (4, 0.5, 2.0, 1.0), (2, 1.0, 0.0, 0.0)):
        got = tk.ukf_weights(*args, dtype=torch.float64, device="cpu")
        want = jk.ukf_weights(*args, dtype=jnp.float64)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)


def test_ukf_matches_jax():
    (tb, tz, tu, dt, tq, tr), (jb, jz, ju, _, jq, jr) = both(make_case(5))
    close_belief(tk.ukf_step(tb, tz, tu, dt, tq, tr), jk.ukf_step(jb, jz, ju, dt, jq, jr),
                 atol=1e-8)
    # with α = 1 the weights are O(1) and the UKF is held at 1e-12
    close_belief(tk.ukf_step(tb, tz, tu, dt, tq, tr, alpha=1.0, kappa=1.0),
                 jk.ukf_step(jb, jz, ju, dt, jq, jr, alpha=1.0, kappa=1.0))


def test_ckf_matches_jax():
    (tb, tz, tu, dt, tq, tr), (jb, jz, ju, _, jq, jr) = both(make_case(6))
    close_belief(tk.ckf_step(tb, tz, tu, dt, tq, tr), jk.ckf_step(jb, jz, ju, dt, jq, jr))


@pytest.mark.parametrize("sensors", [1, 3])
def test_information_step_matches_jax(sensors):
    (tb, tz, tu, dt, tq, tr), (jb, jz, ju, _, jq, jr) = both(make_case(7, sensors=sensors))
    close_belief(tk.information_step(tb, tz, tu, dt, tq, tr),
                 jk.information_step(jb, jz, ju, dt, jq, jr))


def test_information_step_one_sensor_equals_ekf():
    (tb, tz, tu, dt, tq, tr), _ = both(make_case(8))
    close_belief(tk.information_step(tb, tz[:, None, :], tu, dt, tq, tr),
                 tk.ekf_step(tb, tz, tu, dt, tq, tr), atol=1e-10)


def test_ensemble_statistics_matches_jax():
    ens = np.random.default_rng(9).standard_normal((3, 16, 4))
    close_belief(tk.ensemble_statistics(t64(ens)), jk.ensemble_statistics(jnp.asarray(ens)))


def test_enkf_tracks_circle():
    """Behaviour, not bits: the EnKF follows the demo circle within the
    RMSE bound of tests/test_kalman.py::test_enkf_tracks_circle."""
    from rust_robotics_tpu_torch.demos.ekf_localization import default_ekf_noise, deterministic_noise

    q, r = default_ekf_noise(device="cpu", dtype=torch.float64)
    q_chol, r_chol = torch.linalg.cholesky(q), torch.linalg.cholesky(r)
    gen = torch.Generator().manual_seed(7)
    start = torch.tensor([10.0, 0.0, math.pi / 2, 0.0], dtype=torch.float64)
    ens = start + 0.1 * torch.randn((64, 4), generator=gen, dtype=torch.float64)
    truth = start.clone()
    err = []
    for k in range(330):
        x = truth[0] + torch.cos(truth[2]) * DT
        y = truth[1] + torch.sin(truth[2]) * DT
        truth = torch.stack([x, y, truth[2] + 0.1 * DT, torch.ones_like(x)])
        u = torch.tensor([1.0 + deterministic_noise(float(k), 0.12, 0.2),
                          0.1 + deterministic_noise(float(k), 0.04, 1.0)], dtype=torch.float64)
        z = torch.stack([x + deterministic_noise(float(k), 0.6, 2.0),
                         y + deterministic_noise(float(k), 0.6, 2.7)])
        ens = tk.enkf_step(ens, z, u, DT, q_chol, r_chol, gen)
        err.append(tk.ensemble_statistics(ens).mean[:2] - truth[:2])
    rmse = float(torch.sqrt(torch.mean(torch.stack(err) ** 2)))
    assert rmse < 0.6, rmse
    assert ens.shape == (64, 4) and torch.isfinite(ens).all()
