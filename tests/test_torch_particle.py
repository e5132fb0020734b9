"""Particle filter / MCL: the port's `filters.particle` against the JAX
package's on the same seeded numpy inputs, in f64 at 1e-12.

JAX draws from PRNG keys and the port from `torch.Generator`s, so the
random paths are compared in two ways: with the control noise set to zero
(predict is then deterministic) or with the uniforms JAX drew fed to the
port's inverse-CDF helper; and by behaviour (noise moments, resampled
particles drawn from the originals, uniform weights after a resample).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.filters import particle as jpf
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.filters import particle as tpf

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

LANDMARKS = np.array([[10.0, 0.0], [10.0, 10.0], [0.0, 15.0], [-5.0, 20.0]])
DT = 0.1
CONTROL = np.array([1.0, 0.1])
ATOL = 1e-12


def cloud(b=3, p=64, seed=0, spread=0.5):
    """states [B, P, 4] around the origin, normalised random weights [B, P]."""
    rng = np.random.default_rng(seed)
    states = spread * rng.standard_normal((b, p, 4))
    w = rng.uniform(0.1, 1.0, size=(b, p))
    return states, w / w.sum(-1, keepdims=True)


def ranges(b, seed=1):
    rng = np.random.default_rng(seed)
    truth = rng.uniform(-0.5, 0.5, size=(b, 2))
    return np.linalg.norm(LANDMARKS[None] - truth[:, None], axis=-1) \
        + 0.1 * rng.standard_normal((b, len(LANDMARKS)))


def both(states, w):
    return (jpf.ParticleBelief(jnp.asarray(states), jnp.asarray(w)),
            convert.particles_from_numpy(states, w, device="cpu", dtype=torch.float64))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0.0)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_predict_without_control_noise_matches_jax():
    jb, tb = both(*cloud())
    want = jpf.pf_predict(jb, jnp.asarray(CONTROL), DT, jnp.zeros(2), jax.random.PRNGKey(0))
    got = tpf.pf_predict(tb, torch.from_numpy(CONTROL), DT, (0.0, 0.0), gen())
    close(got.states, want.states)
    assert got.weights is tb.weights


def test_likelihood_update_neff_and_estimate_match_jax():
    states, w = cloud(seed=2)
    jb, tb = both(states, w)
    x = np.linspace(-3.0, 3.0, 41)
    for sigma in (0.2, 1.5):
        close(tpf.gauss_likelihood(torch.from_numpy(x), sigma),
              jpf.gauss_likelihood(jnp.asarray(x), sigma))
    z = ranges(3)
    mask = np.array([[True, True, False, True], [False, False, False, True],
                     [True, True, True, True]])
    for lm_mask in (None, mask):
        want = jpf.pf_update_ranges(jb, jnp.asarray(z), jnp.asarray(LANDMARKS), 0.3,
                                    None if lm_mask is None else jnp.asarray(lm_mask))
        got = tpf.pf_update_ranges(tb, torch.from_numpy(z), torch.from_numpy(LANDMARKS), 0.3,
                                   None if lm_mask is None else torch.from_numpy(lm_mask))
        close(got.weights, want.weights)
        close(got.weights.sum(-1), np.ones(3))
        close(tpf.effective_particles(got.weights), jpf.effective_particles(want.weights),
              atol=1e-9)
        est_t, est_j = tpf.pf_estimate(got), jpf.pf_estimate(want)
        close(est_t.mean, est_j.mean)
        close(est_t.cov, est_j.cov)
    close(tpf.effective_particles(torch.from_numpy(w)), jpf.effective_particles(jnp.asarray(w)),
          atol=1e-9)


def test_float32_weight_floor_underflows_as_in_jax():
    """jnp.clip(w, 1e-300) on float32 clips at 0.0 (the scalar underflows);
    torch.clamp does the same, so a zero weight stays -inf in log space."""
    states, w = cloud(b=1, p=8, seed=3)
    w[0, 2] = 0.0
    z = ranges(1)
    want = jpf.pf_update_ranges(jpf.ParticleBelief(jnp.asarray(states, jnp.float32),
                                                   jnp.asarray(w, jnp.float32)),
                                jnp.asarray(z, jnp.float32), jnp.asarray(LANDMARKS, jnp.float32),
                                0.3)
    tb = convert.particles_from_numpy(states, w, device="cpu")
    got = tpf.pf_update_ranges(tb, torch.tensor(z, dtype=torch.float32),
                               torch.tensor(LANDMARKS, dtype=torch.float32), 0.3)
    assert float(got.weights[0, 2]) == 0.0 == float(want.weights[0, 2])
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-5)


@pytest.mark.parametrize("batch", [(), (5,)])
def test_resamplers_through_the_helper_with_jax_uniforms(batch):
    rng = np.random.default_rng(4)
    p = 50
    w = rng.uniform(size=batch + (p,)) ** 3
    w = w / w.sum(-1, keepdims=True)
    key = jax.random.PRNGKey(7)
    tw = torch.from_numpy(w)

    u = np.array(jax.random.uniform(key, batch + (1,), dtype=jnp.float64))
    want = np.asarray(jpf.systematic_resample(key, jnp.asarray(w)))
    got = tpf.inverse_cdf(tw, tpf.systematic_positions(torch.from_numpy(u), p))
    np.testing.assert_array_equal(got.numpy(), want)

    u = np.array(jax.random.uniform(key, batch + (p,), dtype=jnp.float64))
    want = np.asarray(jpf.multinomial_resample(key, jnp.asarray(w)))
    np.testing.assert_array_equal(tpf.inverse_cdf(tw, torch.from_numpy(u)).numpy(), want)

    # the port's own draws go through the same helper
    u = torch.rand(batch + (1,), generator=gen(3), dtype=torch.float64)
    np.testing.assert_array_equal(tpf.systematic_resample(gen(3), tw).numpy(),
                                  tpf.inverse_cdf(tw, tpf.systematic_positions(u, p)).numpy())
    u = torch.rand(batch + (p,), generator=gen(3), dtype=torch.float64)
    np.testing.assert_array_equal(tpf.multinomial_resample(gen(3), tw).numpy(),
                                  tpf.inverse_cdf(tw, u).numpy())


def test_pf_step_without_noise_or_resampling_matches_jax():
    states, w = cloud(seed=5)
    jb, tb = both(states, w)
    for k in range(3):
        z = ranges(3, seed=10 + k)
        lm_mask = np.array([True, True, k != 1, True])
        jb, jest = jpf.pf_step(jb, jnp.asarray(CONTROL), jnp.asarray(z), jnp.asarray(LANDMARKS),
                               DT, jax.random.PRNGKey(k), jnp.zeros(2), 0.3,
                               resample_threshold=0.0, landmark_mask=jnp.asarray(lm_mask))
        tb, test = tpf.pf_step(tb, torch.from_numpy(CONTROL), torch.from_numpy(z),
                               torch.from_numpy(LANDMARKS), DT, gen(k), (0.0, 0.0), 0.3,
                               resample_threshold=0.0, landmark_mask=torch.from_numpy(lm_mask))
        close(tb.states, jb.states)
        close(tb.weights, jb.weights)
        close(test.mean, jest.mean)
        close(test.cov, jest.cov)


def test_kld_required_particles_matches_jax():
    rng = np.random.default_rng(6)
    states = np.concatenate([rng.normal(0, s, (2, 300, 4)) for s in (0.05, 2.0)])
    mask = rng.uniform(size=(4, 300)) < 0.8
    mask[1] = False
    mask[1, 5] = True  # one live particle: one bin
    for max_p in (None, 300):
        want = jpf.kld_required_particles(jnp.asarray(states), jnp.asarray(mask),
                                          (0.5, 0.2617993877991494), max_particles=max_p)
        got = tpf.kld_required_particles(torch.from_numpy(states), torch.from_numpy(mask),
                                         (0.5, 0.2617993877991494), max_particles=max_p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == 1 and got[3] > got[0]


def test_mcl_step_without_control_noise_matches_jax():
    states, w = cloud(b=2, p=256, seed=7, spread=1.5)
    jb, tb = both(states, w)
    mask = np.ones((2, 256), bool)
    mask[1, 200:] = False
    z = ranges(2, seed=8)
    args = (jnp.asarray(CONTROL), jnp.asarray(z), jnp.asarray(LANDMARKS), DT)
    jnew, jmask, jest, jn = jpf.mcl_step(jb, jnp.asarray(mask), *args, jax.random.PRNGKey(1),
                                         jnp.zeros(2), 0.3)
    tnew, tmask, test, tn = tpf.mcl_step(tb, torch.from_numpy(mask), torch.from_numpy(CONTROL),
                                         torch.from_numpy(z), torch.from_numpy(LANDMARKS), DT,
                                         gen(1), (0.0, 0.0), 0.3)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tnew.weights.numpy(), np.asarray(jnew.weights))
    # it always resamples: every state is one of the predicted particles
    predicted = tpf.pf_predict(tb, torch.from_numpy(CONTROL), DT, (0.0, 0.0), gen()).states
    for b in range(2):
        match = (tnew.states[b][:, None, :] == predicted[b][None, :, :]).all(-1).any(-1)
        assert match.all()
    assert test.mean.shape == (2, 4) and torch.isfinite(test.cov).all()


def test_noise_moments_of_init_and_predict():
    n = 20000
    mean = torch.tensor([[1.0, -2.0, 0.0, 0.5]], dtype=torch.float64)
    belief = tpf.init_particles(gen(11), mean, 0.3, n)
    assert belief.states.shape == (1, n, 4) and float(belief.weights.sum()) == pytest.approx(1.0)
    sd = belief.states[0].std(0)
    assert torch.allclose(belief.states[0].mean(0), mean[0], atol=5 * 0.3 / n**0.5)
    assert torch.allclose(sd, torch.full((4,), 0.3, dtype=torch.float64), rtol=0.03)

    # from yaw 0: x' - x = dt·v and yaw' - yaw = dt·ω recover the noisy control
    flat = tpf.ParticleBelief(torch.zeros(1, n, 4, dtype=torch.float64), belief.weights)
    std = (0.2, 0.05)
    out = tpf.pf_predict(flat, torch.from_numpy(CONTROL), DT, std, gen(12)).states[0]
    v, om = out[:, 0] / DT, out[:, 2] / DT
    for x, mu, s in ((v, CONTROL[0], std[0]), (om, CONTROL[1], std[1])):
        assert abs(float(x.mean()) - mu) < 5 * s / n**0.5
        assert float(x.std()) == pytest.approx(s, rel=0.03)
    assert torch.allclose(out[:, 3], v, atol=1e-12)  # the speed slot holds the noisy v


def test_resampling_draws_from_the_originals_with_uniform_weights():
    states, w = cloud(b=2, p=128, seed=13)
    w = w**8
    w = w / w.sum(-1, keepdims=True)  # degenerate: N_eff far below P/2
    _, tb = both(states, w)
    out = tpf.resample_if_needed(tb, gen(14))
    assert torch.equal(out.weights, torch.full_like(tb.weights, 1.0 / 128))
    for b in range(2):
        assert (out.states[b][:, None] == tb.states[b][None]).all(-1).any(-1).all()
    # N_eff above the threshold: nothing changes
    even = tpf.ParticleBelief(tb.states, torch.full_like(tb.weights, 1.0 / 128))
    same = tpf.resample_if_needed(even, gen(14))
    assert torch.equal(same.states, even.states) and torch.equal(same.weights, even.weights)
    # systematic counts follow the weights
    wt = torch.tensor([0.5, 0.25, 0.125, 0.0625, 0.0625], dtype=torch.float64)
    idx = tpf.systematic_resample(gen(15), wt.expand(2000, 5))
    counts = torch.bincount(idx.reshape(-1), minlength=5).double() / idx.numel()
    assert torch.allclose(counts, wt, atol=0.01)


def test_fused_resample_matches_pallas_path_and_the_plain_resampler():
    rng = np.random.default_rng(16)
    b, p, n = 2, 128, 4
    states = rng.standard_normal((b, p, n)).astype(np.float32)
    w = rng.uniform(size=(b, p)).astype(np.float32) ** 4 + 1e-7
    w = w / w.sum(-1, keepdims=True)
    want = jpf.resample_if_needed_pallas(jpf.ParticleBelief(jnp.asarray(states), jnp.asarray(w)),
                                         jax.random.PRNGKey(9))
    tb = convert.particles_from_numpy(states, w, device="cpu")
    got = tpf.resample_if_needed_fused(tb, gen(17))
    # degenerate weights: both resample, to uniform weights, from the originals
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_array_equal(got.weights.numpy(), np.full((b, p), 1.0 / p, np.float32))
    for bi in range(b):
        src = torch.from_numpy(states[bi])
        for s in (got.states[bi], torch.from_numpy(np.array(want.states[bi]))):
            assert (s[:, None] == src[None]).all(-1).any(-1).all()
    # given the same generator state, it is resample_if_needed (systematic)
    plain = tpf.resample_if_needed(tb, gen(17))
    assert torch.equal(got.states, plain.states) and torch.equal(got.weights, plain.weights)
