"""Batched particle filter / Monte-Carlo localization.

The port of rust_robotics_tpu/filters/particle.py. Reference surface
(crates/rust_robotics_localization/):
- particle_filter.rs:26-495 — per-particle noisy unicycle prediction
  (:280-296), range-to-landmark Gaussian likelihood weighting (:310-336,
  gauss_likelihood :480), N_eff-triggered resampling (:337-345, :416-425),
  cumulative-weight resampling (:442-478; the reference draws i.i.d.
  uniforms, i.e. multinomial despite its "systematic" name). Weighted
  mean/covariance estimates (:385-410).
- monte_carlo_localization.rs:29-330 — MCL with KLD-sampling adaptive
  particle counts (:322).

Particles are states [..., P, n] with normalised weights [..., P]; every
function is batched over the leading dims. Randomness comes from a
`torch.Generator` on the particles' device. Resampling is an inverse-CDF
draw (`inverse_cdf`: cumsum + searchsorted), which takes its uniforms as an
argument so that the draw can be fed given numbers. `resample_if_needed_fused`
routes to the fused kernel of `ops/resample.py` (B3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.models.motion import unicycle_propagate


@dataclasses.dataclass(frozen=True)
class ParticleBelief:
    """states [..., P, n]; weights [..., P] (normalised, sum to 1)."""

    states: torch.Tensor
    weights: torch.Tensor

    @property
    def num_particles(self) -> int:
        return self.states.shape[-2]


def _like(x, ref):
    """A float, sequence or tensor as a tensor of ref's dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def init_particles(generator, mean, spread, num_particles, weights_dtype=None):
    """Gaussian cloud around `mean` [..., n] with per-dim std `spread`."""
    n = mean.shape[-1]
    noise = torch.randn(mean.shape[:-1] + (num_particles, n), generator=generator,
                        dtype=mean.dtype, device=mean.device)
    states = mean[..., None, :] + noise * _like(spread, mean)
    w = torch.full(mean.shape[:-1] + (num_particles,), 1.0 / num_particles,
                   dtype=weights_dtype or mean.dtype, device=mean.device)
    return ParticleBelief(states, w)


def pf_predict(belief, control, dt, control_noise_std, generator=None, noise=None):
    """Per-particle prediction with noisy control (particle_filter.rs:280-296):
    each particle draws its own (v, omega) perturbation, then unicycle-steps.
    `control_noise_std` is [2] (std of v and yaw-rate noise). `noise`
    [..., P, 2] standard normals, else drawn from `generator`."""
    states = belief.states
    if noise is None:
        noise = torch.randn(states.shape[:-1] + (2,), generator=generator,
                            dtype=states.dtype, device=states.device)
    u = _like(control, states)[..., None, :] + noise * _like(control_noise_std, states)
    return ParticleBelief(unicycle_propagate(states, u, dt), belief.weights)


def gauss_likelihood(x, sigma):
    """1/sqrt(2π σ²) · exp(−x²/(2σ²)) (particle_filter.rs:480)."""
    sigma = _like(sigma, x)
    coeff = 1.0 / torch.sqrt(2.0 * math.pi * sigma**2)
    return coeff * torch.exp(-(x**2) / (2.0 * sigma**2))


def pf_update_ranges(belief, observed_ranges, landmarks, range_noise, landmark_mask=None):
    """Weight update from range observations to known landmarks
    (particle_filter.rs:310-336): w_i = Π_l N(d_obs_l − d_pred_il; σ).

    observed_ranges [..., L]; landmarks [L, 2]; optional landmark_mask
    [..., L] marks which landmarks are observed this step. Computed in log
    space, then normalised.
    """
    states = belief.states
    d = states[..., :, None, :2] - _like(landmarks, states)  # [..., P, L, 2]
    d_pred = torch.linalg.norm(d, dim=-1)  # [..., P, L]
    diff = observed_ranges[..., None, :] - d_pred
    rn = _like(range_noise, states)
    log_lik = -(diff**2) / (2.0 * rn**2) - 0.5 * torch.log(2.0 * math.pi * rn**2)
    if landmark_mask is not None:
        log_lik = log_lik * landmark_mask[..., None, :]
    # on float32 the 1e-300 floor rounds to 0.0, as jnp.clip's does
    log_w = torch.log(torch.clamp(belief.weights, min=1e-300)) + torch.sum(log_lik, dim=-1)
    log_w = log_w - torch.logsumexp(log_w, dim=-1, keepdim=True)
    return ParticleBelief(states, torch.exp(log_w))


def effective_particles(weights):
    """N_eff = 1 / Σ w² (particle_filter.rs:416-425)."""
    return 1.0 / torch.clamp(torch.sum(weights**2, dim=-1), min=1e-300)


def inverse_cdf(weights, positions):
    """Parent indices [..., M] (int64): for each position in [0, 1), the
    first particle whose cumulative normalised weight reaches it
    (searchsorted, left), clipped to P-1. weights [..., P]; positions
    [..., M] with the same leading dims."""
    p = weights.shape[-1]
    cum = torch.cumsum(weights, dim=-1)
    cum = cum / cum[..., -1:]  # guard against round-off
    return torch.searchsorted(cum, positions.contiguous(), side="left").clamp(0, p - 1)


def systematic_positions(u, p):
    """(i + u) / P for i < P: u [..., 1] -> positions [..., P]."""
    return true_div(torch.arange(p, dtype=u.dtype, device=u.device) + u, p)


def systematic_resample(generator, weights):
    """True systematic (stratified single-uniform) resampling: positions
    (i + u)/P with one u ~ U[0, 1) per row. Returns parent indices [..., P]."""
    u = torch.rand(weights.shape[:-1] + (1,), generator=generator, dtype=weights.dtype,
                   device=weights.device)
    return inverse_cdf(weights, systematic_positions(u, weights.shape[-1]))


def multinomial_resample(generator, weights):
    """The reference's actual scheme (particle_filter.rs:442-478): P i.i.d.
    uniforms through the inverse CDF."""
    u = torch.rand(weights.shape, generator=generator, dtype=weights.dtype,
                   device=weights.device)
    return inverse_cdf(weights, u)


def _gather_particles(states, idx):
    return torch.take_along_dim(states, idx[..., None], dim=-2)


def resample_if_needed(belief, generator, threshold_frac=0.5, method=systematic_resample):
    """Resample when N_eff < threshold_frac · P (particle_filter.rs:337-345).

    Branchless: always draws parent indices, then selects between the
    resampled and the original cloud per batch element.
    """
    p = belief.num_particles
    need = effective_particles(belief.weights) < threshold_frac * p
    resampled = _gather_particles(belief.states, method(generator, belief.weights))
    uniform = torch.full_like(belief.weights, 1.0 / p)
    states = torch.where(need[..., None, None], resampled, belief.states)
    weights = torch.where(need[..., None], uniform, belief.weights)
    return ParticleBelief(states, weights)


def pf_estimate(belief):
    """Weighted mean + covariance (particle_filter.rs:385-410)."""
    mean = torch.einsum("...p,...pn->...n", belief.weights, belief.states)
    d = belief.states - mean[..., None, :]
    cov = torch.einsum("...p,...pn,...pm->...nm", belief.weights, d, d)
    return GaussianBelief(mean, cov)


def pf_step(belief, control, observed_ranges, landmarks, dt, generator, control_noise_std,
            range_noise, resample_threshold=0.5, method=systematic_resample, landmark_mask=None):
    """Full step: predict → weight → maybe-resample → estimate
    (particle_filter.rs try_step :468-478). Returns (belief, GaussianBelief)."""
    belief = pf_predict(belief, control, dt, control_noise_std, generator)
    belief = pf_update_ranges(belief, observed_ranges, landmarks, range_noise, landmark_mask)
    belief = resample_if_needed(belief, generator, resample_threshold, method)
    return belief, pf_estimate(belief)


# ---------------------------------------------------------------------------
# KLD-adaptive MCL (monte_carlo_localization.rs:29-330)
# ---------------------------------------------------------------------------

def kld_required_particles(states, active_mask, grid_res, kld_epsilon=0.05, kld_z=2.326,
                           max_particles=None):
    """KLD-sampling bound on the particle count (:322): with k occupied bins,
    n ≥ (k−1)/(2ε) · (1 − 2/(9(k−1)) + sqrt(2/(9(k−1))) z)³.

    Bins are a hashed (x, y, yaw) grid of fixed resolution; `active_mask`
    selects the live particles (fixed capacity).
    """
    xy = states[..., :2]
    yaw = states[..., 2]
    cells = torch.cat(
        [torch.floor(xy / grid_res[0]), torch.floor(yaw[..., None] / grid_res[1])], dim=-1
    ).to(torch.int64)
    # hash the bins (int64 wraps as in JAX); count distinct live ones by sorting
    h = cells[..., 0] * 73856093 ^ cells[..., 1] * 19349663 ^ cells[..., 2] * 83492791
    big = torch.iinfo(torch.int64).max
    h = torch.where(active_mask, h, big)
    hs = torch.sort(h, dim=-1).values
    distinct = torch.sum((hs[..., 1:] != hs[..., :-1]) & (hs[..., 1:] != big), dim=-1) \
        + torch.any(active_mask, dim=-1).to(torch.int64)
    k = torch.clamp(distinct, min=2).to(states.dtype)
    km1 = k - 1.0
    term = 1.0 - 2.0 / (9.0 * km1) + torch.sqrt(2.0 / (9.0 * km1)) * kld_z
    n = torch.ceil(true_div(km1, 2.0 * kld_epsilon) * term**3).to(torch.int32)
    # k ≤ 1 occupied bin → the caller's min_particles floor applies
    # (monte_carlo_localization.rs:368-370 returns min_particles there)
    n = torch.where(distinct <= 1, torch.ones_like(n), n)
    if max_particles is not None:
        n = torch.clamp(n, 1, max_particles)
    return n


def mcl_step(belief, active_mask, control, observed_ranges, landmarks, dt, generator,
             control_noise_std, range_noise, grid_res=(0.5, 0.2617993877991494),
             kld_epsilon=0.05, kld_z=2.326, min_particles=64):
    """MCL step with a KLD-adaptive active count over a fixed capacity P:
    resampling fills all P slots, and only the first `n_active` carry
    weight. Returns (belief, active_mask, estimate, n_active)."""
    p = belief.num_particles
    belief = pf_predict(belief, control, dt, control_noise_std, generator)
    belief = pf_update_ranges(belief, observed_ranges, landmarks, range_noise)
    # weight only the active slots
    w = torch.where(active_mask, belief.weights, 0.0)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-300)
    belief = ParticleBelief(belief.states, w)

    n_req = kld_required_particles(belief.states, active_mask, grid_res, kld_epsilon, kld_z, p)
    n_active = torch.clamp(n_req, min_particles, p)

    states = _gather_particles(belief.states, systematic_resample(generator, belief.weights))
    slot = torch.arange(p, device=states.device)
    new_mask = slot < n_active[..., None]
    wts = new_mask.to(belief.weights.dtype)
    wts = wts / torch.sum(wts, dim=-1, keepdim=True)
    new_belief = ParticleBelief(states, wts)
    return new_belief, new_mask, pf_estimate(new_belief), n_active


def resample_if_needed_fused(belief, generator, threshold_frac=0.5):
    """`resample_if_needed` on the fused resampling kernel
    (`ops.resample.systematic_resample_gather`, B3): normalisation, N_eff,
    the stratified inverse-CDF draw and the gather in one launch. Matches
    `resample_if_needed(..., method=systematic_resample)` given the same
    uniform, up to an index off by one at a CDF boundary.

    belief.states must be [B, P, n] (one leading batch dim)."""
    from rust_robotics_tpu_torch.ops.resample import systematic_resample_gather

    b, p, _ = belief.states.shape
    u = torch.rand((b,), generator=generator, dtype=belief.weights.dtype,
                   device=belief.weights.device)
    states_dp = belief.states.transpose(-1, -2).contiguous()  # [B, n, P]
    new_dp, _, neff = systematic_resample_gather(belief.weights.contiguous(), u, states_dp)
    need = neff < threshold_frac * p
    states = torch.where(need[:, None, None], new_dp.transpose(-1, -2), belief.states)
    uniform = torch.full_like(belief.weights, 1.0 / p)
    weights = torch.where(need[:, None], uniform, belief.weights)
    return ParticleBelief(states, weights)
