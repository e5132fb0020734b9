"""Data-parallel particle workloads over the mesh.

The port of rust_robotics_tpu/parallel/sharded_filters.py, in two shapes
(SURVEY.md §2.12's DP row; BASELINE.json's per-particle landmark EKFs
sharded over the mesh):

1. `make_pf_banks_step`: B independent particle-filter banks split over
   the `data` axis. No collective.
2. `make_fastslam_sharded_step`: one FastSLAM filter whose particle axis
   is split over the mesh. Prediction and the per-landmark 2×2 EKF updates
   are local; the resample all-gathers the weights and the particle fields.

The draws replace JAX's keys. Each step takes `draws=` with the global
arrays (every bank's or every particle's, not the rank's) and takes its
own slice; without them every rank draws the global arrays from its own
`torch.Generator`, seeded alike on every rank, and slices them. Either way
what a bank or a particle draws does not depend on the layout, which is
what JAX's per-bank keys and per-slot `fold_in` give.

The FastSLAM step reduces its weights over the gathered weight vector,
not as a psum of per-rank partial sums: the normaliser, N_eff and the CDF
are then the one-process step's own sums, and the sharded step equals
`fastslam_oracle_step` bitwise on any layout. It is the one collective
the step needs either way, since the global resample reads every weight.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.filters.particle import (
    ParticleBelief,
    effective_particles,
    inverse_cdf,
    pf_estimate,
    pf_predict,
    pf_update_ranges,
    systematic_positions,
)
from rust_robotics_tpu_torch.parallel.mesh import all_gather, axis_index, axis_size
from rust_robotics_tpu_torch.slam.fastslam import (
    RESAMPLE_FRACTION,
    FastSLAMParticles,
    _fold_observations,
    normalize_and_resample,
    predict_particles,
)


# ---------------------------------------------------------------------------
# 1. Independent PF banks over the data axis
# ---------------------------------------------------------------------------

def pf_bank_draws(generator, shape, like):
    """The draws of one step of banks of particles `shape` = (..., P):
    (prediction noise [..., P, 2] standard normals, resample uniforms
    [..., 1])."""
    kw = dict(generator=generator, dtype=like.dtype, device=like.device)
    return torch.randn((*shape, 2), **kw), torch.rand((*shape[:-1], 1), **kw)


def pf_bank_step(belief, control, observed_ranges, landmarks, dt, control_noise_std, range_noise,
                 resample_threshold=0.5, generator=None, draws=None):
    """Predict → weight → maybe-resample → estimate for banks over the
    leading dims (particle_filter.rs try_step :468-478): belief [..., P, n]
    / [..., P], control [..., 2], observed_ranges [..., L]. `draws` =
    (noise [..., P, 2], uniform [..., 1]), else drawn from `generator`.
    The resample is the plain systematic inverse CDF and a gather, as in
    the JAX package. Returns (belief, estimate)."""
    if draws is None:
        draws = pf_bank_draws(generator, belief.states.shape[:-1], belief.states)
    noise, uniform = draws
    belief = pf_predict(belief, control, dt, control_noise_std, noise=noise)
    belief = pf_update_ranges(belief, observed_ranges, landmarks, range_noise)
    p = belief.num_particles
    need = effective_particles(belief.weights) < resample_threshold * p
    idx = inverse_cdf(belief.weights, systematic_positions(uniform, p))
    resampled = torch.take_along_dim(belief.states, idx[..., None], dim=-2)
    states = torch.where(need[..., None, None], resampled, belief.states)
    weights = torch.where(need[..., None], torch.full_like(belief.weights, 1.0 / p),
                          belief.weights)
    belief = ParticleBelief(states, weights)
    return belief, pf_estimate(belief)


def make_pf_banks_step(mesh, dt, control_noise_std, range_noise, resample_threshold=0.5,
                       axis_name="data"):
    """step(belief, controls, ranges, landmarks, generator=None,
    draws=None) on this rank's banks: belief [B_local, P, n] / [B_local, P],
    controls [B_local, 2], ranges [B_local, L], landmarks [L, 2]
    replicated; `draws` holds every bank's, [B, P, 2] and [B, 1]. Returns
    this rank's (belief, estimate), equal bitwise to `pf_bank_step` on the
    whole batch, because each bank uses only its own draws."""
    s = axis_size(mesh, axis_name)

    def step(belief, controls, ranges, landmarks, generator=None, draws=None):
        b_local, p = belief.states.shape[:2]
        if draws is None:
            draws = pf_bank_draws(generator, (b_local * s, p), belief.states)
        lo = axis_index(mesh, axis_name) * b_local
        local = tuple(d[lo:lo + b_local] for d in draws)
        return pf_bank_step(belief, controls, ranges, landmarks, dt, control_noise_std,
                            range_noise, resample_threshold, draws=local)

    return step


# ---------------------------------------------------------------------------
# 2. One FastSLAM filter, particle axis sharded
# ---------------------------------------------------------------------------

def fastslam_draws(generator, particles, like):
    """The draws of one FastSLAM step of `particles` particles: (motion
    noise [P, 2] standard normals, the resample uniform [1])."""
    kw = dict(generator=generator, dtype=like.dtype, device=like.device)
    return torch.randn((particles, 2), **kw), torch.rand((1,), **kw)


def make_fastslam_sharded_step(mesh, dt, control_noise_chol, r_obs, axis_name="data"):
    """step(particles, u, observations, obs_mask, generator=None,
    draws=None): one FastSLAM 1.0 step of this rank's particles
    (FastSLAMParticles with P_local leading), u [2], observations [O, 3],
    obs_mask [O] replicated; `draws` = (noise [P, 2] for every particle,
    uniform [1]). Collectives: an all-gather of the weights (normaliser,
    N_eff and the global CDF) and of each particle field for the parents.
    Returns this rank's particles, equal bitwise to `fastslam_oracle_step`
    on the whole filter."""
    s = axis_size(mesh, axis_name)

    def step(particles, u, observations, obs_mask, generator=None, draws=None):
        p_local = particles.num_particles
        p_total = p_local * s
        if draws is None:
            draws = fastslam_draws(generator, p_total, particles.poses)
        noise, uniform = draws
        lo = axis_index(mesh, axis_name) * p_local
        particles = predict_particles(particles, u, dt, control_noise_chol,
                                      noise=noise[lo:lo + p_local])
        particles = _fold_observations(particles, observations, obs_mask, r_obs)

        w_all = all_gather(particles.weights, mesh, axis_name).reshape(p_total)
        w_all = w_all / torch.clamp(torch.sum(w_all, dim=-1, keepdim=True), min=1e-300)
        neff = 1.0 / torch.clamp(torch.sum(w_all * w_all, dim=-1), min=1e-300)
        need = neff < p_total * RESAMPLE_FRACTION
        positions = systematic_positions(uniform, p_total)[lo:lo + p_local]
        idx = inverse_cdf(w_all, positions)

        def pick(a):
            parents = all_gather(a, mesh, axis_name).reshape(p_total, *a.shape[1:])[idx]
            return torch.where(need, parents, a)

        w = w_all[lo:lo + p_local]
        return FastSLAMParticles(
            pick(particles.poses), torch.where(need, torch.full_like(w, 1.0 / p_total), w),
            pick(particles.lm_mean), pick(particles.lm_cov), pick(particles.lm_seen))

    return step


def fastslam_oracle_step(particles, u, observations, obs_mask, dt, control_noise_chol, r_obs,
                         generator=None, draws=None):
    """The one-process step `make_fastslam_sharded_step` equals: FastSLAM
    1.0 (slam/fastslam.py) on the whole filter with the same draws,
    (noise [P, 2], uniform [1]), else drawn from `generator` as the
    sharded step draws them."""
    if draws is None:
        draws = fastslam_draws(generator, particles.num_particles, particles.poses)
    noise, uniform = draws
    particles = predict_particles(particles, u, dt, control_noise_chol, noise=noise)
    particles = _fold_observations(particles, observations, obs_mask, r_obs)
    return normalize_and_resample(particles, uniform=uniform)

