"""FastSLAM 1.0 / 2.0: particles with per-landmark 2×2 EKFs.

The port of rust_robotics_tpu/slam/fastslam.py. Reference:
slam/src/fastslam1.rs — particles carry a pose and per-landmark means and
covariances (:27-66), noisy motion sampling (:123-137), the landmark EKF
update (:140-184), weights ∝ the innovation's Gaussian, N_eff resampling at
N/1.5 (:18, :186-236), `fastslam_update` (:237), the best particle
(:269), known correspondences (observations carry lm_id, :277-300);
fastslam2.rs folds the current observations into the proposal.

The filter is a struct of tensors — poses [..., P, 3], weights [..., P],
landmark means [..., P, L, 2], covariances [..., P, L, 2, 2], seen
[..., P, L] — and every update is batched over the particles; leading dims
are independent filters. `lm_id` may differ per filter: the landmark's
slot is read by a gather and written by a one-hot select, and an
observation that a mask switches off leaves its lane as it was, so nothing
is read back inside a step.

Randomness comes from a `torch.Generator`, or the draws are given: the
motion noise ([..., P, 2] normals for FastSLAM 1.0, [..., P, 3] for the
2.0 proposal) and the resampling uniform ([..., 1]). Resampling goes
through `filters/particle.py`'s inverse CDF, then a gather of every
per-particle field, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.filters.particle import inverse_cdf, systematic_positions
from rust_robotics_tpu_torch.ops.smallmat import det_small, inv_spd_small

RESAMPLE_FRACTION = 1.0 / 1.5  # NTH = N/1.5 (fastslam1.rs:18)


@dataclasses.dataclass(frozen=True)
class FastSLAMParticles:
    poses: torch.Tensor  # [..., P, 3]
    weights: torch.Tensor  # [..., P]
    lm_mean: torch.Tensor  # [..., P, L, 2]
    lm_cov: torch.Tensor  # [..., P, L, 2, 2]
    lm_seen: torch.Tensor  # [..., P, L] bool

    @property
    def num_particles(self) -> int:
        return self.poses.shape[-2]


def init_fastslam(num_particles: int, num_landmarks: int, dtype=torch.float64, device=None):
    """P particles at the origin with L unseen landmarks, on `device`
    (default cuda)."""
    device = resolve_device(device)
    p, l = num_particles, num_landmarks
    kw = dict(dtype=dtype, device=device)
    return FastSLAMParticles(
        poses=torch.zeros((p, 3), **kw),
        weights=torch.full((p,), 1.0 / p, **kw),
        lm_mean=torch.zeros((p, l, 2), **kw),
        lm_cov=torch.eye(2, **kw).expand(p, l, 2, 2).clone(),
        lm_seen=torch.zeros((p, l), dtype=torch.bool, device=device),
    )


def _normals(generator, shape, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _unicycle(poses, v, w, dt):
    x, y, yaw = poses[..., 0], poses[..., 1], poses[..., 2]
    return torch.stack([x + v * dt * torch.cos(yaw), y + v * dt * torch.sin(yaw),
                        normalize_angle(yaw + w * dt)], dim=-1)


def predict_particles(particles, u, dt, control_noise_chol, generator=None, noise=None):
    """Noisy motion sampling per particle (fastslam1.rs:123-137). `noise`
    [..., P, 2] standard normals, else drawn from `generator`."""
    poses = particles.poses
    if noise is None:
        noise = _normals(generator, poses.shape[:-1] + (2,), poses)
    un = u[..., None, :] + noise @ control_noise_chol.mT
    return dataclasses.replace(particles, poses=_unicycle(poses, un[..., 0], un[..., 1], dt))


def _observe_jacobian(poses, lm):
    """z_pred [..., P, 2] and H (w.r.t. the landmark) [..., P, 2, 2] for
    poses [..., P, 3] and landmarks lm [..., P, 2] (fastslam1.rs:92-111)."""
    d = lm - poses[..., :2]
    q = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
    sq = torch.sqrt(q)
    dx, dy = d[..., 0], d[..., 1]
    z_pred = torch.stack([sq, normalize_angle(torch.atan2(dy, dx) - poses[..., 2])], dim=-1)
    h = torch.stack([torch.stack([dx / sq, dy / sq], dim=-1),
                     torch.stack([-dy / q, dx / q], dim=-1)], dim=-2)
    return z_pred, h


def _lm_index(lm_id, particles):
    """lm_id (an int or a [...] tensor) as an int64 tensor [..., 1, 1]."""
    lm_id = torch.as_tensor(lm_id, device=particles.poses.device).to(torch.int64)
    return lm_id[..., None, None]


def _take_lm(x, idx):
    """x[..., p, lm_id, ...] for every particle: x [..., P, L, *rest]."""
    rest = x.ndim - idx.ndim
    return torch.take_along_dim(x, idx.reshape(*idx.shape, *([1] * rest)),
                                dim=idx.ndim - 1).squeeze(idx.ndim - 1)


def _innovation(z, z_pred):
    return torch.stack([z[..., None, 0] - z_pred[..., 0],
                        normalize_angle(z[..., None, 1] - z_pred[..., 1])], dim=-1)


def update_with_observation(particles, z, lm_id, r_obs):
    """Fold one known-correspondence observation z = [range, bearing]
    [..., 2] of landmark lm_id (fastslam1.rs:140-184): an unseen landmark is
    initialised; a seen one takes a 2×2 EKF update and multiplies the
    weight by the innovation's likelihood."""
    poses = particles.poses
    idx = _lm_index(lm_id, particles)  # [..., 1, 1]
    seen = _take_lm(particles.lm_seen, idx)  # [..., P]

    # the initialisation branch, computed for all, selected by mask
    ang = poses[..., 2] + z[..., None, 1]
    init_mean = torch.stack([poses[..., 0] + z[..., None, 0] * torch.cos(ang),
                             poses[..., 1] + z[..., None, 0] * torch.sin(ang)], dim=-1)
    _, h0 = _observe_jacobian(poses, init_mean)
    h0_inv = inv_spd_small(h0)  # the 2×2 adjugate inverse: general
    init_cov = h0_inv @ r_obs @ h0_inv.mT

    # the update branch
    lm = _take_lm(particles.lm_mean, idx)
    z_pred, h = _observe_jacobian(poses, lm)
    y = _innovation(z, z_pred)
    cov = _take_lm(particles.lm_cov, idx)
    s = h @ cov @ h.mT + r_obs
    s_inv = inv_spd_small(s)
    k = cov @ h.mT @ s_inv
    upd_mean = lm + (k @ y[..., None])[..., 0]
    upd_cov = (torch.eye(2, dtype=cov.dtype, device=cov.device) - k @ h) @ cov
    md = torch.sum(y * (s_inv @ y[..., None])[..., 0], dim=-1)
    norm = 2.0 * math.pi * torch.sqrt(torch.clamp(det_small(s), min=1e-30))
    lik = torch.exp(-0.5 * md) / norm

    new_mean = torch.where(seen[..., None], upd_mean, init_mean)
    new_cov = torch.where(seen[..., None, None], upd_cov, init_cov)
    weights = torch.where(seen, particles.weights * lik, particles.weights)

    num_lm = particles.lm_seen.shape[-1]
    slot = torch.arange(num_lm, device=poses.device) == idx  # [..., 1, L]
    return FastSLAMParticles(
        poses,
        weights,
        torch.where(slot[..., None], new_mean[..., None, :], particles.lm_mean),
        torch.where(slot[..., None, None], new_cov[..., None, :, :], particles.lm_cov),
        particles.lm_seen | slot,
    )


def _gather_particles(x, idx):
    """x[..., idx, ...] over the particle axis: x [..., P, *rest], idx
    [..., P]."""
    rest = x.ndim - idx.ndim
    return torch.take_along_dim(x, idx.reshape(*idx.shape, *([1] * rest)), dim=idx.ndim - 1)


def normalize_and_resample(particles, generator=None, uniform=None):
    """Normalise the weights; resample systematically when N_eff < N/1.5
    (fastslam1.rs:186-236). `uniform` [..., 1] in [0, 1), else drawn from
    `generator`."""
    p = particles.num_particles
    w = particles.weights
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-300)
    neff = 1.0 / torch.clamp(torch.sum(w * w, dim=-1), min=1e-300)
    need = neff < p * RESAMPLE_FRACTION
    if uniform is None:
        uniform = torch.rand(w.shape[:-1] + (1,), generator=generator, dtype=w.dtype,
                             device=w.device)
    idx = inverse_cdf(w, systematic_positions(uniform, p))

    def pick(a):
        sel = need.reshape(*need.shape, *([1] * (a.ndim - need.ndim)))
        return torch.where(sel, _gather_particles(a, idx), a)

    return FastSLAMParticles(
        pick(particles.poses),
        torch.where(need[..., None], torch.full_like(w, 1.0 / p), w),
        pick(particles.lm_mean),
        pick(particles.lm_cov),
        pick(particles.lm_seen),
    )


def _fold_observations(particles, observations, obs_mask, r_obs):
    """Fold O observations [..., O, 3] = (range, bearing, lm_id) in order;
    a masked one leaves its filter as it was."""
    for o in range(observations.shape[-2]):
        z3 = observations[..., o, :]
        updated = update_with_observation(particles, z3[..., :2], z3[..., 2].to(torch.int64),
                                          r_obs)
        m = obs_mask[..., o]
        particles = FastSLAMParticles(**{
            f.name: torch.where(m.reshape(*m.shape, *([1] * (new.ndim - m.ndim))), new, old)
            for f in dataclasses.fields(FastSLAMParticles)
            for new, old in [(getattr(updated, f.name), getattr(particles, f.name))]})
    return particles


def fastslam1_step(particles, u, observations, obs_mask, dt, control_noise_chol, r_obs,
                   generator=None, draws=None):
    """A full FastSLAM 1.0 step (fastslam_update, fastslam1.rs:237):
    observations [..., O, 3] rows (range, bearing, lm_id); obs_mask
    [..., O]. `draws` = (noise [..., P, 2], uniform [..., 1]), else drawn
    from `generator`."""
    noise, uniform = (None, None) if draws is None else draws
    particles = predict_particles(particles, u, dt, control_noise_chol, generator, noise)
    particles = _fold_observations(particles, observations, obs_mask, r_obs)
    return normalize_and_resample(particles, generator, uniform)


def estimate(particles):
    """The weighted pose estimate [..., 3] and the best particle [...]
    (the first of the largest weights, fastslam1.rs:269)."""
    w = particles.weights
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-300)
    poses = particles.poses
    mean_xy = torch.einsum("...p,...pi->...i", w, poses[..., :2])
    yaw = torch.atan2(torch.sum(w * torch.sin(poses[..., 2]), dim=-1),
                      torch.sum(w * torch.cos(poses[..., 2]), dim=-1))
    best = torch.argmax(particles.weights, dim=-1)
    return torch.cat([mean_xy, yaw[..., None]], dim=-1), best


# ---------------------------------------------------------------------------
# FastSLAM 2.0 (fastslam2.rs)
# ---------------------------------------------------------------------------

def _observe_pose_jacobian(poses, lm):
    """H w.r.t. the pose [..., P, 2, 3] of the range-bearing to landmark lm
    [..., P, 2]."""
    d = lm - poses[..., :2]
    q = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
    sq = torch.sqrt(q)
    dx, dy = d[..., 0], d[..., 1]
    zero = torch.zeros_like(sq)
    return torch.stack([torch.stack([-dx / sq, -dy / sq, zero], dim=-1),
                        torch.stack([dy / q, -dx / q, zero - 1.0], dim=-1)], dim=-2)


def fastslam2_step(particles, u, observations, obs_mask, dt, control_noise_chol, r_obs,
                   generator=None, draws=None):
    """A full FastSLAM 2.0 step (fastslam2.rs): the pose proposal
    conditions on every current observation of an already seen landmark —
    the information form (Λ, η) accumulates over the observations at the
    motion prior's mean, the pose is sampled once from N(μ_prior + Ση, Σ),
    then the landmark EKFs and weights run as in 1.0. `draws` = (noise
    [..., P, 3], uniform [..., 1]), else drawn from `generator`."""
    noise, uniform = (None, None) if draws is None else draws
    poses = particles.poses
    dtype, device = poses.dtype, poses.device
    # the motion prior's mean (the noise enters through the proposal covariance)
    prior_mean = _unicycle(poses, u[..., None, 0], u[..., None, 1], dt)
    pose_cov = control_noise_chol @ control_noise_chol.mT
    prior_var = torch.stack([pose_cov[..., 0, 0] * dt * dt + 1e-6,
                             pose_cov[..., 0, 0] * dt * dt + 1e-6,
                             pose_cov[..., 1, 1] * dt * dt + 1e-6], dim=-1).to(dtype)
    prior_inv = torch.linalg.inv_ex(torch.diag_embed(prior_var)).inverse[..., None, :, :]

    lam = torch.zeros((*poses.shape[:-1], 3, 3), dtype=dtype, device=device)
    eta = torch.zeros(poses.shape, dtype=dtype, device=device)
    for o in range(observations.shape[-2]):
        z3 = observations[..., o, :]
        idx = _lm_index(z3[..., 2].to(torch.int64), particles)
        seen = _take_lm(particles.lm_seen, idx)
        lm = _take_lm(particles.lm_mean, idx)
        lm_cov = _take_lm(particles.lm_cov, idx)
        z_pred, h_lm = _observe_jacobian(prior_mean, lm)
        h_pose = _observe_pose_jacobian(prior_mean, lm)
        yv = _innovation(z3, z_pred)
        s_inv = inv_spd_small(h_lm @ lm_cov @ h_lm.mT + r_obs)
        use = obs_mask[..., o, None] & seen  # [..., P]
        lam = lam + torch.where(use[..., None, None], h_pose.mT @ s_inv @ h_pose, 0.0)
        eta = eta + torch.where(use[..., None], (h_pose.mT @ s_inv @ yv[..., None])[..., 0], 0.0)

    # the _ex forms check nothing: no device read inside the step
    sigma = torch.linalg.inv_ex(lam + prior_inv).inverse
    mu = prior_mean + (sigma @ eta[..., None])[..., 0]
    chol = torch.linalg.cholesky_ex(0.5 * (sigma + sigma.mT)
                                    + 1e-12 * torch.eye(3, dtype=dtype, device=device)).L
    if noise is None:
        noise = _normals(generator, poses.shape, poses)
    sampled = mu + (chol @ noise[..., None])[..., 0]
    sampled = torch.cat([sampled[..., :2], normalize_angle(sampled[..., 2:])], dim=-1)
    particles = dataclasses.replace(particles, poses=sampled)
    particles = _fold_observations(particles, observations, obs_mask, r_obs)
    return normalize_and_resample(particles, generator, uniform)
