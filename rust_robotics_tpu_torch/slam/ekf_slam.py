"""EKF-SLAM: a joint robot + landmark state with Mahalanobis association.

The port of rust_robotics_tpu/slam/ekf_slam.py. Reference:
slam/src/ekf_slam.rs — state [x, y, yaw, lm1x, lm1y, ...] (:51), the
motion model and its G/Fu Jacobians (:98-140), the range-bearing
innovation (:237), Mahalanobis association picking the least distance
with a new-landmark threshold (:285).

The capacity L is static: mean [..., 3+2L], cov [..., 3+2L, 3+2L], and
`n_lm` [...] is a per-lane integer tensor. Leading dims are independent
filters run in lock-step. Association evaluates every landmark's
innovation at once (an [L]-batched 2×2 solve). Where JAX branches with
`lax.cond` (add a landmark or update, observe or skip), both branches are
computed and each lane selects its own by `torch.where`; the new
landmark's slot 3 + 2·n_lm is written by a one-hot placement, so nothing is
read back inside a step.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small

STATE_SIZE = 3
LM_SIZE = 2
M_DIST_TH = 4.0  # chi-square 95 % for 2 DOF (ekf_slam.rs:19)


@dataclasses.dataclass(frozen=True)
class EKFSLAMBelief:
    mean: torch.Tensor  # [..., 3 + 2L]
    cov: torch.Tensor  # [..., 3 + 2L, 3 + 2L]
    n_lm: torch.Tensor  # [...] int64

    @property
    def capacity(self) -> int:
        return (self.mean.shape[-1] - STATE_SIZE) // LM_SIZE


def init_ekf_slam(capacity: int, dtype=torch.float64, device=None, batch_shape=()):
    """An empty map at the origin, identity covariance, on `device`
    (default cuda); `batch_shape` leading filters."""
    device = resolve_device(device)
    n = STATE_SIZE + LM_SIZE * capacity
    mean = torch.zeros((*batch_shape, n), dtype=dtype, device=device)
    cov = torch.eye(n, dtype=dtype, device=device).expand(*batch_shape, n, n).clone()
    return EKFSLAMBelief(mean, cov, torch.zeros(batch_shape, dtype=torch.int64, device=device))


def motion_model(pose, u, dt):
    """ekf_slam.rs:98-104. pose [..., 3], u [..., 2]."""
    return torch.stack([
        pose[..., 0] + u[..., 0] * dt * torch.cos(pose[..., 2]),
        pose[..., 1] + u[..., 0] * dt * torch.sin(pose[..., 2]),
        normalize_angle(pose[..., 2] + u[..., 1] * dt),
    ], dim=-1)


def _mat(rows):
    """A [..., r, c] matrix from nested lists of [...] tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def ekf_slam_predict(belief: EKFSLAMBelief, u, dt, q_control):
    """Robot-only motion; the landmarks are static (ekf_slam.rs:107-140):
    G = I + dG, and Fu maps the control noise into the pose block."""
    mean = belief.mean
    pose = mean[..., :STATE_SIZE]
    yaw, v = pose[..., 2], u[..., 0]
    new_pose = motion_model(pose, u, dt)
    n = mean.shape[-1]
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    g_r = _mat([[one, zero, -dt * v * torch.sin(yaw)],
                [zero, one, dt * v * torch.cos(yaw)],
                [zero, zero, one]])
    fu = _mat([[dt * torch.cos(yaw), zero],
               [dt * torch.sin(yaw), zero],
               [zero, dt + zero]])
    lead = g_r.shape[:-2]
    g = torch.eye(n, dtype=mean.dtype, device=mean.device).expand(*lead, n, n).clone()
    g[..., :3, :3] = g_r
    q_big = torch.zeros((*lead, n, n), dtype=mean.dtype, device=mean.device)
    q_big[..., :3, :3] = fu @ q_control @ fu.mT
    cov = g @ belief.cov @ g.mT + q_big
    mean = torch.cat([new_pose, mean[..., STATE_SIZE:].expand(*lead, n - STATE_SIZE)], dim=-1)
    return EKFSLAMBelief(mean, cov, belief.n_lm)


def _landmark_innovations(belief, z):
    """Innovation (y, S, H) of the observation z = [range, bearing] [..., 2]
    against every slot at once: y [..., L, 2], s [..., L, 2, 2], h
    [..., L, 2, n]."""
    mean, cov = belief.mean, belief.cov
    cap = belief.capacity
    pose = mean[..., :3]
    lms = mean[..., 3:].reshape(*mean.shape[:-1], cap, 2)
    d = lms - pose[..., None, :2]  # [..., L, 2]
    q = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
    sq = torch.sqrt(q)
    dx, dy = d[..., 0], d[..., 1]
    z_pred = torch.stack([sq, normalize_angle(torch.atan2(dy, dx) - pose[..., 2, None])], dim=-1)
    y = torch.stack([z[..., 0, None] - z_pred[..., 0],
                     normalize_angle(z[..., 1, None] - z_pred[..., 1])], dim=-1)
    zero, one = torch.zeros_like(sq), torch.ones_like(q)
    h_pose = _mat([[-dx / sq, -dy / sq, zero], [dy / q, -dx / q, -one]])  # [..., L, 2, 3]
    h_lm = _mat([[dx / sq, dy / sq], [-dy / q, dx / q]])  # [..., L, 2, 2]
    # slot l's block at columns 3 + 2l, 3 + 2l + 1: a one-hot placement
    eye_l = torch.eye(cap, dtype=mean.dtype, device=mean.device)
    h_lms = (h_lm[..., :, :, None, :] * eye_l[:, None, :, None]).flatten(-2)  # [..., L, 2, 2L]
    h = torch.cat([h_pose, h_lms], dim=-1)
    s = h @ cov[..., None, :, :] @ h.mT
    return y, s, h


def _slot_placement(n_lm, n, like):
    """One-hot E [..., n, 2] with E[3 + 2·n_lm + a, a] = 1."""
    idx = STATE_SIZE + LM_SIZE * n_lm
    rows = torch.arange(n, device=like.device)
    cols = torch.arange(LM_SIZE, device=like.device)
    return (rows[:, None] == idx[..., None, None] + cols).to(like.dtype)


def _add_landmark(belief, z, r_obs):
    """Initialise slot n_lm from (range, bearing) with the Jacobian
    covariance P_lm = G_r P_rr G_rᵀ + G_z R G_zᵀ and the cross-covariance
    G_r P_r,: (ekf_slam.rs:308-360)."""
    mean, cov = belief.mean, belief.cov
    n = mean.shape[-1]
    pose = mean[..., :3]
    rng, bearing = z[..., 0], z[..., 1]
    c = torch.cos(pose[..., 2] + bearing)
    s = torch.sin(pose[..., 2] + bearing)
    lm = torch.stack([pose[..., 0] + rng * c, pose[..., 1] + rng * s], dim=-1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    g_r = _mat([[one, zero, -rng * s], [zero, one, rng * c]])
    g_z = _mat([[c, -rng * s], [s, rng * c]])
    p_lm = g_r @ cov[..., :3, :3] @ g_r.mT + g_z @ r_obs @ g_z.mT
    cross = g_r @ cov[..., :3, :]  # [..., 2, n]
    e = _slot_placement(belief.n_lm, n, mean)
    in_slot = e.sum(-1) > 0  # [..., n]
    mean = torch.where(in_slot, (e @ lm[..., None])[..., 0], mean)
    # rows, then columns, then the diagonal block, as the three
    # dynamic_update_slice calls write them
    cov = torch.where(in_slot[..., :, None], e @ cross, cov)
    cov = torch.where(in_slot[..., None, :], cross.mT @ e.mT, cov)
    block = in_slot[..., :, None] & in_slot[..., None, :]
    cov = torch.where(block, e @ p_lm @ e.mT, cov)
    return EKFSLAMBelief(mean, cov, belief.n_lm + 1)


def _take_slot(x, best):
    """x[..., best, ...]: x [..., L, *rest], best [...] int."""
    idx = best.reshape(*best.shape, *([1] * (x.ndim - best.ndim)))
    return torch.take_along_dim(x, idx, dim=best.ndim).squeeze(best.ndim)


def ekf_slam_update_one(belief: EKFSLAMBelief, z, r_obs):
    """Fold one [range, bearing] observation [..., 2] with Mahalanobis
    association (ekf_slam.rs:285): the least distance over the active
    landmarks (the first, on a tie, as `jnp.argmin`); a distance above
    M_DIST_TH (or no active landmark) makes a new landmark while capacity
    remains."""
    cap = belief.capacity
    y, s, h = _landmark_innovations(belief, z)
    s = s + r_obs
    s_inv = inv_spd_small(s)
    mdist = torch.sum(y * (s_inv @ y[..., None])[..., 0], dim=-1)  # [..., L]
    active = torch.arange(cap, device=mdist.device) < belief.n_lm[..., None]
    mdist = torch.where(active, mdist, torch.inf)
    best = torch.argmin(mdist, dim=-1)
    best_dist = torch.take_along_dim(mdist, best[..., None], dim=-1)[..., 0]
    is_new = ~torch.any(active, dim=-1) | (best_dist > M_DIST_TH**2)
    can_add = belief.n_lm < cap

    added = _add_landmark(belief, z, r_obs)

    hb = _take_slot(h, best)  # [..., 2, n]
    k = belief.cov @ hb.mT @ _take_slot(s_inv, best)
    mean = belief.mean + (k @ _take_slot(y, best)[..., None])[..., 0]
    mean = torch.cat([mean[..., :2], normalize_angle(mean[..., 2:3]), mean[..., 3:]], dim=-1)
    n = mean.shape[-1]
    cov = (torch.eye(n, dtype=mean.dtype, device=mean.device) - k @ hb) @ belief.cov

    add = is_new & can_add
    return EKFSLAMBelief(torch.where(add[..., None], added.mean, mean),
                         torch.where(add[..., None, None], added.cov, cov),
                         torch.where(add, added.n_lm, belief.n_lm))


def _select(mask, new: EKFSLAMBelief, old: EKFSLAMBelief):
    return EKFSLAMBelief(torch.where(mask[..., None], new.mean, old.mean),
                         torch.where(mask[..., None, None], new.cov, old.cov),
                         torch.where(mask, new.n_lm, old.n_lm))


def ekf_slam_step(belief: EKFSLAMBelief, u, observations, obs_mask, dt, q_control, r_obs):
    """A full step: predict, then fold the O observations in order
    (ekf_slam.rs:418). observations [..., O, 2], obs_mask [..., O]."""
    belief = ekf_slam_predict(belief, u, dt, q_control)
    for o in range(observations.shape[-2]):
        updated = ekf_slam_update_one(belief, observations[..., o, :], r_obs)
        belief = _select(obs_mask[..., o], updated, belief)
    return belief
