"""Batched Kalman-filter family over a shared Gaussian belief.

Reference surface (crates/rust_robotics_localization/):
- EKF predict/update: ekf.rs:248-278 (predict FPFᵀ+Q; update via S⁻¹, gain
  K, covariance (I-KH)P).
- Iterated EKF: iterated_ekf.rs (re-linearize the update to convergence).
- UKF: unscented_kalman_filter.rs:172-190 (λ = α²(n+κ)−n weights; Cholesky
  sigma points :322-341; predict/update :443-541). Defaults α=0.001, β=2,
  κ=0 (:44-50).
- CKF: cubature_kalman_filter.rs:33-368 (3rd-degree spherical-radial rule,
  2n equally-weighted cubature points, no tuning parameters).
- Information filter: information_filter.rs (inverse-covariance dual with
  additive multi-sensor updates).
- Ensemble KF: ensemble_kalman_filter.rs (stochastic ensemble statistics).

Every filter is a function over `GaussianBelief`s whose tensors carry any
leading batch dims: one call steps B independent filters. Linear algebra
works on the trailing (n×n) dims; gains use the closed-form SPD solve of
`ops/smallmat.py` on the innovation covariance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.models.motion import unicycle_jacobian, unicycle_propagate
from rust_robotics_tpu_torch.models.observation import position_jacobian, position_observe
from rust_robotics_tpu_torch.ops.smallmat import (
    cholesky_small,
    inv_spd_small,
    solve_spd_small,
)


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    """Bundle of model callables.

    propagate(state, control, dt) -> state'         [..., n]
    propagate_jacobian(state, control, dt) -> F     [..., n, n]
    observe(state) -> z_pred                        [..., k]
    observe_jacobian(state) -> H                    [..., k, n]

    `propagate_jacobian`/`observe_jacobian` may be None, in which case
    autodiff Jacobians (`torch.func.jacrev` over a flattened batch) are
    derived from the nonlinear maps.
    """

    propagate: Callable[..., Any]
    observe: Callable[..., Any]
    propagate_jacobian: Callable[..., Any] | None = None
    observe_jacobian: Callable[..., Any] | None = None

    def motion_jac(self, state, control, dt):
        if self.propagate_jacobian is not None:
            return self.propagate_jacobian(state, control, dt)
        flat = state.reshape((-1, state.shape[-1]))
        uflat = torch.broadcast_to(control, state.shape[:-1] + control.shape[-1:])
        uflat = uflat.reshape((-1, control.shape[-1]))
        jac = torch.func.vmap(
            torch.func.jacrev(lambda s, u: self.propagate(s, u, dt))
        )(flat, uflat)
        return jac.reshape(state.shape + state.shape[-1:])

    def obs_jac(self, state):
        if self.observe_jacobian is not None:
            return self.observe_jacobian(state)
        flat = state.reshape((-1, state.shape[-1]))
        jac = torch.func.vmap(torch.func.jacrev(self.observe))(flat)
        return jac.reshape(state.shape[:-1] + jac.shape[-2:])


def unicycle_position_model() -> StateSpaceModel:
    """The reference's shared demo problem (ekf.rs:17-24, :203-245)."""
    return StateSpaceModel(
        propagate=unicycle_propagate,
        observe=position_observe,
        propagate_jacobian=unicycle_jacobian,
        observe_jacobian=position_jacobian,
    )


def _sym_solve(s, b):
    """Solve s @ x = b for SPD s on trailing dims (batched, closed form for
    n <= 4)."""
    return solve_spd_small(s, b)


def _eye_like(cov):
    return torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)


# ---------------------------------------------------------------------------
# EKF (ekf.rs:248-278)
# ---------------------------------------------------------------------------

def ekf_predict(belief: GaussianBelief, control, dt, q, model: StateSpaceModel):
    """Predict: x⁺ = f(x, u); P⁺ = F P Fᵀ + Q (Jacobian at the predicted
    state, matching ekf.rs:318-321)."""
    x_pred = model.propagate(belief.mean, control, dt)
    f = model.motion_jac(x_pred, control, dt)
    p_pred = f @ belief.cov @ f.mT + q
    return GaussianBelief(x_pred, p_pred)


def ekf_update(belief: GaussianBelief, measurement, r, model: StateSpaceModel):
    """Update: y = z − h(x); S = H P Hᵀ + R; K = P Hᵀ S⁻¹;
    x ← x + K y; P ← (I − K H) P. (ekf.rs:255-276)."""
    h = model.obs_jac(belief.mean)
    z_pred = model.observe(belief.mean)
    y = measurement - z_pred
    pht = belief.cov @ h.mT
    s = h @ pht + r
    k = _sym_solve(s, pht.mT).mT
    mean = belief.mean + (k @ y[..., None])[..., 0]
    cov = (_eye_like(belief.cov) - k @ h) @ belief.cov
    return GaussianBelief(mean, cov)


def ekf_step(belief, measurement, control, dt, q, r, model=None):
    """Full estimate step (predict + update), the reference `estimate()`
    (ekf.rs:248). Batched over leading dims of every argument."""
    model = model or unicycle_position_model()
    pred = ekf_predict(belief, control, dt, q, model)
    return ekf_update(pred, measurement, r, model)


def ekf_step_with_innovation(belief, measurement, control, dt, q, r, model=None):
    """EKF step that also returns the innovation y and its covariance S,
    the sufficient statistics for the innovation likelihood."""
    model = model or unicycle_position_model()
    pred = ekf_predict(belief, control, dt, q, model)
    h = model.obs_jac(pred.mean)
    y = measurement - model.observe(pred.mean)
    pht = pred.cov @ h.mT
    s = h @ pht + r
    k = _sym_solve(s, pht.mT).mT
    mean = pred.mean + (k @ y[..., None])[..., 0]
    cov = (_eye_like(pred.cov) - k @ h) @ pred.cov
    return GaussianBelief(mean, cov), y, s


# ---------------------------------------------------------------------------
# Iterated EKF (iterated_ekf.rs)
# ---------------------------------------------------------------------------

def iekf_step(belief, measurement, control, dt, q, r, model=None, iterations: int = 5):
    """EKF with an iterated (Gauss-Newton) measurement update: re-linearize
    h around the running iterate (iterated_ekf.rs). A fixed iteration count;
    the reference's convergence tolerance becomes an upper bound."""
    model = model or unicycle_position_model()
    pred = ekf_predict(belief, control, dt, q, model)
    x0, p = pred.mean, pred.cov

    x = x0
    for _ in range(iterations):
        h = model.obs_jac(x)
        z_pred = model.observe(x)
        y = measurement - z_pred - (h @ (x0 - x)[..., None])[..., 0]
        pht = p @ h.mT
        s = h @ pht + r
        k = _sym_solve(s, pht.mT).mT
        x = x0 + (k @ y[..., None])[..., 0]

    h = model.obs_jac(x)
    pht = p @ h.mT
    s = h @ pht + r
    k = _sym_solve(s, pht.mT).mT
    cov = (_eye_like(p) - k @ h) @ p
    return GaussianBelief(x, cov)


# ---------------------------------------------------------------------------
# UKF (unscented_kalman_filter.rs)
# ---------------------------------------------------------------------------

def ukf_weights(n: int, alpha=1e-3, beta=2.0, kappa=0.0, dtype=torch.float32,
                device=None):
    """Sigma weights (unscented_kalman_filter.rs:172-190), on `device`
    (default `cuda`)."""
    device = resolve_device(device)
    lam = alpha**2 * (n + kappa) - n
    scale = n + lam
    # fills, not copies from the host (a Python number assigned into a CUDA
    # tensor is one): no device synchronisation
    kw = dict(dtype=dtype, device=device)
    rest = torch.full((2 * n,), 1.0 / (2.0 * scale), **kw)
    wm = torch.cat([torch.full((1,), lam / scale, **kw), rest])
    wc = torch.cat([torch.full((1,), lam / scale + (1.0 - alpha**2 + beta), **kw), rest])
    gamma = torch.sqrt(torch.full((), scale, **kw))
    return wm, wc, gamma


def _sigma_points(mean, cov, gamma):
    """2n+1 sigma points via Cholesky of P (ukf :322-341). [..., 2n+1, n]."""
    chol = cholesky_small(cov)  # lower
    offsets = gamma * chol.mT  # rows are gamma * column_i(L)
    center = mean[..., None, :]
    return torch.cat([center, center + offsets, center - offsets], dim=-2)


def ukf_step(belief, measurement, control, dt, q, r, model=None,
             alpha=1e-3, beta=2.0, kappa=0.0):
    """Full UKF predict + update (ukf :443-541), batched."""
    model = model or unicycle_position_model()
    n = belief.mean.shape[-1]
    wm, wc, gamma = ukf_weights(
        n, alpha, beta, kappa, dtype=belief.mean.dtype, device=belief.mean.device
    )

    # Predict
    sig = _sigma_points(belief.mean, belief.cov, gamma)
    sig_prop = model.propagate(sig, control[..., None, :], dt)
    x_pred = torch.einsum("i,...in->...n", wm, sig_prop)
    dx = sig_prop - x_pred[..., None, :]
    p_pred = torch.einsum("i,...in,...im->...nm", wc, dx, dx) + q

    # Update: redraw sigma points around the predicted belief (matches the
    # reference, which re-generates sigma points for the update pass).
    sig_u = _sigma_points(x_pred, p_pred, gamma)
    z_sig = model.observe(sig_u)
    z_pred = torch.einsum("i,...ik->...k", wm, z_sig)
    dz = z_sig - z_pred[..., None, :]
    s = torch.einsum("i,...ik,...il->...kl", wc, dz, dz) + r
    dxu = sig_u - x_pred[..., None, :]
    pxz = torch.einsum("i,...in,...ik->...nk", wc, dxu, dz)
    k_gain = _sym_solve(s, pxz.mT).mT
    y = measurement - z_pred
    mean = x_pred + (k_gain @ y[..., None])[..., 0]
    cov = p_pred - k_gain @ s @ k_gain.mT
    return GaussianBelief(mean, cov)


# ---------------------------------------------------------------------------
# CKF (cubature_kalman_filter.rs:33-368)
# ---------------------------------------------------------------------------

def ckf_step(belief, measurement, control, dt, q, r, model=None):
    """Cubature KF: 2n equally-weighted points at ±√n·L columns; zero tuning
    parameters (cubature_kalman_filter.rs:176-182)."""
    model = model or unicycle_position_model()
    n = belief.mean.shape[-1]
    sqrt_n = math.sqrt(float(n))

    def cubature(mean, cov):
        offsets = sqrt_n * cholesky_small(cov).mT
        center = mean[..., None, :]
        return torch.cat([center + offsets, center - offsets], dim=-2)

    # Predict
    pts = cubature(belief.mean, belief.cov)
    pts_prop = model.propagate(pts, control[..., None, :], dt)
    x_pred = torch.mean(pts_prop, dim=-2)
    dx = pts_prop - x_pred[..., None, :]
    p_pred = true_div(torch.einsum("...in,...im->...nm", dx, dx), 2 * n) + q

    # Update
    pts_u = cubature(x_pred, p_pred)
    z_pts = model.observe(pts_u)
    z_pred = torch.mean(z_pts, dim=-2)
    dz = z_pts - z_pred[..., None, :]
    s = true_div(torch.einsum("...ik,...il->...kl", dz, dz), 2 * n) + r
    dxu = pts_u - x_pred[..., None, :]
    pxz = true_div(torch.einsum("...in,...ik->...nk", dxu, dz), 2 * n)
    k_gain = _sym_solve(s, pxz.mT).mT
    y = measurement - z_pred
    mean = x_pred + (k_gain @ y[..., None])[..., 0]
    cov = p_pred - k_gain @ s @ k_gain.mT
    return GaussianBelief(mean, cov)


# ---------------------------------------------------------------------------
# Information filter (information_filter.rs)
# ---------------------------------------------------------------------------

def information_step(belief, measurements, control, dt, q, r, model=None):
    """Information-form update: Λ ← Λ_pred + Σ_s Hᵀ R⁻¹ H, additive over a
    stacked sensor axis (information_filter.rs multi-sensor update).

    `measurements` has shape [..., S, k] for S sensors (S may be 1).
    """
    model = model or unicycle_position_model()
    pred = ekf_predict(belief, control, dt, q, model)
    lam = inv_spd_small(pred.cov)
    eta = (lam @ pred.mean[..., None])[..., 0]
    h = model.obs_jac(pred.mean)
    z_pred = model.observe(pred.mean)
    ht_rinv = h.mT @ inv_spd_small(r)

    for s in range(measurements.shape[-2]):
        y = measurements[..., s, :] - z_pred + (h @ pred.mean[..., None])[..., 0]
        lam = lam + ht_rinv @ h
        eta = eta + (ht_rinv @ y[..., None])[..., 0]
    cov = inv_spd_small(lam)
    mean = (cov @ eta[..., None])[..., 0]
    return GaussianBelief(mean, cov)


# ---------------------------------------------------------------------------
# Ensemble KF (ensemble_kalman_filter.rs)
# ---------------------------------------------------------------------------

def enkf_step(ensemble, measurement, control, dt, q_chol, r_chol, generator,
              model=None):
    """Stochastic EnKF over an ensemble [..., E, n]: propagate members with
    sampled process noise, update with perturbed observations using ensemble
    cross-covariances (ensemble_kalman_filter.rs). The noise is drawn from
    `generator`, a `torch.Generator` on the ensemble's device.

    Returns the updated ensemble (mean/cov are derived statistics).
    """
    model = model or unicycle_position_model()
    e = ensemble.shape[-2]
    like = dict(dtype=ensemble.dtype, device=ensemble.device)
    w = torch.randn(ensemble.shape, generator=generator, **like)
    prop = model.propagate(ensemble, control[..., None, :], dt)
    prop = prop + torch.einsum("...en,nm->...em", w, q_chol.mT)
    z_pred = model.observe(prop)
    v = torch.randn(z_pred.shape, generator=generator, **like)
    z_perturbed = measurement[..., None, :] + torch.einsum(
        "...ek,kl->...el", v, r_chol.mT
    )
    x_mean = torch.mean(prop, dim=-2, keepdim=True)
    z_mean = torch.mean(z_pred, dim=-2, keepdim=True)
    dx = prop - x_mean
    dz = z_pred - z_mean
    pxz = torch.einsum("...en,...ek->...nk", dx, dz) / (e - 1)
    pzz = torch.einsum("...ek,...el->...kl", dz, dz) / (e - 1) + r_chol @ r_chol.mT
    k_gain = _sym_solve(pzz, pxz.mT).mT
    innov = z_perturbed - z_pred
    return prop + torch.einsum("...nk,...ek->...en", k_gain, innov)


def ensemble_statistics(ensemble):
    """Ensemble [..., E, n] -> GaussianBelief (mean + sample covariance)."""
    e = ensemble.shape[-2]
    mean = torch.mean(ensemble, dim=-2)
    d = ensemble - mean[..., None, :]
    cov = torch.einsum("...en,...em->...nm", d, d) / (e - 1)
    return GaussianBelief(mean, cov)
