"""The remaining localizers: complementary, histogram, square-root UKF and
the adaptive EKF/CKF.

The port of rust_robotics_tpu/filters/extra.py. Reference
(crates/rust_robotics_localization/src/):
- complementary_filter.rs — α-blend of prediction and measurement
  (α = 0.98 default, :25-40; α = 1 is pure prediction);
- histogram_filter.rs — Bayes over a 2-D grid with RFID range likelihoods;
- square_root_ukf.rs — carries the Cholesky factor of P (:114-407);
- adaptive_filter.rs — an NIS χ² test switches EKF ↔ CKF (:26-170).

Every function takes the JAX function's shapes plus optional leading batch
dims. The histogram filter is a raster program over [..., W, H]: the
motion is a per-lane cyclic shift (a gather, so nothing is read back) and a
k×k box convolution with zero padding ("same", by `F.conv2d` with cuDNN's
TF32 off in the call, so float32 stays float32 under PyTorch's default
`cudnn.allow_tf32 = True`); the measurement an elementwise likelihood
product. The SR-UKF takes the upper factor of the stacked weighted
deviations by a batched Householder QR (`ops.smallmat.householder_r`) in
plain torch (the algorithm of LAPACK's geqrf, elementwise over the batch);
only RᵀR is used, so the signs of R's rows do not matter. The adaptive filter runs
both candidate filters and selects per lane.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters.kalman import (
    ckf_step,
    ekf_step_with_innovation,
    ukf_weights,
    unicycle_position_model,
)
from rust_robotics_tpu_torch.ops.smallmat import cholesky_small, householder_r, solve_spd_small


# ---------------------------------------------------------------------------
# Complementary filter (complementary_filter.rs)
# ---------------------------------------------------------------------------

def complementary_step(state, measurement, control, dt, alpha=0.98, model=None):
    """x ← α·f(x, u) + (1−α)·z on the measured components (position) of
    the prediction (complementary_filter.rs)."""
    model = model or unicycle_position_model()
    pred = model.propagate(state, control, dt)
    blended_xy = alpha * pred[..., :2] + (1.0 - alpha) * measurement
    return torch.cat([blended_xy, pred[..., 2:]], dim=-1)


# ---------------------------------------------------------------------------
# Histogram filter (histogram_filter.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HistogramConfig:
    min_x: float = -10.0
    min_y: float = -10.0
    resolution: float = 0.5
    width: int = 80
    height: int = 80
    motion_noise_kernel: int = 3  # odd; discrete diffusion width
    range_sigma: float = 1.0


def histogram_init(cfg: HistogramConfig, dtype=torch.float32, device=None, batch_shape=()):
    """Uniform belief raster [*batch_shape, W, H] on `device` (default
    cuda)."""
    p = torch.ones((*batch_shape, cfg.width, cfg.height), dtype=dtype,
                   device=resolve_device(device))
    return p / torch.sum(p, dim=(-2, -1), keepdim=True)


def _cell_centres(cfg, like):
    kw = dict(dtype=like.dtype, device=like.device)
    xs = cfg.min_x + cfg.resolution * (torch.arange(cfg.width, **kw) + 0.5)
    ys = cfg.min_y + cfg.resolution * (torch.arange(cfg.height, **kw) + 0.5)
    return xs, ys


def _normalise(belief):
    return belief / torch.clamp(torch.sum(belief, dim=(-2, -1), keepdim=True), min=1e-30)


def histogram_predict(belief, du_xy, cfg: HistogramConfig):
    """Shift the raster by the rounded motion (cyclically, as `jnp.roll`)
    and diffuse it with a k×k box kernel (histogram_filter.rs motion
    update). belief [..., W, H]; du_xy [..., 2]."""
    w, h = belief.shape[-2:]
    du_xy = torch.as_tensor(du_xy, dtype=belief.dtype, device=belief.device)
    # round half to even, as jnp.round
    shift = torch.round(true_div(du_xy, cfg.resolution)).to(torch.int64)
    lead = torch.broadcast_shapes(belief.shape[:-2], shift.shape[:-1])
    belief = belief.expand(*lead, w, h)
    rows = torch.remainder(torch.arange(w, device=belief.device) - shift[..., 0, None], w)
    cols = torch.remainder(torch.arange(h, device=belief.device) - shift[..., 1, None], h)
    rolled = torch.take_along_dim(belief, rows.expand(*lead, w)[..., :, None], dim=-2)
    rolled = torch.take_along_dim(rolled, cols.expand(*lead, h)[..., None, :], dim=-1)
    k = cfg.motion_noise_kernel
    kernel = torch.full((1, 1, k, k), 1.0 / (k * k), dtype=belief.dtype, device=belief.device)
    # "same": the centre of the full convolution; the box is symmetric, so
    # the correlation conv2d computes is the convolution
    flat = F.pad(rolled.reshape(-1, 1, w, h), (k // 2, (k - 1) // 2, k // 2, (k - 1) // 2))
    # cuDNN's flags as they stand, but TF32 off: float32 stays full float32
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(flat, kernel).reshape(*lead, w, h)
    return _normalise(out)


def histogram_update_ranges(belief, observed_ranges, landmarks, cfg: HistogramConfig):
    """Multiply the per-cell Gaussian range likelihoods to each landmark
    (histogram_filter.rs RFID update). belief [..., W, H];
    observed_ranges [..., L]; landmarks [L, 2] or [..., L, 2]."""
    xs, ys = _cell_centres(cfg, belief)
    cx = xs[:, None, None]
    cy = ys[None, :, None]
    lm = landmarks[..., None, None, :, :]  # [..., 1, 1, L, 2]
    d = torch.sqrt((cx - lm[..., 0]) ** 2 + (cy - lm[..., 1]) ** 2)  # [..., W, H, L]
    ll = -0.5 * true_div(d - observed_ranges[..., None, None, :], cfg.range_sigma) ** 2
    return _normalise(belief * torch.exp(torch.sum(ll, dim=-1)))


def histogram_estimate(belief, cfg: HistogramConfig):
    """Probability-weighted mean position [..., 2]."""
    xs, ys = _cell_centres(cfg, belief)
    px = torch.sum(belief, dim=-1)
    py = torch.sum(belief, dim=-2)
    return torch.stack([torch.sum(px * xs, dim=-1), torch.sum(py * ys, dim=-1)], dim=-1)


# ---------------------------------------------------------------------------
# Square-root UKF (square_root_ukf.rs)
# ---------------------------------------------------------------------------

def _qr_sqrt(weighted_dev, noise_chol):
    """Upper-triangular sqrt factor of Σ wᵢ dᵢdᵢᵀ + N via QR of the stacked
    [dev; cholᵀ] matrix (the stable aggregate of the reference's rank-1
    update sequence, square_root_ukf.rs:114-407)."""
    noise_t = noise_chol.mT
    lead = torch.broadcast_shapes(weighted_dev.shape[:-2], noise_t.shape[:-2])
    stacked = torch.cat([weighted_dev.expand(*lead, *weighted_dev.shape[-2:]),
                         noise_t.expand(*lead, *noise_t.shape[-2:])], dim=-2)
    return householder_r(stacked)  # S = rᵀ r


def _sqrt_factor(wc, dev, noise_chol):
    """Lower sqrt factor of Σᵢ wc_i d_i d_iᵀ + N. The centre weight wc[0]
    is negative for the standard α: QR covers the positive-weight points
    and the centre term applies as a signed rank-1 re-factorisation (the
    reference's cholupdate/downdate pair)."""
    w_pos = torch.sqrt(wc[1:])[:, None]
    r = _qr_sqrt(w_pos * dev[..., 1:, :], noise_chol)
    s = r.mT @ r
    v = dev[..., 0, :]
    s = s + wc[0] * v[..., :, None] * v[..., None, :]
    n = s.shape[-1]
    s = 0.5 * (s + s.mT) + 1e-14 * torch.eye(n, dtype=s.dtype, device=s.device)
    return cholesky_small(s)


def sr_ukf_step(mean, sqrt_cov, measurement, control, dt, q_chol, r_chol, model=None,
                alpha=1e-3, beta=2.0, kappa=0.0):
    """Square-root UKF step carrying the Cholesky factor of P.

    mean [..., n]; sqrt_cov [..., n, n] LOWER factor (P = L Lᵀ). Returns
    (mean, sqrt_cov); P is never propagated as such, so positive
    definiteness cannot be lost to round-off (square_root_ukf.rs)."""
    model = model or unicycle_position_model()
    n = mean.shape[-1]
    wm, wc, gamma = ukf_weights(n, alpha, beta, kappa, dtype=mean.dtype, device=mean.device)
    lead = torch.broadcast_shapes(mean.shape[:-1], sqrt_cov.shape[:-2])
    offsets = gamma * sqrt_cov.mT
    center = mean.expand(*lead, n)[..., None, :]
    sig = torch.cat([center, center + offsets, center - offsets], dim=-2)
    sig_prop = model.propagate(sig, control[..., None, :], dt)
    x_pred = torch.einsum("i,...in->...n", wm, sig_prop)
    dev = sig_prop - x_pred[..., None, :]
    s_pred = _sqrt_factor(wc, dev, q_chol)

    # measurement update with sigma points re-drawn from s_pred
    offsets_u = gamma * s_pred.mT
    center = x_pred[..., None, :]
    sig_u = torch.cat([center, center + offsets_u, center - offsets_u], dim=-2)
    z_sig = model.observe(sig_u)
    z_pred = torch.einsum("i,...ik->...k", wm, z_sig)
    dz = z_sig - z_pred[..., None, :]
    s_z_l = _sqrt_factor(wc, dz, r_chol)
    dxu = sig_u - x_pred[..., None, :]
    pxz = torch.einsum("i,...in,...ik->...nk", wc, dxu, dz)
    s_z = s_z_l @ s_z_l.mT
    k_gain = solve_spd_small(s_z, pxz.mT).mT
    y = measurement - z_pred
    new_mean = x_pred + (k_gain @ y[..., None])[..., 0]
    # posterior factor via a signed re-factorisation of P⁻ − K S_z Kᵀ
    p_pred = s_pred @ s_pred.mT
    p_new = p_pred - k_gain @ s_z @ k_gain.mT
    new_sqrt = cholesky_small(0.5 * (p_new + p_new.mT)
                              + 1e-12 * torch.eye(n, dtype=mean.dtype, device=mean.device))
    return new_mean, new_sqrt


# ---------------------------------------------------------------------------
# Adaptive EKF/CKF (adaptive_filter.rs:26-170)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    nis_upper: float = 9.21  # χ²(2) 99 %: switch to the CKF above
    nis_lower: float = 4.61  # χ²(2) 90 %: switch back to the EKF below


def adaptive_step(belief, use_ckf, measurement, control, dt, q, r, model=None,
                  cfg: AdaptiveConfig = AdaptiveConfig()):
    """An EKF step with its innovation's NIS; a hysteresis switch to the
    CKF when the NIS is high (adaptive_filter.rs). Returns (belief,
    use_ckf_next, nis). Both filters run; each lane selects its own."""
    model = model or unicycle_position_model()
    ekf_belief, y, s = ekf_step_with_innovation(belief, measurement, control, dt, q, r, model)
    nis = torch.sum(y * solve_spd_small(s, y[..., None])[..., 0], dim=-1)
    ckf_belief = ckf_step(belief, measurement, control, dt, q, r, model)
    use_ckf = torch.as_tensor(use_ckf, device=nis.device)
    mean = torch.where(use_ckf[..., None], ckf_belief.mean, ekf_belief.mean)
    cov = torch.where(use_ckf[..., None, None], ckf_belief.cov, ekf_belief.cov)
    next_use = torch.where(nis > cfg.nis_upper, True,
                           torch.where(nis < cfg.nis_lower, False, use_ckf))
    return GaussianBelief(mean, cov), next_use, nis
