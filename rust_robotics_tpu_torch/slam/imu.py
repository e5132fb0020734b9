"""Bias-aware IMU preintegration, the IMU factors and trajectory optimization.

The port of rust_robotics_tpu/slam/imu.py (reference:
slam/src/imu_preintegration.rs — `PreintegratedImuMeasurement::integrate`
(:180-240: bias-corrected sample, Δp/Δv/ΔR update, 9×9 error covariance
[rot, pos, vel] with transition/noise Jacobians, 9×6 bias Jacobian
recursion B ← A·B − N), lever-arm `ImuExtrinsics::transform` (:73),
`NavState` predict with first-order bias correction (:258-280), nav-state
retract (right perturbation, :922-968), the factors BiasPrior (:314),
BiasBetween (:346), NavStatePrior (:376), PositionVelocity (:435) and
ImuFactor (:582), and `optimize_imu_trajectory` (:799)).

- `preintegrate` takes any number of intervals as lanes: samples
  [..., N, 3], one Python loop over N in lock-step, nothing read back.
  Ragged intervals are padded at the end with dt = 0, and a padded step is
  an exact no-op: so3_exp(0) is exactly I, and every matrix product of the
  step is an explicit sum over k (`_mm`), in which a product with I or 0 is
  exact. The same sums make a lane's bits independent of the batch, so a
  padded lane is bitwise its solo run. The 9×9 transition and the 9×6
  noise Jacobian are assembled with `cat`, not written in place.
- Gravity is `GRAVITY`, three host numbers; each call builds it on the
  device by fills (`gravity_vector`), so no host value is copied in a step.
- `optimize_imu_trajectory` runs on the shared NLLS engine: the IMU
  factor's measurement is a dict of the stacked preintegrated fields, which
  `torch.func.vmap` maps leaf by leaf; Jacobians are reverse mode, as
  everywhere in the port's solver; the information is `inv_ex` of the
  regularised covariance, with no error-check read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rust_robotics_tpu_torch._numeric import filled, true_div
from rust_robotics_tpu_torch.core.lie import _safe_theta, skew, so3_exp, so3_log
from rust_robotics_tpu_torch.nlls import (
    FactorBlock,
    Problem,
    SolverConfig,
    VariableGroup,
    solve,
)

GRAVITY = (0.0, 0.0, -9.81)


@dataclasses.dataclass(frozen=True)
class Preintegrated:
    """Mirror of PreintegratedImuMeasurement (imu_preintegration.rs:152);
    every field carries the intervals' leading dims."""

    delta_rotation: Any  # [..., 3, 3]
    delta_position: Any  # [..., 3]
    delta_velocity: Any  # [..., 3]
    delta_time: Any  # [...]
    covariance: Any  # [..., 9, 9]
    bias_jacobian: Any  # [..., 9, 6]
    lin_bias: Any  # [..., 6] = [accel(3), gyro(3)] linearization point

    def map(self, fn) -> "Preintegrated":
        """fn applied to every field (an index, a move, a cast)."""
        return Preintegrated(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def gravity_vector(gravity, like):
    """`gravity` (host numbers or a tensor) as a [3] tensor on `like`'s
    device and dtype; host numbers are written by fills, not copied."""
    if isinstance(gravity, torch.Tensor):
        return gravity.to(device=like.device, dtype=like.dtype)
    return filled([float(v) for v in gravity], like.dtype, like.device)


def _mm(a, b):
    """a [..., m, k] @ b [..., k, n] as an explicit sum over k, left to right."""
    prod = a[..., :, :, None] * b[..., None, :, :]
    out = prod[..., 0, :]
    for j in range(1, a.shape[-1]):
        out = out + prod[..., j, :]
    return out


def _mv(a, v):
    return _mm(a, v[..., None])[..., 0]


def _rodrigues(phi):
    """`core.lie.so3_exp` with `_mm`'s sums (exactly I at phi = 0)."""
    theta2 = phi[..., 0] * phi[..., 0] + phi[..., 1] * phi[..., 1] + phi[..., 2] * phi[..., 2]
    small, theta = _safe_theta(theta2)
    k = skew(phi)
    a = torch.where(small, 1.0 - true_div(theta2, 6.0), torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - true_div(theta2, 24.0), (1.0 - torch.cos(theta)) / (theta * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None, None] * k + b[..., None, None] * _mm(k, k)


def transform_imu(accel, gyro, gyro_dot, rotation_bs, translation_bs):
    """Sensor→body with lever-arm terms (imu_preintegration.rs:73-90);
    vectors [..., 3], rotation [..., 3, 3]."""

    def mv(m, v):
        return (m @ v[..., None])[..., 0]

    w = mv(rotation_bs, gyro)
    wdot = mv(rotation_bs, gyro_dot)
    a = (mv(rotation_bs, accel) - mv(skew(w) @ skew(w), translation_bs)
         + mv(skew(translation_bs), wdot))
    return a, w


def preintegrate(accels, gyros, dts, lin_bias, accel_sigma, gyro_sigma):
    """Integrate body-frame samples (imu_preintegration.rs:180-240).

    accels/gyros [..., N, 3]; dts [..., N]; lin_bias [6] or [..., 6]. The
    leading dims are intervals in lock-step; pad a short one at the end
    with dt = 0. Returns Preintegrated with the leading dims."""
    f, dev = accels.dtype, accels.device
    lead = torch.broadcast_shapes(accels.shape[:-2], gyros.shape[:-2], dts.shape[:-1],
                                  lin_bias.shape[:-1])
    eye3 = torch.eye(3, dtype=f, device=dev)
    z33 = torch.zeros((3, 3), dtype=f, device=dev)
    meas_cov = torch.cat([torch.cat([eye3 * accel_sigma**2, z33], -1),
                          torch.cat([z33, eye3 * gyro_sigma**2], -1)], -2)

    rot = eye3.expand(*lead, 3, 3)
    dp = torch.zeros((*lead, 3), dtype=f, device=dev)
    dv = dp
    dt_total = torch.zeros(lead, dtype=f, device=dev)
    cov = torch.zeros((*lead, 9, 9), dtype=f, device=dev)
    bjac = torch.zeros((*lead, 9, 6), dtype=f, device=dev)
    zl = torch.zeros((*lead, 3, 3), dtype=f, device=dev)
    eye_l = eye3.expand(*lead, 3, 3)
    for i in range(accels.shape[-2]):
        a = accels[..., i, :] - lin_bias[..., :3]
        w = gyros[..., i, :] - lin_bias[..., 3:]
        dt = dts[..., i, None]
        ra = _mv(rot, a)
        hdt2 = 0.5 * dt * dt
        dp = dp + dv * dt + ra * hdt2
        dv = dv + ra * dt
        new_rot = _mm(rot, _rodrigues(w * dt))

        rsa = _mm(-rot, skew(a))
        dt_m, hdt2_m = dt[..., None], hdt2[..., None]
        eye_dt = eye_l * dt_m
        trans = torch.cat([
            torch.cat([_rodrigues(-w * dt), zl, zl], -1),
            torch.cat([rsa * hdt2_m, eye_l, eye_dt], -1),
            torch.cat([rsa * dt_m, zl, eye_l], -1),
        ], -2)
        njac = torch.cat([
            torch.cat([zl, eye_dt], -1),
            torch.cat([rot * hdt2_m, zl], -1),
            torch.cat([rot * dt_m, zl], -1),
        ], -2)
        cov = (_mm(_mm(trans, cov), trans.mT)
               + _mm(_mm(njac, meas_cov.expand(*lead, 6, 6)), njac.mT))
        bjac = _mm(trans, bjac) - njac
        rot, dt_total = new_rot, dt_total + dt[..., 0]
    return Preintegrated(rot, dp, dv, dt_total, cov, bjac, lin_bias.expand(*lead, 6))


def corrected_delta(pre: Preintegrated, bias):
    """First-order bias correction (imu_preintegration.rs:276-287)."""
    db = bias - pre.lin_bias
    corr = (pre.bias_jacobian @ db[..., None])[..., 0]
    rot = pre.delta_rotation @ so3_exp(corr[..., 0:3])
    dp = pre.delta_position + corr[..., 3:6]
    dv = pre.delta_velocity + corr[..., 6:9]
    return rot, dp, dv


def predict_nav_state(pre: Preintegrated, nav, bias, gravity=GRAVITY):
    """NavState::predict (:258-272). nav = [rot_tangent(3), pos(3), vel(3)]."""
    rot_i = so3_exp(nav[..., 0:3])
    drot, dp, dv = corrected_delta(pre, bias)
    dt = pre.delta_time[..., None]
    g = gravity_vector(gravity, nav)
    rot = rot_i @ drot
    pos = (nav[..., 3:6] + nav[..., 6:9] * dt + g * (0.5 * dt * dt)
           + (rot_i @ dp[..., None])[..., 0])
    vel = nav[..., 6:9] + g * dt + (rot_i @ dv[..., None])[..., 0]
    return torch.cat([so3_log(rot), pos, vel], -1)


def nav_retract(value, delta):
    """Right-perturbation retraction (:952-968)."""
    rot = so3_exp(value[..., 0:3]) @ so3_exp(delta[..., 0:3])
    return torch.cat([so3_log(rot), value[..., 3:6] + delta[..., 3:6],
                      value[..., 6:9] + delta[..., 6:9]], -1)


def imu_factor_residual(nav_i, nav_j, bias, meas):
    """ImuFactor residual (:630-656). `meas` = dict of the preintegrated
    fields and gravity."""
    pre = Preintegrated(meas["delta_rotation"], meas["delta_position"],
                        meas["delta_velocity"], meas["delta_time"], None,
                        meas["bias_jacobian"], meas["lin_bias"])
    drot, dp, dv = corrected_delta(pre, bias)
    rot_i = so3_exp(nav_i[0:3])
    rot_j = so3_exp(nav_j[0:3])
    dt = pre.delta_time
    g = meas["gravity"]
    r_rot = so3_log(drot.T @ rot_i.T @ rot_j)
    r_pos = rot_i.T @ (nav_j[3:6] - nav_i[3:6] - nav_i[6:9] * dt - g * (0.5 * dt * dt)) - dp
    r_vel = rot_i.T @ (nav_j[6:9] - nav_i[6:9] - g * dt) - dv
    return torch.cat([r_rot, r_pos, r_vel])


def nav_prior_residual(nav, meas):
    """NavStatePrior (:376): full 9-DOF anchor with rotation on the manifold."""
    rot = so3_exp(nav[0:3])
    rot_prior = so3_exp(meas[0:3])
    return torch.cat([so3_log(rot_prior.T @ rot), nav[3:6] - meas[3:6], nav[6:9] - meas[6:9]])


def position_velocity_residual(nav, meas):
    """PositionVelocity factor (:435): observes pos+vel (6-dim)."""
    return torch.cat([nav[3:6] - meas[0:3], nav[6:9] - meas[3:6]])


def bias_prior_residual(bias, meas):
    return bias - meas


def bias_between_residual(bias_i, bias_j, meas):
    """BiasBetween random-walk factor (:346)."""
    return bias_j - bias_i - meas


def optimize_imu_trajectory(
    nav_states, biases, preints: Preintegrated, gravity=GRAVITY,
    nav_prior=None, nav_prior_info=None,
    bias_prior=None, bias_prior_info=None,
    bias_between_info=None,
    posvel_meas=None, posvel_indices=None, posvel_info=None,
    config: SolverConfig | None = None,
):
    """Mirror of `optimize_imu_trajectory` (imu_preintegration.rs:799):
    jointly refine N nav states + N biases under consecutive IMU factors,
    priors, bias random walk, and optional position/velocity measurements.

    nav_states [N, 9] and biases [N, 6] are tensors, and the problem lives
    on their device and dtype; `preints` is stacked with leading N−1; the
    optional priors and measurements are tensors or host arrays. Returns
    (nav_states, biases, SolverSummary)."""
    n = nav_states.shape[0]
    f, dev = nav_states.dtype, nav_states.device

    def t(x, dtype=f):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    nav_group = VariableGroup("nav", nav_states, retract=nav_retract)
    bias_group = VariableGroup("bias", t(biases))
    reg = preints.covariance + 1e-12 * torch.eye(9, dtype=f, device=dev)
    info = torch.linalg.inv_ex(reg)[0]
    imu_meas = {
        "delta_rotation": preints.delta_rotation,
        "delta_position": preints.delta_position,
        "delta_velocity": preints.delta_velocity,
        "delta_time": preints.delta_time,
        "bias_jacobian": preints.bias_jacobian,
        "lin_bias": preints.lin_bias,
        "gravity": gravity_vector(gravity, nav_states).expand(n - 1, 3),
    }
    ar = torch.arange(n, device=dev)
    idx = torch.stack([ar[:-1], ar[1:], ar[:-1]], dim=-1)
    first = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    factors = [FactorBlock("imu", imu_factor_residual, ("nav", "nav", "bias"), idx,
                           measurement=imu_meas, information=info)]
    if nav_prior is not None:
        factors.append(FactorBlock(
            "nav_prior", nav_prior_residual, ("nav",), first, measurement=t(nav_prior)[None],
            information=None if nav_prior_info is None else t(nav_prior_info)[None]))
    if bias_prior is not None:
        factors.append(FactorBlock(
            "bias_prior", bias_prior_residual, ("bias",), first, measurement=t(bias_prior)[None],
            information=None if bias_prior_info is None else t(bias_prior_info)[None]))
    if bias_between_info is not None and n > 1:
        factors.append(FactorBlock(
            "bias_between", bias_between_residual, ("bias", "bias"),
            torch.stack([ar[:-1], ar[1:]], dim=-1),
            measurement=torch.zeros((n - 1, 6), dtype=f, device=dev),
            information=t(bias_between_info).expand(n - 1, 6, 6)))
    if posvel_meas is not None:
        factors.append(FactorBlock(
            "posvel", position_velocity_residual, ("nav",),
            t(posvel_indices, torch.int64)[:, None], measurement=t(posvel_meas),
            information=None if posvel_info is None else t(posvel_info)))
    prob = Problem((nav_group, bias_group), tuple(factors))
    solved, summary = solve(prob, config or SolverConfig())
    return solved.group("nav").values, solved.group("bias").values, summary
