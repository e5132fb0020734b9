"""UKF-vs-CKF accuracy experiment suite.

The port of rust_robotics_tpu/experiments/ukf_ckf_accuracy.py. Reference:
crates/rust_robotics_localization/src/experiments/ukf_ckf_accuracy/mod.rs
(:33-:1205) — scenario *families* (MotionProfile: commanded vs true
velocity/yaw waves, control latency, actuator limits, process/control/
observation noise, observation refresh/hold/outlier bursts), deterministic
seeded simulations, per-scenario UKF and CKF RMSE, aggregation *variants*
that select scenario slots (full coverage, strided subsampling, escalation
on disagreement), and `AccuracyObservation` rows (bucket median RMSE,
min/max, ckf_wins, ukf_over_ckf ratio, winner, coverage_ratio) compared
across variants by (family, bucket) key.

A family's scenarios run as lanes of one batch and both filters step
inside the same loop over time, which reads nothing until the RMSEs. The
noise a scenario draws (JAX: five streams from `jax.random.split(key, 6)`)
is given as `draws=` (`FamilyDraws`, one row a scenario) or drawn from a
`torch.Generator`. Aggregation variants then index the RMSE vectors on
the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters.kalman import ckf_step, ukf_step, unicycle_position_model
from rust_robotics_tpu_torch.models.motion import unicycle_propagate
from rust_robotics_tpu_torch.utils.experiments import VariantDescriptor

__all__ = ["MotionProfile", "SCENARIO_FAMILIES", "AccuracyObservation", "FamilyDraws",
           "simulate_family_rmse", "run_ukf_ckf_accuracy"]


@dataclasses.dataclass(frozen=True)
class MotionProfile:
    """The reference's MotionProfile surface (mod.rs:42-70), trimmed to the
    fields that drive observable behavior."""

    velocity: float = 1.0
    yaw_rate: float = 0.1
    true_velocity_wave: float = 0.0
    true_yaw_wave_deg: float = 0.0
    control_latency_steps: int = 0
    process_noise_xy: float = 0.01
    process_noise_yaw_deg: float = 0.5
    control_noise_v: float = 0.05
    control_noise_yaw_deg: float = 1.0
    control_bias_v: float = 0.0
    obs_noise_x: float = 0.15
    obs_noise_y: float = 0.15
    observation_refresh_interval: int = 1
    observation_outlier_probability: float = 0.0
    observation_outlier_scale: float = 6.0


SCENARIO_FAMILIES = {
    "nominal": MotionProfile(),
    "aggressive_yaw": MotionProfile(yaw_rate=0.45, true_yaw_wave_deg=20.0),
    "velocity_wave": MotionProfile(true_velocity_wave=0.6),
    "latency": MotionProfile(control_latency_steps=3),
    "biased_control": MotionProfile(control_bias_v=0.15),
    "sparse_observations": MotionProfile(observation_refresh_interval=4),
    "outliers": MotionProfile(observation_outlier_probability=0.08),
    "noisy_obs": MotionProfile(obs_noise_x=0.5, obs_noise_y=0.5),
    "fast": MotionProfile(velocity=2.5),
    "drift": MotionProfile(process_noise_yaw_deg=2.5),
}


class FamilyDraws(NamedTuple):
    """A family's noise, one row a scenario: standard normals for the
    commanded speed and yaw rate [S, T], the process [S, T, 4] and the
    observations [S, T, 2], and the outlier uniforms [S, T]."""

    control_v: torch.Tensor
    control_w: torch.Tensor
    process: torch.Tensor
    observation: torch.Tensor
    outlier: torch.Tensor


@dataclasses.dataclass
class AccuracyObservation:
    """mod.rs:81-113 AccuracyObservation analog."""

    family_name: str
    bucket: int
    total_scenarios: int
    selected_slots: tuple
    escalated: bool
    ukf_bucket_median_rmse: float
    ckf_bucket_median_rmse: float
    ukf_min_rmse: float
    ukf_max_rmse: float
    ckf_min_rmse: float
    ckf_max_rmse: float
    ckf_wins: int

    def ukf_over_ckf(self):
        return self.ukf_bucket_median_rmse / max(self.ckf_bucket_median_rmse, 1e-9)

    def winner(self):
        return "CKF" if self.ukf_over_ckf() > 1.0 else "UKF"

    def coverage_ratio(self):
        return len(self.selected_slots) / self.total_scenarios

    def comparison_key(self):
        return (self.family_name, self.bucket)


def draw_family(generator, steps, n_scenarios, dtype=torch.float32, device=None):
    """A family's `FamilyDraws` from a `torch.Generator` (on its device)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    return FamilyDraws(torch.randn((n_scenarios, steps), **kw),
                       torch.randn((n_scenarios, steps), **kw),
                       torch.randn((n_scenarios, steps, 4), **kw),
                       torch.randn((n_scenarios, steps, 2), **kw),
                       torch.rand((n_scenarios, steps), **kw))


def simulate_family_rmse(profile: MotionProfile, steps: int = 120, n_scenarios: int = 32,
                         dt: float = 0.1, draws: FamilyDraws = None, generator=None,
                         dtype=torch.float32, device=None):
    """Per-scenario (UKF RMSE [S], CKF RMSE [S]) for one family: every
    scenario and both filters in one loop over time, on `device` (default
    cuda; `draws`' device if given) in `dtype`."""
    if draws is None:
        draws = draw_family(generator, steps, n_scenarios, dtype, resolve_device(device))
    dev = draws.control_v.device
    draws = FamilyDraws(*(d.to(dtype) for d in draws))
    n_scenarios = draws.control_v.shape[0]
    model = unicycle_position_model()
    deg = math.pi / 180.0

    def diag2(values):
        return torch.diag_embed(torch.stack([torch.full((), v, dtype=dtype, device=dev)
                                             for v in values])) ** 2

    q = diag2((0.1, 0.1, 1.0 * deg, 1.0))
    r = diag2((profile.obs_noise_x, profile.obs_noise_y))

    t = torch.arange(steps, dtype=dtype, device=dev) * dt
    v_true = profile.velocity * (1.0 + profile.true_velocity_wave * torch.sin(0.7 * t))
    w_true = profile.yaw_rate + profile.true_yaw_wave_deg * deg * torch.sin(0.9 * t)
    # commanded = delayed + biased + noisy copy of true
    lag = profile.control_latency_steps
    v_cmd = (torch.roll(v_true, lag) + profile.control_bias_v
             + profile.control_noise_v * draws.control_v)
    w_cmd = torch.roll(w_true, lag) + profile.control_noise_yaw_deg * deg * draws.control_w
    proc_scale = torch.stack([torch.full((), v, dtype=dtype, device=dev) for v in (
        profile.process_noise_xy, profile.process_noise_xy, profile.process_noise_yaw_deg * deg,
        0.0)])
    proc = draws.process * proc_scale
    obs_scale = torch.stack([torch.full((), v, dtype=dtype, device=dev)
                             for v in (profile.obs_noise_x, profile.obs_noise_y)])
    obs_noise = draws.observation * obs_scale
    outlier = draws.outlier < profile.observation_outlier_probability
    obs_noise = torch.where(outlier[..., None], obs_noise * profile.observation_outlier_scale,
                            obs_noise)
    fresh = [k % profile.observation_refresh_interval == 0 for k in range(steps)]

    x_true = torch.zeros((n_scenarios, 4), dtype=dtype, device=dev)
    eye = torch.eye(4, dtype=dtype, device=dev).expand(n_scenarios, 4, 4)
    bu = bc = GaussianBelief(x_true, eye)
    last_z = torch.zeros((n_scenarios, 2), dtype=dtype, device=dev)
    eu, ec = [], []
    for k in range(steps):
        u_true = torch.stack([v_true[k], w_true[k]]).expand(n_scenarios, 2)
        u_cmd = torch.stack([v_cmd[:, k], w_cmd[:, k]], -1)
        x_true = unicycle_propagate(x_true, u_true, dt) + proc[:, k]
        z = x_true[:, :2] + obs_noise[:, k] if fresh[k] else last_z  # held observation
        bu = ukf_step(bu, z, u_cmd, dt, q, r, model)
        bc = ckf_step(bc, z, u_cmd, dt, q, r, model)
        eu.append(torch.sum((bu.mean[:, :2] - x_true[:, :2]) ** 2, -1))
        ec.append(torch.sum((bc.mean[:, :2] - x_true[:, :2]) ** 2, -1))
        last_z = z
    return (torch.sqrt(torch.mean(torch.stack(eu, -1), -1)),
            torch.sqrt(torch.mean(torch.stack(ec, -1), -1)))


# aggregation variants (mod.rs: 5 variants selecting scenario slots)
def _slots_full(n):
    return list(range(n))


def _slots_strided(n, stride):
    return list(range(0, n, stride))


AGGREGATION_VARIANTS = (
    VariantDescriptor("full_coverage", "median over every scenario"),
    VariantDescriptor("strided_2", "every 2nd scenario"),
    VariantDescriptor("strided_4", "every 4th scenario"),
    VariantDescriptor("head_8", "first 8 scenarios only"),
    VariantDescriptor("escalating", "strided-4, escalate to full when "
                                    "UKF/CKF disagree by >10%"),
)


def run_ukf_ckf_accuracy(seed: int = 0, families=None, steps: int = 120, n_scenarios: int = 32,
                         buckets=(8, 16, 32), draws=None, dtype=torch.float32, device=None):
    """The full suite: families × aggregation variants × RMSE buckets.
    Returns {variant: [AccuracyObservation, ...]}. `draws`: {family name:
    FamilyDraws}; else family i (in sorted order) draws from a
    `torch.Generator` seeded seed·1000 + i, on `device` (default cuda)."""
    device = resolve_device(device)
    families = families or SCENARIO_FAMILIES
    rmse = {}
    for i, (name, profile) in enumerate(sorted(families.items())):
        if draws is not None:
            fam = draws[name]
        else:
            gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
            fam = draw_family(gen, steps, n_scenarios, dtype, device)
        eu, ec = simulate_family_rmse(profile, steps, n_scenarios, draws=fam, dtype=dtype)
        rmse[name] = tuple(torch.stack([eu, ec]).cpu().numpy())

    out = {}
    for v in AGGREGATION_VARIANTS:
        rows = []
        for name, (eu, ec) in sorted(rmse.items()):
            n = len(eu)
            escalated = False
            if v.name == "full_coverage":
                slots = _slots_full(n)
            elif v.name == "strided_2":
                slots = _slots_strided(n, 2)
            elif v.name == "strided_4":
                slots = _slots_strided(n, 4)
            elif v.name == "head_8":
                slots = list(range(min(8, n)))
            else:  # escalating
                slots = _slots_strided(n, 4)
                med_u = np.median(eu[slots])
                med_c = np.median(ec[slots])
                if abs(med_u / max(med_c, 1e-9) - 1.0) > 0.1:
                    slots = _slots_full(n)
                    escalated = True
            su, sc = eu[slots], ec[slots]
            for bucket in buckets:
                bu, bc = su[:bucket], sc[:bucket]
                if len(bu) == 0:
                    continue
                rows.append(AccuracyObservation(
                    family_name=name,
                    bucket=bucket,
                    total_scenarios=n,
                    selected_slots=tuple(slots[:bucket]),
                    escalated=escalated,
                    ukf_bucket_median_rmse=float(np.median(bu)),
                    ckf_bucket_median_rmse=float(np.median(bc)),
                    ukf_min_rmse=float(bu.min()),
                    ukf_max_rmse=float(bu.max()),
                    ckf_min_rmse=float(bc.min()),
                    ckf_max_rmse=float(bc.max()),
                    ckf_wins=int((bc < bu).sum()),
                ))
        out[v.name] = rows
    return out
