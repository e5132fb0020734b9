"""Drone trajectory quality experiment suite.

The port of rust_robotics_tpu/experiments/drone_quality.py. Reference:
crates/rust_robotics_control/src/experiments/drone_trajectory_quality/ —
trajectory-generator variants (quintic segments vs minimum-snap) flown by
the PD quadrotor through seeded waypoint scenarios; per-cell quality
metrics (tracking RMSE, max error, smoothness/jerk integral, completion)
aggregated by the shared harness and annotated against the reference
variant.

The segment solves and the closed-loop PD flight are control/aerial.py's.
A seed's waypoints come from its [5, 3] uniforms in [−1, 1) (`draws=`,
JAX's `jax.random.uniform(key, (5, 3), minval=-1.0, maxval=1.0)`), else
from a `torch.Generator` seeded by the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device
from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.control.aerial import (
    QuadPDConfig,
    eval_poly8,
    minimum_snap_coeffs,
    quad_pd_accel,
    quintic_3d_segments,
    simulate_quadrotor,
)
from rust_robotics_tpu_torch.control.aerial import _up
from rust_robotics_tpu_torch.utils.experiments import (
    ExperimentSamplingPlan,
    VariantDescriptor,
    annotate_against_reference,
    run_experiment,
)

__all__ = ["run_drone_trajectory_quality", "GENERATORS"]

GENERATORS = (
    VariantDescriptor("quintic", "per-segment quintic (5th order)"),
    VariantDescriptor("min_snap", "7th-order minimum snap"),
)


def _waypoints(uniforms, scale=4.0):
    """[n, 3] waypoints from [n, 3] uniforms in [−1, 1): z lifted to
    |z| + 1."""
    w = uniforms * scale
    return torch.cat([w[:, :2], torch.abs(w[:, 2:]) + 1.0], dim=1)


def _fly_quintic(waypoints, segment_time=2.0, dt=0.02):
    coeffs = quintic_3d_segments(waypoints, segment_time)
    return simulate_quadrotor(coeffs, segment_time, dt)


def _fly_min_snap(waypoints, segment_time=2.0, dt=0.02):
    n_seg = waypoints.shape[0] - 1
    times = torch.full((n_seg,), segment_time, dtype=waypoints.dtype, device=waypoints.device)
    axes = torch.stack([minimum_snap_coeffs(waypoints[:, d], times) for d in range(3)])  # [3, m, 8]
    steps = int(n_seg * segment_time / dt)
    last = torch.full((), n_seg - 1, dtype=torch.int64, device=waypoints.device)

    def ref_at(t):
        si = torch.minimum(true_div(t, segment_time).to(torch.int64), last)
        tl = t - si.to(t.dtype) * segment_time
        seg = axes.index_select(1, si.reshape(1))[:, 0]  # [3, 8]
        return tuple(eval_poly8(seg, tl, order) for order in (0, 1, 2))

    cfg = QuadPDConfig()
    up = _up(cfg, waypoints)
    ks = torch.arange(steps, dtype=waypoints.dtype, device=waypoints.device)
    pos, _, _ = ref_at(torch.zeros((), dtype=waypoints.dtype, device=waypoints.device))
    vel = torch.zeros_like(pos)
    ps, refs = [], []
    for k in range(steps):
        p_ref, v_ref, a_ref = ref_at(ks[k] * dt)
        acc = quad_pd_accel(pos, vel, p_ref, v_ref, a_ref, cfg) - up
        vel = vel + acc * dt
        pos = pos + vel * dt
        ps.append(pos)
        refs.append(p_ref)
    return torch.stack(ps), torch.stack(refs)


def _metrics(pos, refs, dt=0.02):
    e = torch.linalg.vector_norm(pos - refs, dim=-1)
    jerk = true_div(torch.diff(refs, n=3, dim=0), dt ** 3)
    out = torch.stack([torch.sqrt(torch.mean(e ** 2)), torch.amax(e),
                       torch.mean(torch.sum(jerk ** 2, -1)),
                       torch.linalg.vector_norm(pos[-1] - refs[-1])]).tolist()
    return dict(zip(("tracking_rmse", "max_error", "ref_jerk_integral", "endpoint_error"), out))


def run_drone_trajectory_quality(seeds=(0, 1, 2), reference="quintic", draws=None,
                                 dtype=torch.float32, device=None):
    """Suite: generators × seeded waypoint scenarios. `draws`: [S, 5, 3]
    uniforms in [−1, 1), one block a seed. Returns reports with deltas vs
    the reference variant."""
    device = resolve_device(device)
    if draws is None:
        draws = torch.stack([
            torch.rand((5, 3), generator=torch.Generator().manual_seed(int(s)),
                       dtype=torch.float64) for s in seeds]) * 2.0 - 1.0
    draws = _float_on(draws, device, dtype)
    lane = {s: i for i, s in enumerate(seeds)}

    def run_fn(variant, seed, scenario):
        wps = _waypoints(draws[lane[seed]])
        fly = _fly_quintic if variant.name == "quintic" else _fly_min_snap
        return _metrics(*fly(wps))

    plan = ExperimentSamplingPlan(seeds=tuple(seeds))
    reducers = {
        "mean_tracking_rmse": lambda obs: float(np.mean([o["tracking_rmse"] for o in obs])),
        "mean_jerk": lambda obs: float(np.mean([o["ref_jerk_integral"] for o in obs])),
        "worst_endpoint_error": lambda obs: float(np.max([o["endpoint_error"] for o in obs])),
    }
    reports = run_experiment(GENERATORS, plan, run_fn, reducers)
    return annotate_against_reference(reports, reference)
