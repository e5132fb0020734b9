"""EKF localization demo: deterministic closed-loop sim.

Reproduces the reference gallery demo
(crates/rust_robotics/examples/render_gif_ekf_localization.rs:16-76):
a robot drives a circle (v=1.0, omega=0.1, dt=0.1, 330 steps) starting at
(10, 0, pi/2, 0); odometry and a GPS-like position sensor are corrupted by
the reference's *deterministic* sinusoid pseudo-noise (:21-24), so outputs
are bit-stable and directly comparable across implementations.

The closed loop is one Python loop over the steps; an optional batch axis
runs B independent replicas (phase-shifted noise) in every step's tensors.
"""

import math

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters.kalman import ekf_step, unicycle_position_model


def deterministic_noise(k, scale, phase):
    """`render_gif_ekf_localization.rs:21-24`: scale*sin(0.13 t + phase)
    + 0.5*scale*cos(0.07 t + 1.3*phase). `k` and `phase` are floats or
    floating tensors."""
    tensor = isinstance(k, torch.Tensor) or isinstance(phase, torch.Tensor)
    sin, cos = (torch.sin, torch.cos) if tensor else (math.sin, math.cos)
    return scale * sin(0.13 * k + phase) + 0.5 * scale * cos(0.07 * k + 1.3 * phase)


def default_ekf_noise(device=None, dtype=torch.float32):
    """EKFConfig::default() (ekf.rs:36-46): Q = diag(0.1², 0.1², (1°)², 0.1²),
    R = I₂."""
    device = resolve_device(device)
    q = torch.diag(
        torch.tensor(
            [0.1**2, 0.1**2, math.radians(1.0) ** 2, 0.1**2], dtype=dtype, device=device
        )
    )
    r = torch.eye(2, dtype=dtype, device=device)
    return q, r


def run_ekf_localization_demo(
    steps: int = 330,
    dt: float = 0.1,
    v_true: float = 1.0,
    w_true: float = 0.1,
    noise_phase_offset=0.0,
    filter_step=ekf_step,
    device=None,
    dtype=torch.float32,
):
    """Run the closed-loop demo; returns a dict of per-step tensors.

    `noise_phase_offset` may be a scalar or a batch vector [B]; in the
    batched case every output gains a leading [B] axis and B independent
    filters run together. Outputs: truth/estimate [..., T, 4], measurement
    [..., T, 2], cov [..., T, 4, 4], final_mean, final_cov.

    Truth integration order matches the reference (:54-57): x,y advance with
    the *old* yaw, then yaw advances.
    """
    device = resolve_device(device)
    q, r = default_ekf_noise(device, dtype)
    model = unicycle_position_model()
    offset = torch.as_tensor(noise_phase_offset, dtype=dtype, device=device)
    batch_shape = tuple(offset.shape)

    init_state = torch.tensor(
        [10.0, 0.0, math.pi / 2, 0.0], dtype=dtype, device=device
    ).expand(batch_shape + (4,))
    init_cov = torch.eye(4, dtype=dtype, device=device).expand(batch_shape + (4, 4))
    belief = GaussianBelief(init_state, init_cov)
    truth = init_state
    ks = torch.arange(steps, dtype=dtype, device=device)

    trace = {"truth": [], "estimate": [], "measurement": [], "cov": []}
    for k in range(steps):
        x, y, yaw = truth[..., 0], truth[..., 1], truth[..., 2]
        x = x + v_true * torch.cos(yaw) * dt
        y = y + v_true * torch.sin(yaw) * dt
        yaw = yaw + w_true * dt
        truth = torch.stack([x, y, yaw, torch.full_like(x, v_true)], dim=-1)

        kf = ks[k]
        control = torch.stack(
            [
                v_true + deterministic_noise(kf, 0.12, 0.2 + offset),
                w_true + deterministic_noise(kf, 0.04, 1.0 + offset),
            ],
            dim=-1,
        )
        z = torch.stack(
            [
                x + deterministic_noise(kf, 0.6, 2.0 + offset),
                y + deterministic_noise(kf, 0.6, 2.7 + offset),
            ],
            dim=-1,
        )
        belief = filter_step(belief, z, control, dt, q, r, model)
        trace["truth"].append(truth)
        trace["estimate"].append(belief.mean)
        trace["measurement"].append(z)
        trace["cov"].append(belief.cov)

    # time goes after the batch axes
    out = {name: torch.stack(v, dim=len(batch_shape)) for name, v in trace.items()}
    out["final_mean"] = belief.mean
    out["final_cov"] = belief.cov
    return out
