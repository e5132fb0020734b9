"""System identification through the filter: the DP+TP training step.

The port of rust_robotics_tpu/train.py. Fit the process and measurement
noise of the unicycle + GPS model (diag Q = softplus(log_q)², diag R =
softplus(log_r)²) by gradient descent through a batched EKF rollout (the
innovation negative log-likelihood) plus a landmark-range term, on a
('data', 'model') mesh:

- the batch of trajectories is split over `data` (data parallel);
- the landmark table, and the range columns with it, over `model` (tensor
  parallel).

JAX writes the loss as one `shard_map` and lets `jax.grad` transpose its
psums. Here every rank differentiates its own share of the loss and the
shares meet in one all-reduce: rank (d, m) holds [m == 0]·Σ nll / B +
w·Σ lm / B, where Σ nll is its data shard's innovation NLL (the same on
every model rank, so only model rank 0 counts it, as JAX reduces it over
`data` only) and Σ lm its (data, model) block of the landmark term. The
loss is the sum of the shares over the world, and so is the gradient; one
all-reduce of [nll, lm, grads] carries both. Adam is optax's update, in
optax's order of operations.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.filters.kalman import (
    ekf_step_with_innovation,
    unicycle_position_model,
)
from rust_robotics_tpu_torch.ops.smallmat import det_small, solve_spd_small
from rust_robotics_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    local_shard,
    mesh_device,
    psum,
)


@dataclasses.dataclass(frozen=True)
class SysIdParams:
    """Unconstrained noise parameters: diag Q = softplus(log_q)², etc."""

    log_q: torch.Tensor  # [4]
    log_r: torch.Tensor  # [2]

    def tensors(self):
        return (self.log_q, self.log_r)


def init_params(dtype=torch.float32, device=None) -> SysIdParams:
    device = resolve_device(device)
    return SysIdParams(
        log_q=torch.log(torch.tensor([0.1, 0.1, 0.02, 0.1], dtype=dtype, device=device)),
        log_r=torch.log(torch.tensor([1.0, 1.0], dtype=dtype, device=device)),
    )


def _softplus(x):
    """log(1 + exp(x)) as `jax.nn.softplus` computes it (logaddexp(x, 0));
    torch's `F.softplus` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _noise_matrices(params: SysIdParams):
    return torch.diag(_softplus(params.log_q) ** 2), torch.diag(_softplus(params.log_r) ** 2)


def ekf_innovation_nll(params: SysIdParams, controls, measurements, init_mean, dt=0.1):
    """Innovation negative log-likelihood of a batched EKF rollout.

    controls [B, T, 2], measurements [B, T, 2], init_mean [B, 4]. Returns
    ½·Σ_t (yᵀS⁻¹y + log det S) per trajectory [B] and the filtered
    positions [B, T, 2]."""
    q, r = _noise_matrices(params)
    model = unicycle_position_model()
    cov0 = torch.eye(4, dtype=init_mean.dtype, device=init_mean.device).expand(
        *init_mean.shape[:-1], 4, 4)
    belief = GaussianBelief(init_mean, cov0)
    nll = torch.zeros(init_mean.shape[:-1], dtype=init_mean.dtype, device=init_mean.device)
    xy = []
    for t in range(controls.shape[-2]):
        belief, y, s = ekf_step_with_innovation(belief, measurements[..., t, :],
                                                controls[..., t, :], dt, q, r, model)
        sol = solve_spd_small(s, y[..., None])[..., 0]
        nll = nll + 0.5 * (torch.sum(y * sol, dim=-1)
                           + torch.log(torch.clamp(det_small(s), min=1e-30)))
        xy.append(belief.mean[..., :2])
    return nll, torch.stack(xy, dim=-2)


def landmark_range_sq_error(est_xy, landmarks, observed_ranges):
    """Σ over (T, L) of (‖xy − lm‖ − r_obs)² for a landmark shard.

    est_xy [..., T, 2], landmarks [L, 2], observed_ranges [..., T, L]."""
    d = torch.linalg.norm(est_xy[..., None, :] - landmarks, dim=-1)
    return torch.sum((d - observed_ranges) ** 2, dim=(-2, -1))


def shard_training_batch(mesh, controls, measurements, ranges, landmarks, init_mean):
    """This rank's shards of a global batch (JAX's in_specs): controls,
    measurements and init_mean by `data`; ranges [B, T, L] by `data` and
    `model`; landmarks [L, 2] by `model`."""
    return (local_shard(controls, mesh, "data"), local_shard(measurements, mesh, "data"),
            local_shard(local_shard(ranges, mesh, "data"), mesh, "model", dim=2),
            local_shard(landmarks, mesh, "model"), local_shard(init_mean, mesh, "data"))


def _local_terms(params, controls, measurements, ranges, landmarks, init_mean, mesh, dt):
    """This rank's [m == 0]·Σ nll and Σ lm (0-d tensors)."""
    nll, xy = ekf_innovation_nll(params, controls, measurements, init_mean, dt)
    nll_sum = torch.sum(nll) * (1.0 if axis_index(mesh, "model") == 0 else 0.0)
    return nll_sum, torch.sum(landmark_range_sq_error(xy, landmarks, ranges))


def make_loss_and_grad(mesh, dt=0.1, landmark_weight=0.01):
    """fn(params, *local shards) -> (loss, grads as SysIdParams), the same
    on every rank: one backward pass of the rank's share, one all-reduce
    over the world."""

    def loss_and_grad(params, controls, measurements, ranges, landmarks, init_mean):
        b_total = init_mean.shape[0] * axis_size(mesh, "data")
        leaves = [p.detach().requires_grad_(True) for p in params.tensors()]
        with torch.enable_grad():
            nll_sum, lm_sum = _local_terms(SysIdParams(*leaves), controls, measurements, ranges,
                                           landmarks, init_mean, mesh, dt)
            share = nll_sum / b_total + landmark_weight * lm_sum / b_total
            grads = torch.autograd.grad(share, leaves)
        packed = psum(torch.cat([nll_sum.detach()[None], lm_sum.detach()[None], *grads]), mesh,
                      ("data", "model"))
        loss = packed[0] / b_total + landmark_weight * packed[1] / b_total
        return loss, SysIdParams(packed[2:6], packed[6:8])

    return loss_and_grad


def make_loss(mesh, dt=0.1, landmark_weight=0.01):
    """fn(params, *local shards) -> the scalar loss, the same on every
    rank: Σ nll / B + w·Σ lm / B over the whole batch and landmark table."""

    def loss_fn(params, controls, measurements, ranges, landmarks, init_mean):
        b_total = init_mean.shape[0] * axis_size(mesh, "data")
        with torch.no_grad():
            nll_sum, lm_sum = _local_terms(params, controls, measurements, ranges, landmarks,
                                           init_mean, mesh, dt)
        packed = psum(torch.stack([nll_sum, lm_sum]), mesh, ("data", "model"))
        return packed[0] / b_total + landmark_weight * packed[1] / b_total

    return loss_fn


@dataclasses.dataclass(frozen=True)
class AdamState:
    """optax.adam's state: the step count and the two moments."""

    count: int
    mu: SysIdParams
    nu: SysIdParams


def adam_init(params: SysIdParams) -> AdamState:
    zeros = SysIdParams(*(torch.zeros_like(p) for p in params.tensors()))
    return AdamState(0, zeros, zeros)


def adam_update(params: SysIdParams, grads: SysIdParams, state: AdamState, learning_rate,
                b1=0.9, b2=0.999, eps=1e-8):
    """One `optax.adam` step (eps outside the root, eps_root 0), in optax's
    order: mu = (1 − b1)·g + b1·mu, nu = (1 − b2)·g² + b2·nu, the bias
    corrections 1 − b^t, u = −lr · mu_hat / (√nu_hat + eps), p + u."""
    count = state.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads.tensors(), state.mu.tensors())]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads.tensors(), state.nu.tensors())]
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = [p + (-learning_rate) * ((m / c1) / (torch.sqrt(v / c2) + eps))
           for p, m, v in zip(params.tensors(), mu, nu)]
    return SysIdParams(*new), AdamState(count, SysIdParams(*mu), SysIdParams(*nu))


def make_training_step(mesh, learning_rate=1e-2, dt=0.1, landmark_weight=0.01):
    """(init_fn, step_fn): init_fn(dtype) -> (params, opt_state) on this
    rank's device; step_fn(params, opt_state, *local shards) -> (params,
    opt_state, loss), an Adam step on the world's gradient, replicated."""
    loss_and_grad = make_loss_and_grad(mesh, dt=dt, landmark_weight=landmark_weight)

    def init_fn(dtype=torch.float32):
        params = init_params(dtype, mesh_device(mesh))
        return params, adam_init(params)

    def step_fn(params, opt_state, controls, measurements, ranges, landmarks, init_mean):
        loss, grads = loss_and_grad(params, controls, measurements, ranges, landmarks, init_mean)
        params, opt_state = adam_update(params, grads, opt_state, learning_rate)
        return params, opt_state, loss

    return init_fn, step_fn


def synthesize_batch(key, batch=8, steps=16, num_landmarks=16, dt=0.1, dtype=torch.float32,
                     device=None):
    """A synthetic dataset (JAX `synthesize_batch`) on `device` (default
    cuda), drawn from `key`: a seed, or a `torch.Generator` on that device.
    Returns (controls [B, T, 2], measurements [B, T, 2], ranges [B, T, L],
    landmarks [L, 2], init_mean [B, 4])."""
    device = resolve_device(device)
    generator = key
    if not isinstance(key, torch.Generator):
        generator = torch.Generator(device=device)
        generator.manual_seed(int(key))
    kw = dict(generator=generator, dtype=dtype, device=device)
    init_mean = torch.zeros((batch, 4), dtype=dtype, device=device)
    init_mean[:, 0] = torch.rand((batch,), **kw)
    controls = torch.stack([torch.ones((batch, steps), dtype=dtype, device=device),
                            torch.full((batch, steps), 0.1, dtype=dtype, device=device)], dim=-1)
    t = torch.arange(steps, dtype=dtype, device=device) * dt
    x = init_mean[:, :1] + t[None, :]
    y = torch.broadcast_to(0.05 * t[None, :] ** 2, x.shape)
    truth_xy = torch.stack([x, y], dim=-1)
    meas = truth_xy + 0.1 * torch.randn((batch, steps, 2), **kw)
    landmarks = 10.0 * torch.randn((num_landmarks, 2), **kw)
    ranges = torch.linalg.norm(truth_xy[:, :, None, :] - landmarks[None, None], dim=-1) \
        + 0.1 * torch.randn((batch, steps, num_landmarks), **kw)
    return controls, meas, ranges, landmarks, init_mean
