"""Fused systematic resampling + particle gather: kernels B3a/B3b and twin.

The port of rust_robotics_tpu/ops/resample_pallas.py, with its entry's
name, layout and outputs. `systematic_resample_gather(weights, u, states)`
resamples B independent particle filters: weights [B, P] (unnormalised),
one stratified uniform per row u [B], states [B, D, P] -> (new states
[B, D, P], parent indices [B, P] int32, N_eff [B]).

- On CUDA tensors it launches the hand-written kernel `csrc/resample.cu`
  (one block per row: block reductions, a block scan for the CDF, a binary
  search per output slot, a direct gather), or raises. The JAX package's
  two Pallas kernels (P <= 1024, and P > 1024 in 512-wide tiles) become
  this one kernel.
- On CPU tensors it runs `systematic_resample_gather_plain`, the twin:
  sum, N_eff, cumsum, searchsorted and gather in plain PyTorch.
- `resample_reference` is the same function through the particle filter's
  own inverse-CDF draw (`filters.particle.inverse_cdf`), the oracle.

The entry keeps the JAX entry's contract: a P above 1024 must be a multiple
of 512, or it raises `ValueError`, so both packages take the same inputs.
`systematic_resample_gather.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from rust_robotics_tpu_torch.ops import _build

_TILE_P = 512  # the JAX entry's tile: P > 1024 must be a multiple of it

_P = ctypes.c_void_p
_SIGNATURE = ([_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int)
_KERNELS = {torch.float32: "resample_f32", torch.float64: "resample_f64"}


def _check(weights, u, states):
    """Validate the operands; returns (B, P, D)."""
    tensors = {"weights": weights, "u": u, "states": states}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if weights.ndim != 2:
        raise ValueError(f"weights must be [B, P], got {tuple(weights.shape)}")
    b, p = weights.shape
    if tuple(u.shape) != (b,):
        raise ValueError(f"u must be [{b}], got {tuple(u.shape)}")
    if states.ndim != 3 or states.shape[0] != b or states.shape[2] != p:
        raise ValueError(f"states must be [{b}, D, {p}], got {tuple(states.shape)}")
    if p > 1024 and p % _TILE_P:
        raise ValueError(f"tiled resample needs P % {_TILE_P} == 0, got {p}")
    if len({x.dtype for x in tensors.values()}) != 1:
        raise TypeError(f"mixed dtypes: { {k: x.dtype for k, x in tensors.items()} }")
    if weights.dtype not in _KERNELS:
        raise TypeError(f"dtype must be float32 or float64, got {weights.dtype}")
    if len({x.device for x in tensors.values()}) != 1:
        raise ValueError(f"mixed devices: { {k: str(x.device) for k, x in tensors.items()} }")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, p, states.shape[1]


def systematic_resample_gather(weights, u, states):
    """Fused systematic resampling for B independent particle filters.

    weights [B, P] (unnormalised, non-negative), u [B] in [0, 1), states
    [B, D, P], one dtype (float32 or float64), one device, contiguous.
    Returns (new_states [B, D, P], parent_idx [B, P] int32, neff [B]).
    """
    b, p, d = _check(weights, u, states)
    if weights.device.type == "cpu":
        return systematic_resample_gather_plain(weights, u, states)
    if weights.device.type != "cuda":
        raise ValueError(f"systematic_resample_gather runs on cuda or cpu, not {weights.device}")
    if p * weights.element_size() > _build.SHARED_BYTES_PER_BLOCK:  # the row's CDF
        raise ValueError(f"P={p} {weights.dtype} weights exceed one block's shared memory")
    out = torch.empty_like(states)
    idx = torch.empty((b, p), dtype=torch.int32, device=weights.device)
    neff = torch.empty((b,), dtype=weights.dtype, device=weights.device)
    if b == 0 or p == 0:
        return out, idx, neff
    lib = _build.load("resample", {name: _SIGNATURE for name in _KERNELS.values()})
    kernel = getattr(lib, _KERNELS[weights.dtype])
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(weights.data_ptr(), u.data_ptr(), states.data_ptr(), out.data_ptr(),
                     idx.data_ptr(), neff.data_ptr(), b, p, d, stream)
    if err != 0:
        raise RuntimeError(f"resample kernel launch failed with CUDA error {err}")
    systematic_resample_gather.launches += 1
    return out, idx, neff


systematic_resample_gather.launches = 0


def systematic_resample_gather_plain(weights, u, states):
    """The kernel's plain-PyTorch twin, in the order of operations of
    resample_pallas.py:337-341. Same arguments and results as
    `systematic_resample_gather`."""
    _, p, d = _check(weights, u, states)
    wn = weights / torch.sum(weights, dim=-1, keepdim=True)
    neff = 1.0 / torch.sum(wn * wn, dim=-1)
    cum = torch.cumsum(wn, dim=-1)
    cum = cum / cum[..., -1:]
    pos = (torch.arange(p, dtype=weights.dtype, device=weights.device) + u[:, None]) / p
    idx = torch.searchsorted(cum, pos, side="left").clamp(0, p - 1)
    new_states = torch.gather(states, 2, idx[:, None, :].expand(-1, d, -1))
    return new_states, idx.to(torch.int32), neff


def resample_reference(weights, u, states):
    """The same function through the particle filter's generic draw
    (`filters.particle.inverse_cdf`): the oracle both are held to."""
    from rust_robotics_tpu_torch.filters.particle import inverse_cdf, systematic_positions

    _check(weights, u, states)
    wn = weights / torch.sum(weights, dim=-1, keepdim=True)
    neff = 1.0 / torch.sum(wn * wn, dim=-1)
    idx = inverse_cdf(wn, systematic_positions(u[:, None], weights.shape[-1]))
    return torch.take_along_dim(states, idx[:, None, :], dim=2), idx.to(torch.int32), neff
