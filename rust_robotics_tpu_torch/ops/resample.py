"""Fused systematic resampling + particle gather: kernels B3a/B3b and twin.

The port of rust_robotics_tpu/ops/resample_pallas.py, with its entry's
name, layout and outputs. `systematic_resample_gather(weights, u, states)`
resamples B independent particle filters: weights [B, P] (unnormalised),
one stratified uniform per row u [B], states [B, D, P] -> (new states
[B, D, P], parent indices [B, P] int32, N_eff [B]).

- On CUDA tensors it launches the hand-written kernel `csrc/resample.cu`,
  or raises: one block per row stages the row's weights and states into
  shared memory (TMA bulk copies, or cp.async where rows are not 16-byte
  aligned) and builds the CDF by a register scan while the states land;
  each particle then marks the first slot past its CDF value, a running
  maximum over the marks gives every slot's index, and the states are
  gathered from shared memory. Rows too large for a block's shared memory
  gather from global memory. `_launch_plan` picks the block size and the
  branch. The JAX package's two Pallas kernels (P <= 1024, and P > 1024 in
  512-wide tiles) become this one kernel.
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
import functools
from typing import NamedTuple

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.ops import _build

_TILE_P = 512  # the JAX entry's tile: P > 1024 must be a multiple of it

_I = ctypes.c_int
_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [_I] * 8 + [ctypes.c_void_p], _I)
_KERNELS = {torch.float32: "resample_f32", torch.float64: "resample_f64"}
_SIGNATURES = {name: _SIGNATURE for name in _KERNELS.values()}

# The kernel's branches (csrc/resample.cu `Mode`)
STAGED, COPIED, DIRECT = 0, 1, 2
MAX_THREADS = 512  # a block at most: two rows of P = 4096 share an SM
RUN = 4  # elements a thread owns at least: one 16-byte vector of f32
# static shared memory beside the dynamic part: two mbarriers and three
# arrays of 32 warp totals (656 B in f64), rounded up
STATIC_SHARED_BYTES = 1024


class LaunchPlan(NamedTuple):
    threads: int  # per block, a multiple of 32
    run: int  # contiguous elements and output slots a thread owns
    mode: int  # STAGED, COPIED or DIRECT
    shared_bytes: int  # dynamic shared memory a block
    vector_stores: bool  # 16-byte stores of idx


@functools.lru_cache(maxsize=256)
def _launch_plan(p, d, dtype, aligned=True):
    """The kernel's launch for rows of P particles with D state channels of
    `dtype`, one block a row; `aligned`: the weights' and states' pointers
    are 16-byte aligned. Raises ValueError where a row's weights exceed a
    block's shared memory.

    - threads: P/4 rounded up to a warp, at most 512, so a thread owns a
      run of 4 (P <= 2048) or more (8 at P = 4096, where two blocks of 96 KB
      share an SM), a multiple of 4;
    - STAGED (TMA bulk copies) where the weights, the int32 marks and the
      states fit in shared memory and every row starts 16-byte aligned,
      COPIED (cp.async of 4 or 8 bytes) where they fit but do not align
      (P = 1001 f32), DIRECT (the marks in the idx output, the states
      gathered from global memory) where they do not fit (f64 at D=8,
      P=4096: 304 KB);
    - 16-byte stores of idx where rows are 16-byte aligned."""
    size = torch.empty((), dtype=dtype).element_size()
    weight_bytes = -(-p * size // 16) * 16
    room = _build.SHARED_BYTES_PER_BLOCK - STATIC_SHARED_BYTES
    if weight_bytes > room:
        raise ValueError(f"P={p} {dtype} weights exceed one block's shared memory")
    threads = min(MAX_THREADS, max(-(-p // (32 * RUN)), 1) * 32)
    run = max(-(-p // (threads * RUN)), 1) * RUN
    rows_align = aligned and p * size % 16 == 0
    staged_bytes = weight_bytes + -(-p * 4 // 16) * 16 + d * p * size  # weights, marks, states
    if staged_bytes > room:
        return LaunchPlan(threads, run, DIRECT, weight_bytes, rows_align)
    return LaunchPlan(threads, run, STAGED if rows_align else COPIED, staged_bytes, rows_align)


@functools.cache
def _launcher(dtype):
    return getattr(_build.load("resample", _SIGNATURES), _KERNELS[dtype])


def _check(weights, u, states):
    """Validate the operands; returns (B, P, D)."""
    tensors = (("weights", weights), ("u", u), ("states", states))
    for name, x in tensors:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if weights.ndim != 2:
        raise ValueError(f"weights must be [B, P], got {tuple(weights.shape)}")
    b, p = weights.shape
    if u.shape != (b,):
        raise ValueError(f"u must be [{b}], got {tuple(u.shape)}")
    if states.ndim != 3 or states.shape[0] != b or states.shape[2] != p:
        raise ValueError(f"states must be [{b}, D, {p}], got {tuple(states.shape)}")
    if p > 1024 and p % _TILE_P:
        raise ValueError(f"tiled resample needs P % {_TILE_P} == 0, got {p}")
    dtype, device = weights.dtype, weights.device
    if u.dtype != dtype or states.dtype != dtype:
        raise TypeError(f"mixed dtypes: { {k: x.dtype for k, x in tensors} }")
    if dtype not in _KERNELS:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if u.device != device or states.device != device:
        raise ValueError(f"mixed devices: { {k: str(x.device) for k, x in tensors} }")
    if not (weights.is_contiguous() and u.is_contiguous() and states.is_contiguous()):
        name = next(k for k, x in tensors if not x.is_contiguous())
        raise ValueError(f"{name} must be contiguous")
    return b, p, states.shape[1]


def systematic_resample_gather(weights, u, states):
    """Fused systematic resampling for B independent particle filters.

    weights [B, P] (unnormalised, non-negative), u [B] in [0, 1), states
    [B, D, P], one dtype (float32 or float64), one device, contiguous.
    Returns (new_states [B, D, P], parent_idx [B, P] int32, neff [B]).
    """
    b, p, d = _check(weights, u, states)
    device = weights.device
    if device.type == "cpu":
        return systematic_resample_gather_plain(weights, u, states)
    if device.type != "cuda":
        raise ValueError(f"systematic_resample_gather runs on cuda or cpu, not {device}")
    w_ptr, s_ptr = weights.data_ptr(), states.data_ptr()
    plan = _launch_plan(p, d, weights.dtype, not (w_ptr | s_ptr) & 15)
    out = torch.empty_like(states)
    idx = torch.empty((b, p), dtype=torch.int32, device=device)
    neff = torch.empty((b,), dtype=weights.dtype, device=device)
    if b == 0 or p == 0:
        return out, idx, neff
    err = _launcher(weights.dtype)(
        w_ptr, u.data_ptr(), s_ptr, out.data_ptr(), idx.data_ptr(), neff.data_ptr(), b, p, d,
        plan.threads, plan.run, plan.mode, plan.shared_bytes, plan.vector_stores, device.index,
        torch._C._cuda_getCurrentRawStream(device.index))  # current_stream() builds a Stream
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
    pos = true_div(torch.arange(p, dtype=weights.dtype, device=weights.device) + u[:, None], p)
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
