"""Blocked Cholesky factorisation: kernels B4/B5 and their twin.

The port of rust_robotics_tpu/ops/cholesky_pallas.py, which the Schur path
of the NLLS solver reaches for the retained (camera) system
(`nlls/solver.py::_reduced_solve`). Each entry returns the lower factor L
[n, n] of an SPD matrix a [n, n] with the strict upper triangle exactly 0,
padding a to a multiple of `BLOCK` with an identity diagonal and taking each
pivot p as 1/sqrt(max(p, 1e-30)), as the JAX kernel does; the caller's
tensor is not written.

- `cholesky_blocked(a)` (B4, `cholesky_pallas`) and
  `cholesky_blocked_large(a)` (B5, `cholesky_pallas_large`): on CUDA
  tensors they launch the hand-written kernel of `csrc/cholesky.cu` (one
  persistent cooperative launch per factorisation; per block step one CTA
  factors the diagonal block, all CTAs solve the panel by forward
  substitution, then an FP32/FP64 FMA trailing update of the lower tiles,
  the phases separated by grid barriers), or raise; on CPU tensors they
  run the twin.
- `cholesky_solve_blocked(a, b)` (`cholesky_solve_pallas`): the factor,
  then two triangular solves, which run outside the kernel in JAX too.
- `cholesky_blocked_plain(a)`: the twin, the same blocked right-looking
  algorithm in plain PyTorch with the same padding, clamp and zeroed upper
  triangle. It states the kernels' semantics; the tests and the on-card
  comparison use it.

`cholesky_blocked.launches` and `cholesky_blocked_large.launches` count
kernel launches (one per factorisation). `cholesky_phase_stamps(a)` runs
the same kernel with its phase clock on, for measurement; it is not
counted.
"""

from __future__ import annotations

import ctypes

import torch

from rust_robotics_tpu_torch.ops import _build

BLOCK = 64  # the block width of csrc/cholesky.cu (checked when it loads)
PIVOT_FLOOR = 1e-30  # cholesky_pallas.py:75

_P = ctypes.c_void_p
_SIGNATURES = {
    "cholesky_f32": ([_P, _P, _P, ctypes.c_int, _P], ctypes.c_int),
    "cholesky_f64": ([_P, _P, _P, ctypes.c_int, _P], ctypes.c_int),
    "cholesky_f32_traced": ([_P, _P, _P, ctypes.c_int, _P, _P], ctypes.c_int),
    "cholesky_f64_traced": ([_P, _P, _P, ctypes.c_int, _P, _P], ctypes.c_int),
    "cholesky_block_size": ([], ctypes.c_int),
    "cholesky_work_elements": ([ctypes.c_int], ctypes.c_longlong),
    "cholesky_stamp_count": ([ctypes.c_int], ctypes.c_int),
    "cholesky_error_name": ([ctypes.c_int], ctypes.c_char_p),
}
_KERNELS = {torch.float32: "cholesky_f32", torch.float64: "cholesky_f64"}


def _check(a):
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"a must be a torch.Tensor, got {type(a).__name__}")
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square [n, n], got {tuple(a.shape)}")
    if a.dtype not in _KERNELS:
        raise TypeError(f"dtype must be float32 or float64, got {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the blocked Cholesky runs on cuda or cpu, not {a.device}")
    return a.shape[0]


def _padded(a):
    """a padded to a multiple of BLOCK with an identity diagonal (a copy)."""
    n = a.shape[0]
    m = -(-n // BLOCK) * BLOCK
    work = torch.zeros((m, m), dtype=a.dtype, device=a.device)
    work[:n, :n] = a
    pad = torch.arange(n, m, device=a.device)
    work[pad, pad] = 1.0
    return work


def _factor_diag_plain(d):
    """Lower factor of one diagonal block, one column per step
    (cholesky_pallas.py:61-87)."""
    a = d.clone()
    out = torch.zeros_like(d)
    for j in range(d.shape[0]):
        inv = 1.0 / torch.sqrt(torch.clamp(a[j, j], min=PIVOT_FLOOR))
        col = a[j:, j] * inv
        out[j:, j] = col
        a[j + 1:, j + 1:] -= torch.outer(col[1:], col[1:])
    return out


def cholesky_blocked_plain(a):
    """The kernels' twin: blocked right-looking Cholesky in plain PyTorch,
    block width BLOCK. For each block step: factor the diagonal block,
    solve the panel X·L_kkᵀ = A_ik, subtract P·Pᵀ from the trailing
    matrix. Same arguments and result as `cholesky_blocked`."""
    n = _check(a)
    if n == 0:
        return a.new_zeros((0, 0))
    work = _padded(a)
    m = work.shape[0]
    for lo in range(0, m, BLOCK):
        hi = lo + BLOCK
        l_kk = _factor_diag_plain(work[lo:hi, lo:hi])
        work[lo:hi, lo:hi] = l_kk
        if hi < m:
            panel = torch.linalg.solve_triangular(l_kk.mT, work[hi:, lo:hi], upper=True,
                                                  left=False)
            work[hi:, lo:hi] = panel
            work[hi:, hi:] -= panel @ panel.mT
    return torch.tril(work)[:n, :n].contiguous()


def _launch(a, stamps=None):
    """One launch of csrc/cholesky.cu's kernel on CUDA tensor `a` (n > 0):
    L, raising on a refused launch. With `stamps` (int64, on a's device)
    the measuring entry fills it with the phase clock."""
    n = a.shape[0]
    lib = _build.load("cholesky", _SIGNATURES)
    if lib.cholesky_block_size() != BLOCK:
        raise RuntimeError(f"csrc/cholesky.cu uses blocks of {lib.cholesky_block_size()}, "
                           f"ops/cholesky.py of {BLOCK}")
    a = a.contiguous()
    out = torch.empty((n, n), dtype=a.dtype, device=a.device)
    work = torch.empty((lib.cholesky_work_elements(n),), dtype=a.dtype, device=a.device)
    name = _KERNELS[a.dtype]
    with torch.cuda.device(a.device):
        args = (a.data_ptr(), work.data_ptr(), out.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
        if stamps is None:
            err = getattr(lib, name)(*args)
        else:
            err = getattr(lib, f"{name}_traced")(*args, stamps.data_ptr())
    if err != 0:
        raise RuntimeError(f"cholesky kernel launch failed with CUDA error {err} "
                           f"({lib.cholesky_error_name(err).decode()})")
    return out


def _factor(a, entry):
    """The twin for a CPU tensor; for a CUDA tensor the kernel of
    csrc/cholesky.cu, counted on `entry.launches`."""
    n = _check(a)
    if a.device.type == "cpu":
        return cholesky_blocked_plain(a)
    if n == 0:
        return a.new_zeros((0, 0))
    out = _launch(a)
    entry.launches += 1
    return out


def cholesky_phase_stamps(a):
    """For measurement: factor CUDA tensor `a` as `cholesky_blocked` does,
    with the kernel's phase clock on. Returns (L, stamps): int64
    %globaltimer readings in ns from CTA 0 at the start, at the end of the
    first diagonal factor, after the barrier that follows it, then per
    block step with a panel: L_kk staged for the panel, CTA 0's panel rows
    done, after the panel's barrier, at the start and end of the next
    diagonal factor, after the step's last barrier. Not counted."""
    n = _check(a)
    if a.device.type != "cuda" or n == 0:
        raise ValueError("cholesky_phase_stamps measures the kernel: a non-empty CUDA tensor")
    lib = _build.load("cholesky", _SIGNATURES)
    stamps = torch.zeros(lib.cholesky_stamp_count(n), dtype=torch.int64, device=a.device)
    return _launch(a, stamps), stamps


def cholesky_blocked(a):
    """Lower Cholesky factor of SPD `a` [n, n] (float32 or float64): the
    kernels on a CUDA tensor, the twin on a CPU tensor."""
    return _factor(a, cholesky_blocked)


cholesky_blocked.launches = 0


def cholesky_blocked_large(a):
    """The counterpart of `cholesky_pallas_large`, which keeps the matrix in
    HBM and streams 128-wide panels through VMEM because a TPU core's
    VMEM cannot hold a large matrix. On this card every matrix lives in
    device memory and the kernels of `cholesky_blocked` already read their
    panels from there, so this entry runs those same kernels, and takes no
    `row_chunk`: the VMEM row buffer it sized does not exist here."""
    return _factor(a, cholesky_blocked_large)


cholesky_blocked_large.launches = 0


def cholesky_solve_blocked(a, b):
    """Solve SPD a·x = b (b [n] or [n, k]) via `cholesky_blocked` and two
    triangular solves."""
    l = cholesky_blocked(a)  # noqa: E741
    rhs = b[:, None] if b.ndim == 1 else b
    y = torch.linalg.solve_triangular(l, rhs, upper=False)
    x = torch.linalg.solve_triangular(l.mT, y, upper=True)
    return x[:, 0] if b.ndim == 1 else x
