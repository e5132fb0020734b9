"""Fused batched EKF scan (unicycle + GPS-position model): kernel and twin.

The port of rust_robotics_tpu/ops/ekf_pallas.py. `ekf_scan_lanes` runs T
EKF predict+update steps for B independent filters in the JAX kernel's
layout: zs/us [T, 2, B], mean [4, B], cov [16, B] (row-major 4×4), batch on
the last axis.

- On CUDA tensors it launches the hand-written kernel `csrc/ekf_scan.cu`
  (one thread per filter, the belief in registers for all T steps), or
  raises. It never falls back.
- On CPU tensors it runs `ekf_scan_plain`, the kernel's plain-PyTorch twin:
  the same arithmetic, operation by operation, over [B]-vectors.
- `ekf_scan_reference` is the same computation through the generic filter
  path (`filters.kalman.ekf_step`), the oracle both are held to.

`ekf_scan_lanes.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rust_robotics_tpu_torch.ops import _build

_P = ctypes.c_void_p
_D = ctypes.c_double
_SIGNATURE = ([_P] * 6 + [ctypes.c_int, ctypes.c_longlong] + [_D] * 7 + [_P], ctypes.c_int)
_KERNELS = {torch.float32: "ekf_scan_f32", torch.float64: "ekf_scan_f64"}


def _diagonal(name, value, n):
    """A noise model given as its n diagonal entries or as an n×n diagonal
    matrix -> tuple of n floats. Raises on anything else."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value, dtype=np.float64)
    if arr.shape == (n, n):
        if np.any(arr != np.diag(np.diag(arr))):
            raise ValueError(f"{name} must be diagonal; got off-diagonal entries")
        arr = np.diag(arr)
    if arr.shape != (n,):
        raise ValueError(f"{name} must hold {n} diagonal entries, got shape {arr.shape}")
    return tuple(float(x) for x in arr)


def _check_lanes(zs, us, mean0, cov0):
    """Validate the lane-major operands; returns (T, B)."""
    tensors = {"zs": zs, "us": us, "mean0": mean0, "cov0": cov0}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if zs.ndim != 3 or zs.shape[1] != 2:
        raise ValueError(f"zs must be [T, 2, B], got {tuple(zs.shape)}")
    t, _, b = zs.shape
    expected = {"us": (t, 2, b), "mean0": (4, b), "cov0": (16, b)}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(tensors[name].shape)}")
    if len({x.dtype for x in tensors.values()}) != 1:
        raise TypeError(f"mixed dtypes: { {k: x.dtype for k, x in tensors.items()} }")
    if zs.dtype not in _KERNELS:
        raise TypeError(f"dtype must be float32 or float64, got {zs.dtype}")
    if len({x.device for x in tensors.values()}) != 1:
        raise ValueError(f"mixed devices: { {k: str(x.device) for k, x in tensors.items()} }")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return t, b


def ekf_scan_lanes(zs, us, mean0, cov0, dt, q_diag, r_diag):
    """Run T fused EKF steps for B filters; returns (mean [4, B], cov [16, B]).

    zs/us [T, 2, B]; mean0 [4, B]; cov0 [16, B] (row-major 4×4), one dtype
    (float32 or float64), one device, contiguous. q_diag (4) and r_diag (2)
    are the diagonals of Q and R (a diagonal matrix is accepted too).
    """
    q = _diagonal("q_diag", q_diag, 4)
    r = _diagonal("r_diag", r_diag, 2)
    t, b = _check_lanes(zs, us, mean0, cov0)
    if zs.device.type == "cpu":
        return ekf_scan_plain(zs, us, mean0, cov0, dt, q, r)
    if zs.device.type != "cuda":
        raise ValueError(f"ekf_scan_lanes runs on cuda or cpu, not {zs.device}")
    mean = torch.empty_like(mean0)
    cov = torch.empty_like(cov0)
    if b == 0:
        return mean, cov
    lib = _build.load("ekf_scan", {name: _SIGNATURE for name in _KERNELS.values()})
    kernel = getattr(lib, _KERNELS[zs.dtype])
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            zs.data_ptr(), us.data_ptr(), mean0.data_ptr(), cov0.data_ptr(),
            mean.data_ptr(), cov.data_ptr(), t, b, float(dt), *q, *r, stream,
        )
    if err != 0:
        raise RuntimeError(f"ekf_scan kernel launch failed with CUDA error {err}")
    ekf_scan_lanes.launches += 1
    return mean, cov


ekf_scan_lanes.launches = 0


def ekf_scan_plain(zs, us, mean0, cov0, dt, q_diag, r_diag):
    """The kernel's plain-PyTorch twin: the same arithmetic in the same
    order (ekf_pallas.py:35-106), each scalar of the 4×4 algebra a
    [B]-vector. Same layout and arguments as `ekf_scan_lanes`."""
    m = [mean0[i] for i in range(4)]
    p = [[cov0[4 * i + j] for j in range(4)] for i in range(4)]
    zero = torch.zeros_like(mean0[0])
    for t in range(zs.shape[0]):
        v_u, om = us[t, 0], us[t, 1]
        z0, z1 = zs[t, 0], zs[t, 1]

        # predict mean (ekf.rs:203-212)
        cos_yaw = torch.cos(m[2])
        sin_yaw = torch.sin(m[2])
        x0 = m[0] + dt * v_u * cos_yaw
        x1 = m[1] + dt * v_u * sin_yaw
        x2 = m[2] + dt * om
        x3 = v_u

        # F evaluated at the PREDICTED state (ekf.rs:318-321)
        f02 = -dt * v_u * torch.sin(x2)
        f12 = dt * v_u * torch.cos(x2)

        # A = F P  (rows: 0 += f02·row2; 1 += f12·row2; 3 = 0)
        a = [
            [p[0][j] + f02 * p[2][j] for j in range(4)],
            [p[1][j] + f12 * p[2][j] for j in range(4)],
            [p[2][j] for j in range(4)],
            [zero] * 4,
        ]
        # P' = A Fᵀ + Q  (cols: 0 += f02·col2; 1 += f12·col2; 3 = 0)
        pp = [[a[i][0] + f02 * a[i][2], a[i][1] + f12 * a[i][2], a[i][2], zero]
              for i in range(3)]
        pp.append([zero] * 4)
        for i in range(4):
            pp[i][i] = pp[i][i] + q_diag[i]

        # update: S = P'[0:2,0:2] + R, closed-form 2×2 inverse
        s00 = pp[0][0] + r_diag[0]
        s01 = pp[0][1]
        s10 = pp[1][0]
        s11 = pp[1][1] + r_diag[1]
        inv_det = 1.0 / (s00 * s11 - s01 * s10)
        i00 = s11 * inv_det
        i01 = -s01 * inv_det
        i10 = -s10 * inv_det
        i11 = s00 * inv_det

        # K = P'[:, 0:2] @ S⁻¹ ([4, 2])
        k = [(pp[i][0] * i00 + pp[i][1] * i10, pp[i][0] * i01 + pp[i][1] * i11)
             for i in range(4)]
        y0 = z0 - x0
        y1 = z1 - x1
        m = [
            x0 + k[0][0] * y0 + k[0][1] * y1,
            x1 + k[1][0] * y0 + k[1][1] * y1,
            x2 + k[2][0] * y0 + k[2][1] * y1,
            x3 + k[3][0] * y0 + k[3][1] * y1,
        ]
        # P = (I − K H) P' = P' − K · P'[0:2, :]
        p = [[pp[i][j] - k[i][0] * pp[0][j] - k[i][1] * pp[1][j] for j in range(4)]
             for i in range(4)]
    mean = torch.stack(m)
    cov = torch.stack([p[i][j] for i in range(4) for j in range(4)])
    return mean, cov


def ekf_scan_reference(zs, us, mean0, cov0, dt, q_diag, r_diag):
    """The same computation through the generic filter path, one
    `filters.kalman.ekf_step` per step (ekf_pallas.py:151-170). Same
    lane-major layout in and out."""
    from rust_robotics_tpu_torch.convert import belief_from_lanes, belief_to_lanes
    from rust_robotics_tpu_torch.filters.kalman import ekf_step

    like = dict(dtype=zs.dtype, device=zs.device)
    q = torch.diag(torch.tensor(_diagonal("q_diag", q_diag, 4), **like))
    r = torch.diag(torch.tensor(_diagonal("r_diag", r_diag, 2), **like))
    belief = belief_from_lanes(mean0, cov0)
    for t in range(zs.shape[0]):
        belief = ekf_step(belief, zs[t].T, us[t].T, dt, q, r)
    return belief_to_lanes(belief)
