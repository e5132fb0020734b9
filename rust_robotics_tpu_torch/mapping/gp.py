"""Gaussian-process occupancy/terrain regression.

The port of rust_robotics_tpu/mapping/gp.py. Reference:
crates/rust_robotics_mapping/src/gaussian_process.rs (193 LoC): RBF kernel
GP regression with predictive mean + variance.

The kernel matrix is one matmul and the solve a Cholesky on [N, N]. As in
the JAX package, the factor's two solves are general solves (LU,
`solve_ex`, with no error check and so no device read), and the float32
products run at full precision (`full_fp32_matmul`, TF32 off).
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.nlls.tridiag import full_fp32_matmul


def rbf_kernel(a, b, length_scale=1.0, signal_var=1.0):
    """k(a, b) = σ² exp(−|a−b|²/(2ℓ²)); a [N, d], b [M, d] -> [N, M]."""
    with full_fp32_matmul():
        d2 = torch.sum(a**2, dim=-1, keepdim=True) + torch.sum(b**2, dim=-1) - 2.0 * a @ b.T
    return signal_var * torch.exp(true_div(-0.5 * d2, length_scale**2))


def gp_regression(train_x, train_y, query_x, length_scale=1.0, signal_var=1.0,
                  noise_var=1e-2):
    """Predictive (mean [M], variance [M]) at query_x."""
    with full_fp32_matmul():
        k = rbf_kernel(train_x, train_x, length_scale, signal_var)
        k = k + noise_var * torch.eye(train_x.shape[0], dtype=k.dtype, device=k.device)
        l = torch.linalg.cholesky_ex(k).L
        lt = l.T
        alpha = torch.linalg.solve_ex(lt, torch.linalg.solve_ex(l, train_y).result).result
        ks = rbf_kernel(train_x, query_x, length_scale, signal_var)  # [N, M]
        mean = ks.T @ alpha
        v = torch.linalg.solve_ex(l, ks).result
    var = signal_var - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=0.0)
