"""The fused EKF scan: the port's plain twin against the JAX kernel (run in
interpret mode, as tests/test_ekf_pallas.py runs it) and against both
packages' `ekf_scan_reference`, on the same numpy inputs made from a seed;
then the wrapper's routing and input checks.

Tolerances: f64 at 1e-12, the class of tests/test_ekf_pallas.py. f32 at
2e-5 for T=20 (that file's f32 class). For T=200 on bench-like inputs
(z ≈ 10, yaw₀ = π/2), f32 at 1e-4 on the mean and 1e-5 on the cov: the
twin and the JAX kernel differ there by 7.4e-6 and 1.1e-7 at most.

The CUDA kernel itself runs only on the card: its test skips without one,
and chip_smoke.py holds it to the twin at the full main-path width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.ops import ekf_pallas
from rust_robotics_tpu_torch.ops import ekf_scan

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

Q = (0.01, 0.01, 3e-4, 0.01)
R = (1.0, 1.0)
DT = 0.1
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def make_inputs(t, b, dtype, bench_like, seed=0):
    """Lane-major zs, us [T, 2, B], mean0 [4, B], cov0 [16, B] (numpy).
    bench_like: z ≈ 10 + 0.3·N and yaw₀ = π/2 as bench.py; otherwise
    z ≈ 0.3·N from a zero mean, as tests/test_ekf_pallas.py."""
    rng = np.random.default_rng(seed)
    zs = 0.3 * rng.standard_normal((t, 2, b)) + (10.0 if bench_like else 0.0)
    us = np.stack([1.0 + 0.1 * rng.standard_normal((t, b)), np.full((t, b), 0.1)], axis=1)
    mean0 = np.zeros((4, b))
    if bench_like:
        mean0[2] = np.pi / 2
    cov0 = np.repeat(np.eye(4).reshape(16, 1), b, axis=1)
    return tuple(a.astype(dtype) for a in (zs, us, mean0, cov0))


def torch_args(arrays, dtype):
    return tuple(torch.from_numpy(a).to(TORCH[dtype]) for a in arrays)


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0.0)


CASES = [
    # (T, B, dtype, bench_like, atol mean, atol cov)
    (20, 256, np.float32, False, 2e-5, 2e-5),
    (20, 256, np.float64, False, 1e-12, 1e-12),
    (200, 512, np.float32, True, 1e-4, 1e-5),
    (200, 512, np.float64, True, 1e-12, 1e-12),
]


@pytest.mark.parametrize("t,b,dtype,bench_like,atol_m,atol_p", CASES)
def test_plain_matches_jax_kernel_and_reference(t, b, dtype, bench_like, atol_m, atol_p):
    arrays = make_inputs(t, b, dtype, bench_like)
    got_m, got_p = ekf_scan.ekf_scan_plain(*torch_args(arrays, dtype), DT, Q, R)
    assert got_m.dtype == TORCH[dtype] and got_m.shape == (4, b) and got_p.shape == (16, b)
    jax_args = tuple(jnp.asarray(a) for a in arrays)
    kern_m, kern_p = ekf_pallas.ekf_scan_lanes(*jax_args, DT, Q, R, tile=128, interpret=True)
    ref_m, ref_p = ekf_pallas.ekf_scan_reference(*jax_args, DT, Q, R)
    close(got_m, kern_m, atol_m)
    close(got_p, kern_p, atol_p)
    close(got_m, ref_m, atol_m)
    close(got_p, ref_p, atol_p)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 2e-5)])
def test_port_reference_matches_plain(dtype, atol):
    args = torch_args(make_inputs(50, 96, dtype, bench_like=True, seed=3), dtype)
    ref_m, ref_p = ekf_scan.ekf_scan_reference(*args, DT, Q, R)
    got_m, got_p = ekf_scan.ekf_scan_plain(*args, DT, Q, R)
    close(got_m, ref_m.numpy(), atol)
    close(got_p, ref_p.numpy(), atol)


def test_wrapper_on_cpu_runs_the_twin_without_launching():
    args = torch_args(make_inputs(12, 33, np.float64, bench_like=True, seed=4), np.float64)
    before = ekf_scan.ekf_scan_lanes.launches
    got = ekf_scan.ekf_scan_lanes(*args, DT, Q, R)
    want = ekf_scan.ekf_scan_plain(*args, DT, Q, R)
    assert ekf_scan.ekf_scan_lanes.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a diagonal matrix is taken for its diagonal
    again = ekf_scan.ekf_scan_lanes(*args, DT, np.diag(Q), torch.eye(2, dtype=torch.float64))
    for g, w in zip(again, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_bad_inputs():
    zs, us, mean0, cov0 = torch_args(make_inputs(4, 8, np.float32, bench_like=True), np.float32)
    dense_q = np.diag(Q) + 1e-3 * (np.ones((4, 4)) - np.eye(4))
    with pytest.raises(ValueError, match="diagonal"):
        ekf_scan.ekf_scan_lanes(zs, us, mean0, cov0, DT, dense_q, R)
    with pytest.raises(ValueError, match="diagonal"):
        ekf_scan.ekf_scan_lanes(zs, us, mean0, cov0, DT, Q[:3], R)
    with pytest.raises(ValueError, match="contiguous"):
        ekf_scan.ekf_scan_lanes(zs, us, mean0.T.contiguous().T, cov0, DT, Q, R)
    with pytest.raises(TypeError, match="mixed dtypes"):
        ekf_scan.ekf_scan_lanes(zs, us.double(), mean0, cov0, DT, Q, R)
    with pytest.raises(TypeError, match="float32 or float64"):
        ekf_scan.ekf_scan_lanes(*(x.half() for x in (zs, us, mean0, cov0)), DT, Q, R)
    with pytest.raises(ValueError, match="must be"):
        ekf_scan.ekf_scan_lanes(zs, us[:, :, :5], mean0, cov0, DT, Q, R)
    with pytest.raises(ValueError, match="must be"):
        ekf_scan.ekf_scan_lanes(zs[:, :1], us, mean0, cov0, DT, Q, R)
    with pytest.raises(ValueError, match="mixed devices"):
        ekf_scan.ekf_scan_lanes(zs, us, mean0, cov0.to("meta"), DT, Q, R)
    meta = tuple(x.to("meta") for x in (zs, us, mean0, cov0))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ekf_scan.ekf_scan_lanes(*meta, DT, Q, R)


@pytest.mark.cuda
def test_kernel_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    for dtype, atol_m, atol_p in ((np.float64, 1e-12, 1e-12), (np.float32, 1e-4, 1e-5)):
        args = tuple(x.cuda() for x in torch_args(make_inputs(200, 1031, dtype, True), dtype))
        before = ekf_scan.ekf_scan_lanes.launches
        got = ekf_scan.ekf_scan_lanes(*args, DT, Q, R)
        want = ekf_scan.ekf_scan_plain(*args, DT, Q, R)
        torch.cuda.synchronize()
        assert ekf_scan.ekf_scan_lanes.launches == before + 1
        close(got[0].cpu(), want[0].cpu().numpy(), atol_m)
        close(got[1].cpu(), want[1].cpu().numpy(), atol_p)
