"""The whole slice: `slam.bundle_adjustment.bundle_adjust` of the port
against the JAX package's, on the two BA problems of the JAX tests (6
cameras x 40 points, tests/test_cholesky_pallas.py:47-73; 4 cameras x 24
points, tests/test_icp_ba.py:81-105), rebuilt from the same numpy seeds and
carried across with `convert.bundle_from_numpy`. Dense, and Schur with the
retained system solved by `reduced_solver` "dense" and "pallas_chol" (the
blocked Cholesky's twin here, JAX's Pallas kernel in interpret mode), f64
on the CPU. Held to: the same summary (termination, iterations, accepted
steps, linear iterations; costs at rtol 1e-9, atol 1e-12), cameras and
points within 1e-8, and a reprojection RMSE, computed in numpy, below
1e-6 px."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core.lie import se3_exp as j_se3_exp
from rust_robotics_tpu.core.lie import se3_log as j_se3_log
from rust_robotics_tpu.nlls import SolverConfig as JConfig
from rust_robotics_tpu.slam import bundle_adjustment as jba
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.nlls import SolverConfig as TConfig
from rust_robotics_tpu_torch.ops import cholesky
from rust_robotics_tpu_torch.slam import bundle_adjustment as tba

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def project(cams, points, cam_idx, pt_idx, fx, fy, cx, cy):
    inv = np.linalg.inv(np.asarray(cams))[cam_idx]
    pc = np.einsum("oij,oj->oi", inv[:, :3, :3], np.asarray(points)[pt_idx]) + inv[:, :3, 3]
    return np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)


def six_by_forty():
    """tests/test_cholesky_pallas.py:47-73: 6 cameras in a row 5 m behind 40
    points, the camera matrices themselves perturbed by 1e-3."""
    rng = np.random.default_rng(0)
    truth = np.stack([np.eye(4)] * 6)
    truth[:, 0, 3] = 0.5 * np.arange(6)
    truth[:, 2, 3] = -5.0
    pts = rng.uniform(-2, 2, (40, 3)) + np.array([0, 0, 3.0])
    cam_idx = np.repeat(np.arange(6), 40)
    pt_idx = np.tile(np.arange(40), 6)
    pixels = project(truth, pts, cam_idx, pt_idx, 500.0, 500.0, 320.0, 240.0)
    cams0 = truth + rng.normal(0, 1e-3, truth.shape)
    pts0 = pts + rng.normal(0, 0.05, pts.shape)
    return (cams0, pts0, cam_idx, pt_idx, pixels), (500.0, 500.0, 320.0, 240.0)


def four_by_twentyfour():
    """tests/test_icp_ba.py:81-114: 4 cameras, 24 points, the camera
    tangents and the points perturbed (the first camera stays fixed)."""
    points = np.random.default_rng(0).uniform(-1, 1, (24, 3)) + [0, 0, 5.0]
    tangents = np.array([[0.4 * i, 0.1 * i, 0.0, 0.0, 0.02 * i, 0.0] for i in range(4)])
    cams = np.asarray(j_se3_exp(jnp.asarray(tangents)))
    cam_idx = np.repeat(np.arange(4), 24)
    pt_idx = np.tile(np.arange(24), 4)
    pixels = project(cams, points, cam_idx, pt_idx, 400.0, 400.0, 320.0, 240.0)
    rng = np.random.default_rng(3)
    cams_t = np.array(j_se3_log(jnp.asarray(cams)))
    cams_t[1:] += 0.01 * rng.normal(size=cams_t[1:].shape)
    pts0 = points + 0.05 * rng.normal(size=points.shape)
    cams0 = np.asarray(j_se3_exp(jnp.asarray(cams_t)))
    return (cams0, pts0, cam_idx, pt_idx, pixels), (400.0, 400.0, 320.0, 240.0)


def rmse(cams, pts, data, intr):
    _, _, cam_idx, pt_idx, pixels = data
    err = project(cams, pts, cam_idx, pt_idx, *intr) - pixels
    return float(np.sqrt(np.mean(np.sum(err**2, -1))))


CASES = {"6x40": six_by_forty, "4x24": four_by_twentyfour}
SOLVERS = [("dense", "dense"), ("schur", "dense"), ("schur", "pallas_chol")]


@pytest.mark.parametrize("linear_solver,reduced_solver", SOLVERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bundle_adjust_matches_jax(case, linear_solver, reduced_solver):
    data, intr = CASES[case]()
    cams0, pts0, cam_idx, pt_idx, pixels = data
    kw = dict(linear_solver=linear_solver, max_iterations=20, reduced_solver=reduced_solver)
    jc, jp, js = jba.bundle_adjust(jnp.asarray(cams0), jnp.asarray(pts0), cam_idx.astype(np.int32),
                                   pt_idx.astype(np.int32), jnp.asarray(pixels),
                                   jba.CameraIntrinsics(*intr), use_schur=False,
                                   config=JConfig(**kw))
    before = cholesky.cholesky_blocked.launches
    tensors = convert.bundle_from_numpy(*data, device="cpu", dtype=torch.float64)
    assert tensors[2].dtype == torch.int64 and tensors[0].dtype == torch.float64
    tc, tp, ts = tba.bundle_adjust(*tensors, tba.CameraIntrinsics(*intr), use_schur=False,
                                   config=TConfig(**kw), device="cpu", dtype=torch.float64)
    assert cholesky.cholesky_blocked.launches == before  # the twin ran on the CPU
    assert (ts.termination, ts.iterations, ts.accepted_steps, ts.linear_iterations) == \
        (js.termination, js.iterations, js.accepted_steps, js.linear_iterations), (ts, js)
    for got, want in ((ts.initial_cost, js.initial_cost), (ts.final_cost, js.final_cost)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert tc.shape == (len(cams0), 4, 4) and tp.shape == pts0.shape
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-8)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-8)
    assert rmse(tc.numpy(), tp.numpy(), data, intr) < 1e-6
    assert rmse(cams0, pts0, data, intr) > 1.0


def test_reduced_solver_routes():
    """`pallas_chol` always takes the blocked Cholesky entry; `auto` takes
    it only for a CUDA float32 system of n >= 1024, else torch.linalg.solve."""
    from rust_robotics_tpu_torch.nlls import solver

    calls = []
    real = solver.cholesky_solve_blocked
    solver.cholesky_solve_blocked = lambda s, r: calls.append(s.shape[0]) or real(s, r)
    try:
        rng = np.random.default_rng(0)
        for n, dtype, mode in ((8, torch.float64, "pallas_chol"), (8, torch.float64, "auto"),
                               (1024, torch.float32, "auto"), (8, torch.float64, "dense")):
            m = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
            s = m @ m.T + n * torch.eye(n, dtype=dtype)
            rhs = torch.ones(n, dtype=dtype)
            x = solver._reduced_solve(s, rhs, mode)
            assert float((s @ x - rhs).abs().max()) < 1e-3
    finally:
        solver.cholesky_solve_blocked = real
    assert calls == [8]  # a CPU tensor never takes the kernel under "auto"


def test_pose_graph_from_numpy_carries_the_arrays():
    poses, ef, et = np.zeros((3, 3)), np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    meas, info = np.ones((2, 3)), np.stack([np.eye(3)] * 2)
    out = convert.pose_graph_from_numpy(poses, ef, et, meas, info, device="cpu")
    assert [t.dtype for t in out] == [torch.float32, torch.int64, torch.int64, torch.float32,
                                      torch.float32]
    assert convert.pose_graph_from_numpy(poses, ef, et, meas, device="cpu")[4] is None
