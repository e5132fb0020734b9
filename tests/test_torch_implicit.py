"""Implicit-function-theorem gradients (`nlls/implicit.py`) against the JAX
package's, on the chains of tests/test_implicit.py and a 10x8 grid whose
banded plan has both a supernode above 1 and Woodbury edges: the same
seeded numpy problems, solved by each package (JAX on the CPU at x64, torch
in float64 on the CPU), then differentiated. The JAX side of the pose-graph
cases runs once per process and is shared by the f64 and f32 cases.

The JAX side's `implicit_vjp` runs under `jax.jit` of a closure over the
solved problem: the same function as the eager call, compiled once (eager,
its exact Hessian dispatches op by op, ~20 s a call), and `solve_implicit`
is held to its own body, JAX's `solve` then that `implicit_vjp`.

Tolerances: gradients at rtol 1e-6 / atol 1e-10 against JAX. Both sides
solve the same linear system at the same optimum; the optima agree to
~1e-17 and the gradients to ~1e-15 on the CPU, so 1e-6 leaves room for the
conditioning of the banded refinement without hiding a wrong term (a
dropped Woodbury or curvature term moves them by ~1e-2 or more). Losses at
rtol 1e-12. The float32 case holds the port's f32 gradient to JAX's f64
within 5e-5 of the gradient's largest entry (f32 rounding of the optimum
and of the solve, ~1e-6 relative measured) and checks that it stays f32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos.pose_graph_bench import relative, synthesize_chain, synthesize_grid
from rust_robotics_tpu import nlls as jn
from rust_robotics_tpu.nlls import SolverConfig as JConfig
from rust_robotics_tpu.nlls import implicit as ji
from rust_robotics_tpu.nlls import solve as j_solve
from rust_robotics_tpu.nlls.tridiag import classify_chain_edges
from rust_robotics_tpu.slam import pose_graph as jpg
from rust_robotics_tpu_torch import nlls as tn
from rust_robotics_tpu_torch.nlls import implicit as ti
from rust_robotics_tpu_torch.slam import pose_graph as tpg

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
CFG = dict(method="lm", max_iterations=30, gradient_tolerance=1e-12, step_tolerance=1e-12,
           cost_tolerance=1e-14)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-10)


def _jax_implicit_vjp(solved, loss_fn, hessian="exact"):
    return jax.jit(lambda: ji.implicit_vjp(solved, loss_fn, hessian))()


def _problems(graph):
    _, initial, ef, et, meas, info = graph
    return (jpg.build_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                    jnp.asarray(info)),
            tpg.build_pose_graph_2d(_t(initial), _t(ef), _t(et), _t(meas), _t(info)))


@pytest.mark.parametrize("hessian", ["exact", "gauss_newton"])
def test_implicit_vjp_matches_jax(hessian):
    jp, tp = _problems(synthesize_chain(12))
    j_solved, _ = j_solve(jp, JConfig(**CFG))
    t_solved, _ = tn.solve(tp, tn.SolverConfig(**CFG))
    want_loss, want = _jax_implicit_vjp(j_solved, lambda v: jnp.sum(v[0][-1] ** 2), hessian)
    loss, got = tn.implicit_vjp(t_solved, lambda v: torch.sum(v[0][-1] ** 2), hessian)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-12)
    assert got[0].shape == (len(t_solved.factors[0].indices), 3) and got[0].dtype == F64
    assert np.abs(np.asarray(want[0])).max() > 0.1
    _close(got[0], want[0])


def test_implicit_vjp_robust_tuple_measurement_matches_jax():
    """A Huber fit whose measurement is a tuple (xs, ys) and whose residuals
    at the optimum are far from zero: the exact Hessian's curvature term
    matters, and the gradient comes back as a tuple, as in JAX."""
    rng = np.random.default_rng(0)
    xs = np.linspace(-2, 2, 40)
    ys = 0.7 * xs**2 - 1.3 * xs + 0.5 + 0.01 * rng.normal(size=xs.shape)
    ys[::7] += 30.0

    def j_res(theta, m):
        return jnp.array([theta[0] * m[0]**2 + theta[1] * m[0] + theta[2] - m[1]])

    def t_res(theta, m):
        return (theta[0] * m[0]**2 + theta[1] * m[0] + theta[2] - m[1])[None]

    jp = jn.Problem((jn.VariableGroup("theta", jnp.zeros((1, 3))),), (jn.FactorBlock(
        "fit", j_res, ("theta",), jnp.zeros((40, 1), jnp.int32),
        measurement=(jnp.asarray(xs), jnp.asarray(ys)), robust=jn.RobustKernel("huber", 0.5)),))
    tp = tn.Problem((tn.VariableGroup("theta", torch.zeros((1, 3), dtype=F64)),), (tn.FactorBlock(
        "fit", t_res, ("theta",), torch.zeros((40, 1), dtype=torch.int64),
        measurement=(_t(xs), _t(ys)), robust=tn.RobustKernel("huber", 0.5)),))
    j_solved, _ = j_solve(jp, JConfig(**CFG))
    t_solved, _ = tn.solve(tp, tn.SolverConfig(**CFG))
    _, want = _jax_implicit_vjp(j_solved, lambda v: jnp.sum(v[0] ** 2))
    _, got = tn.implicit_vjp(t_solved, lambda v: torch.sum(v[0] ** 2))
    assert isinstance(got[0], tuple) and len(got[0]) == 2
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _, gn = tn.implicit_vjp(t_solved, lambda v: torch.sum(v[0] ** 2), "gauss_newton")
    assert np.abs(gn[0][1].numpy() - got[0][1].numpy()).max() > 1e-4


def test_solve_implicit_matches_jax():
    truth, initial, ef, et, meas, info = graph = synthesize_chain(10)
    jp, tp = _problems(graph)
    # JAX `solve_implicit`'s body: solve, then implicit_vjp (default config)
    j_solved, js = j_solve(jp, JConfig())
    want_loss, want = _jax_implicit_vjp(
        j_solved, lambda v: jnp.sum((v[0][-1] - jnp.asarray(truth[-1])) ** 2))
    solved, ts, loss, got = tn.solve_implicit(
        tp, lambda v: torch.sum((v[0][-1] - _t(truth[-1])) ** 2))
    assert (ts.termination, ts.iterations) == (js.termination, js.iterations)
    assert ts.termination != "max_iterations"
    assert float(loss) < 1e-8 and float(want_loss) < 1e-8
    assert got[0].shape == meas.shape and bool(torch.isfinite(got[0]).all())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-10)


def _chain_with_loops():
    truth, initial, ef, et, meas, info = synthesize_chain(12)
    ef = np.concatenate([ef, [0, 4]])
    et = np.concatenate([et, [7, 11]])
    meas = np.concatenate([meas, [relative(truth[0], truth[7]), relative(truth[4], truth[11])]])
    info = np.concatenate([info, [np.eye(3) * 20.0] * 2])
    return truth, initial, ef, et, meas, info


@functools.lru_cache(maxsize=None)
def _jax_pose_graph_ift(topology):
    """(graph, JAX's optimum, loss and gradient) of a topology's case, once
    per test process (the JAX IFT compiles for ~10 s on each call): a
    12-pose chain with two loop closures (the chain IFT's Woodbury branch)
    or a 10x8 grid with four closures (the banded IFT; no odometry chain,
    plan supernode 7 with twelve edges on the Woodbury side)."""
    if topology == "chain":
        graph, solver = _chain_with_loops(), "chain_direct"
    else:
        graph, solver = synthesize_grid(10, 8, 4), "banded_direct"
    _, initial, ef, et, meas, info = graph
    j_poses, _ = jpg.optimize_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                            jnp.asarray(info), max_iterations=40,
                                            tolerance=1e-12, linear_solver=solver)
    want_loss, want = ji.pose_graph_implicit_vjp(j_poses, ef, et, meas, info,
                                                 lambda p: jnp.sum(p[-1] ** 2))
    return graph, solver, np.asarray(j_poses), float(want_loss), np.asarray(want)


@pytest.mark.parametrize("topology", ["chain", "grid"])
def test_pose_graph_implicit_vjp_matches_jax(topology):
    """The chain IFT and the banded IFT of `_jax_pose_graph_ift`'s cases, each
    at the port's own optimum."""
    graph, solver, j_poses, want_loss, want = _jax_pose_graph_ift(topology)
    _, initial, ef, et, meas, info = graph
    t_poses, _ = tpg.optimize_pose_graph_2d(initial, ef, et, meas, info, device="cpu",
                                            dtype=F64, max_iterations=40, tolerance=1e-12,
                                            linear_solver=solver)
    np.testing.assert_allclose(t_poses.numpy(), j_poses, atol=1e-12)
    loss, got = ti.pose_graph_implicit_vjp(t_poses, ef, et, meas, info,
                                           lambda p: torch.sum(p[-1] ** 2), device="cpu")
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-12)
    assert got.shape == meas.shape and got.dtype == F64
    assert np.abs(want).max() > 0.1
    _close(got, want)


def test_chain_implicit_vjp_without_loops_matches_jax():
    """`chain_implicit_vjp` called directly on a chain with no closures (the
    Woodbury-free branch), loss against the truth's last pose."""
    truth, initial, ef, et, meas, info = synthesize_chain(20, loop_stride=40)
    j_poses, _ = jpg.optimize_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                            jnp.asarray(info), max_iterations=40,
                                            tolerance=1e-12, linear_solver="chain_direct")
    cm, ci, lf, lt, lm, li = classify_chain_edges(20, ef, et, meas, info)
    assert len(lf) == 0
    fixed = np.zeros(20, bool)
    fixed[0] = True
    want = ji.chain_implicit_vjp(
        j_poses, jnp.asarray(cm), jnp.asarray(ci), jnp.asarray(lf, jnp.int32),
        jnp.asarray(lt, jnp.int32), jnp.asarray(lm).reshape(0, 3), None, jnp.asarray(fixed),
        lambda p: jnp.sum(p[-1, :2] ** 2), residual_fn=jpg.se2_edge_residual,
        retract_fn=jpg.se2_retract, tdim=3)
    got = ti.chain_implicit_vjp(
        _t(np.asarray(j_poses)), _t(cm), _t(ci), _t(lf, torch.int64), _t(lt, torch.int64),
        _t(lm).reshape(0, 3), None, _t(fixed), lambda p: torch.sum(p[-1, :2] ** 2),
        residual_fn=tpg.se2_edge_residual, retract_fn=tpg.se2_retract, tdim=3)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-12)
    _close(got[1], want[1])
    assert got[2].shape == (0, 3)


def test_general_graph_implicit_vjp_float32_stays_float32():
    """The banded IFT in float32 on the grid case of `_jax_pose_graph_ift`
    (plan: supernode 7, twelve edges on the Woodbury side), at JAX's f64
    optimum rounded to f32: f32 throughout, held to JAX's f64 gradient."""
    graph, _, j_poses, _, want = _jax_pose_graph_ift("grid")
    truth, initial, ef, et, meas, info = graph
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    loss, got = ti.general_graph_implicit_vjp(
        _t(j_poses, torch.float32), ef, et, meas, info, fixed,
        lambda p: torch.sum(p[-1] ** 2), residual_fn=tpg.se2_edge_residual,
        retract_fn=tpg.se2_retract, tdim=3)
    assert loss.dtype == torch.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["chain", "grid"])
def test_float32_ift_and_solve_ignore_tf32_on_cuda(topology):
    """The f32 IFT (chain or banded) and the f32 dense `solve` give the same
    bits with TF32 allowed (`set_float32_matmul_precision("high")`) as
    without: both run under `full_fp32_matmul` (ROADMAP C7). The CPU has no
    TF32, so only a card can show a difference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU has no TF32 (chip_smoke.py phase 16 runs it)")
    graph, solver = (_chain_with_loops(), "chain_direct") if topology == "chain" else (
        synthesize_grid(10, 8, 4), "banded_direct")
    _, initial, ef, et, meas, info = graph
    poses, _ = tpg.optimize_pose_graph_2d(initial, ef, et, meas, info, device="cuda", dtype=F64,
                                          max_iterations=40, tolerance=1e-12,
                                          linear_solver=solver)
    prob = tpg.build_pose_graph_2d(*(torch.tensor(np.asarray(a), device="cuda") for a in (
        np.asarray(initial, np.float32), np.asarray(ef), np.asarray(et),
        np.asarray(meas, np.float32), np.asarray(info, np.float32))))

    def run():
        _, g = ti.pose_graph_implicit_vjp(poses.float(), ef, et, meas, info,
                                          lambda p: torch.sum(p[-1] ** 2), device="cuda",
                                          dtype=torch.float32)
        solved, _ = tn.solve(prob, tn.SolverConfig(max_iterations=5))
        return g, solved.groups[0].values

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = run()
        torch.set_float32_matmul_precision("high")
        got = run()
    finally:
        torch.set_float32_matmul_precision(saved)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
