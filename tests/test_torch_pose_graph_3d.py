"""The SE(3) pose graph (`slam/pose_graph.py`), the port's host Lie algebra
(`core/lie_np.py`) and the SE(3) benchmark chain against the JAX package's,
on the same seeded numpy inputs: JAX on the CPU at x64, torch in float64 on
the CPU, plus a float32 case.

Tolerances. `core/lie_np.py` is numpy on both sides: the same operations,
so 1e-15. The problem's cost at rtol 1e-12 (the same residuals, summed in
another order). Solves: poses at atol 1e-8, costs at rtol 1e-9 (atol 1e-20:
these graphs have exact measurements, so a solve ends at a cost of ~1e-24,
whose digits are noise), every count equal; the runs stop by the gradient
test in a quadratic step well above the rounding floor (ROADMAP.md C). The
anchored path: position RMSE < 1e-9 against the truth in f64 (JAX measured
7.6e-11), and in float32 < 1e-6: the chain spans ~2 m, where an f32 ulp
is 2.4e-7, and the anchored path keeps the error at that class (4.5e-8
measured on the CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core import lie_np as j_lie_np
from rust_robotics_tpu.demos import pose_graph_bench as jbench
from rust_robotics_tpu.slam import pose_graph as jpg
from rust_robotics_tpu_torch.core import lie_np as t_lie_np
from rust_robotics_tpu_torch.demos import pose_graph_bench as tbench
from rust_robotics_tpu_torch.nlls.solver import problem_cost as t_problem_cost
from rust_robotics_tpu_torch.slam import pose_graph as tpg

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def _tangents(rng, n):
    """Random SE(3) tangents: generic angles, tiny ones and angles near pi."""
    xi = rng.normal(size=(n, 6))
    xi[: n // 4, 3:] *= 1e-9
    axis = rng.normal(size=(n // 4, 3))
    xi[n // 4: n // 2, 3:] = axis / np.linalg.norm(axis, axis=-1, keepdims=True) * (np.pi - 1e-6)
    return xi


@pytest.mark.parametrize("name", ["so3_exp", "so3_left_jacobian", "so3_left_jacobian_inverse",
                                  "se3_exp", "se3_log_exp", "se3_adjoint", "se3_inverse",
                                  "skew"])
def test_lie_np_matches_jax(name):
    xi = _tangents(np.random.default_rng(0), 64)
    if name.startswith("so3") or name == "skew":
        args = (xi[:, 3:],)
    elif name == "se3_exp":
        args = (xi,)
    else:
        args = (j_lie_np.se3_exp(xi),)
    fn = "se3_log" if name == "se3_log_exp" else name
    got = getattr(t_lie_np, fn)(*args)
    want = getattr(j_lie_np, fn)(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_se3_chain_problem_matches_jax():
    for got, want in zip(tbench.synthesize_se3_chain(50, loop_stride=20),
                         jbench.synthesize_se3_chain(50, loop_stride=20)):
        np.testing.assert_array_equal(got, want)
    truth_t, tm, initial, *_ = tbench.synthesize_se3_chain(50, loop_stride=20)
    assert tbench.se3_position_rmse(torch.tensor(initial), tm) == \
        jbench.se3_position_rmse(initial, tm) > 0


def _graph(n=14, loop_stride=5):
    truth_t, tm, initial, ef, et, meas, info = tbench.synthesize_se3_chain(n, loop_stride)
    return tm, initial, ef, et, meas, info


@functools.lru_cache(maxsize=None)
def _jax_optimize(linear_solver):
    """JAX's optimize_pose_graph_3d of `_graph()` on a route, once per test
    process: its initial cost is also the cost test's reference."""
    _, initial, ef, et, meas, info = _graph()
    want, js = jpg.optimize_pose_graph_3d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                          jnp.asarray(info), max_iterations=25,
                                          linear_solver=linear_solver)
    return np.asarray(want), js


def test_build_pose_graph_3d_cost_matches_jax():
    """The port's problem cost at the initial values against the one JAX's
    solver starts from (`problem_cost` of JAX's `build_pose_graph_3d`)."""
    _, initial, ef, et, meas, info = _graph()
    _, js = _jax_optimize("dense")
    t = torch.tensor
    prob = tpg.build_pose_graph_3d(t(initial), t(ef), t(et), t(meas), t(info))
    got = t_problem_cost(prob, prob.values())
    assert js.initial_cost > 0
    np.testing.assert_allclose(float(got), js.initial_cost, rtol=1e-12)
    assert bool(prob.groups[0].fixed()[0]) and not bool(prob.groups[0].fixed()[1:].any())


def _assert_same(ts, js, got, want):
    assert (ts.termination, ts.iterations, ts.accepted_steps, ts.linear_iterations) == \
        (js.termination, js.iterations, js.accepted_steps, js.linear_iterations), (ts, js)
    for g, w in ((ts.initial_cost, js.initial_cost), (ts.final_cost, js.final_cost)):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-20)
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)


@pytest.mark.parametrize("linear_solver", ["dense", "chain_direct", "banded_direct"])
def test_optimize_pose_graph_3d_matches_jax(linear_solver):
    tm, initial, ef, et, meas, info = _graph()
    want, js = _jax_optimize(linear_solver)
    got, ts = tpg.optimize_pose_graph_3d(initial, ef, et, meas, info, device="cpu", dtype=F64,
                                         max_iterations=25, linear_solver=linear_solver)
    _assert_same(ts, js, got, want)
    assert ts.termination == "gradient_converged"
    assert tbench.se3_position_rmse(got, tm) < 1e-9


def test_anchored_se3_chain_matches_jax():
    truth_t, tm, initial, ef, et, meas, info = tbench.synthesize_se3_chain(60, loop_stride=20)
    kw = dict(max_iterations=25, tolerance=1e-10, linear_solver="chain_direct", anchored=True)
    want, js = jpg.optimize_pose_graph_3d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                          jnp.asarray(info), **kw)
    got, ts = tpg.optimize_pose_graph_3d(initial, ef, et, meas, info, device="cpu", dtype=F64,
                                         **kw)
    _assert_same(ts, js, got, want)
    assert tbench.se3_position_rmse(got, tm) < 1e-9
    # float32: the same anchored path, held to the truth
    got32, ts32 = tpg.optimize_pose_graph_3d(initial, ef, et, meas, info, device="cpu",
                                             dtype=torch.float32, **kw)
    assert got32.dtype == torch.float32
    assert ts32.termination == "gradient_converged"
    assert tbench.se3_position_rmse(got32, tm) < 1e-6


def test_anchored_residual_is_the_plain_one_in_deviation_space():
    """se3_anchored_edge_residual at locals (li, lj) equals se3_edge_residual
    of the recomposed poses A_i·exp(li), A_j·exp(lj) (f64), for a
    measurement Z near the anchors' relative pose, as a solve has it (the
    deviation series need Z⁻¹A_i⁻¹A_j near the identity)."""
    from rust_robotics_tpu_torch.core.lie import se3_exp, se3_log

    rng = np.random.default_rng(1)
    a_i, a_j = t_lie_np.se3_exp(rng.normal(size=(2, 6)) * [3, 3, 3, 0.5, 0.5, 0.5])
    rel = t_lie_np.se3_inverse(a_i) @ a_j
    z = rel @ t_lie_np.se3_exp(rng.normal(size=6) * 0.01)
    e_m = (t_lie_np.se3_inverse(z) @ rel - np.eye(4))[:3].reshape(12)
    ad = t_lie_np.se3_adjoint(t_lie_np.se3_inverse(rel)).reshape(36)
    li, lj = (torch.tensor(v) for v in rng.normal(size=(2, 6)) * 0.01)
    got = tpg.se3_anchored_edge_residual(li, lj, torch.tensor(np.concatenate([e_m, ad])))
    x_i = se3_log(torch.tensor(a_i) @ se3_exp(li))
    x_j = se3_log(torch.tensor(a_j) @ se3_exp(lj))
    want = tpg.se3_edge_residual(x_i, x_j, torch.tensor(t_lie_np.se3_log(z)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


def test_se3_routes_raise_as_jax():
    _, initial, ef, et, meas, info = _graph(6, 3)
    with pytest.raises(ValueError, match="anchored=True requires"):
        tpg.optimize_pose_graph_3d(initial, ef, et, meas, anchored=True, device="cpu")
    for solver in ("banded_direct", "dense"):
        with pytest.raises(ValueError, match="refine"):
            tpg.optimize_pose_graph_3d(initial, ef, et, meas, linear_solver=solver, refine=1,
                                       device="cpu")
    # chunks=2, the SPIKE-chunked ladder, as JAX's (poses within 1e-8)
    kw = dict(linear_solver="chain_direct", anchored=True, chunks=2)
    want, js = jpg.optimize_pose_graph_3d(jnp.asarray(initial), ef, et, jnp.asarray(meas), **kw)
    got, ts = tpg.optimize_pose_graph_3d(initial, ef, et, meas, device="cpu", dtype=F64, **kw)
    assert (ts.termination, ts.iterations, ts.accepted_steps) == \
        (js.termination, js.iterations, js.accepted_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)
    # the JAX package's chunk rule, which the anchored path follows
    sizes = (10, 262144, 262145, 524288, 524289)
    assert [tpg._auto_chunks(n, None) for n in sizes] == [0, 0, 4, 4, 8]
    assert tpg._auto_chunks(262145, 0) == 0


@pytest.mark.parametrize("nested", [False, True])
def test_chain_lm_capacitance_by_lu_takes_the_cholesky_steps(nested):
    """`solve_chain_lm(spd=False)`, the anchored path's LU capacitance
    factor, on an f64 SE(2) chain with closures, plain and nested: the same
    steps as the Cholesky default (counts equal, poses within 1e-12)."""
    from rust_robotics_tpu_torch.demos.pose_graph_bench import synthesize_chain
    from rust_robotics_tpu_torch.nlls import tridiag

    _, initial, ef, et, meas, info = synthesize_chain(120, loop_stride=20)
    cm, ci, lf, lt, lm, li = tridiag.classify_chain_edges(120, ef, et, meas, info)
    fixed = torch.zeros(120, dtype=torch.bool)
    fixed[0] = True
    t = torch.tensor
    args = (t(cm), t(ci), t(lf).long(), t(lt).long(), t(lm), t(li), fixed)
    kw = dict(residual_fn=tpg.se2_edge_residual, retract_fn=tpg.se2_retract, tdim=3,
              max_iterations=25, nested=nested)
    calls = tridiag.chain_nested_solve.calls
    want, ws = tridiag.solve_chain_lm(t(initial), *args, **kw)
    got, gs = tridiag.solve_chain_lm(t(initial), *args, spd=False, **kw)
    assert (tridiag.chain_nested_solve.calls > calls) == nested
    assert [int(x) for x in gs[2:]] == [int(x) for x in ws[2:]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
