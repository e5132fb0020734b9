"""The banded solver (`nlls/banded.py`) against the JAX package's, on the
same seeded numpy inputs: JAX on the CPU at x64, torch in float64 on the
CPU, plus a float32 case.

`plan_banded` is host numpy and scipy on both sides, so its plans must be
equal, at full size too. The LM runs are held to every count, costs at rtol
1e-9 and poses at atol 1e-8 (both sides do the same fat-block algebra in
another order; the gap measured on the CPU is ~1e-15), on grids with exact
measurements, whose runs stop by the gradient test above the rounding
floor. float32: within 2e-6 of the float64 JAX optimum on poses ~6 m
across (a few ulps of 6, 4.8e-7 each; 2.4e-7 measured on the CPU)."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos.pose_graph_bench import synthesize_chain, synthesize_grid
from rust_robotics_tpu.nlls import banded as jb
from rust_robotics_tpu.slam import pose_graph as jpg
from rust_robotics_tpu_torch.nlls import banded as tb
from rust_robotics_tpu_torch.nlls import tridiag as tt
from rust_robotics_tpu_torch.slam import pose_graph as tpg

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def _chain_one_long_closure():
    truth, initial, ef, et, meas, info = synthesize_chain(500, loop_stride=1000)
    return truth, initial, np.append(ef, 3), np.append(et, 480), meas, info


PLAN_GRAPHS = {
    "grid 100x100 + 50": lambda: synthesize_grid(100, 100, 50),
    "grid 12x10 + 5": lambda: synthesize_grid(12, 10, 5),
    "chain 500 + one long closure": _chain_one_long_closure,
}


@pytest.mark.parametrize("graph", PLAN_GRAPHS)
def test_plan_banded_matches_jax(graph):
    truth, _, ef, et, _, _ = PLAN_GRAPHS[graph]()
    want = jb.plan_banded(len(truth), ef, et)
    got = tb.plan_banded(len(truth), ef, et)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if graph.startswith("chain"):
        assert got.supernode == 1 and (~got.in_band).sum() == 1


def test_plan_banded_warns_at_the_matfree_boundary():
    """tests/test_banded.py:306: a spanning tree plus many random long
    edges defeats every ordering and warns; a grid and a chain do not."""
    rng = np.random.default_rng(3)
    n = 2000
    ef = np.array([int(rng.integers(0, i)) for i in range(1, n)]
                  + [int(a) for a in rng.integers(0, n, 2000)])
    et = np.array(list(range(1, n)) + [int(a) for a in rng.integers(0, n, 2000)])
    keep = ef != et
    with pytest.warns(UserWarning, match="matfree_pcg"):
        tb.plan_banded(n, ef[keep], et[keep])
    for truth, _, gef, get_, _, _ in (synthesize_grid(40, 40, 20), synthesize_chain(2000)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tb.plan_banded(len(truth), gef, get_)


KW = dict(max_iterations=25, tolerance=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_general(w, h, c):
    truth, initial, ef, et, meas, info = synthesize_grid(w, h, c)
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    values, summ, _ = jb.solve_general_graph(
        jnp.asarray(initial), ef, et, meas, info, fixed, residual_fn=jpg.se2_edge_residual,
        retract_fn=jpg.se2_retract, tdim=3, **KW)
    return np.asarray(values), jax.tree_util.tree_map(np.asarray, summ)


def _torch_general(w, h, c, dtype=F64, **kw):
    truth, initial, ef, et, meas, info = synthesize_grid(w, h, c)
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    return tb.solve_general_graph(
        torch.tensor(initial, dtype=dtype), ef, et, meas, info, fixed,
        residual_fn=tpg.se2_edge_residual, retract_fn=tpg.se2_retract, tdim=3, **KW, **kw)


@functools.lru_cache(maxsize=None)
def _torch_general_default(w, h, c):
    """`_torch_general` at float64 and the default ladder, once per process:
    the JAX comparison and the fat_solve forms' reference read the same run."""
    return _torch_general(w, h, c)


def _assert_same_run(got, want):
    (gv, gs), (wv, ws) = got, want
    assert (int(gs.iterations), int(gs.accepted_steps), int(gs.termination_code)) == \
        (int(ws.iterations), int(ws.accepted_steps), int(ws.termination_code))
    assert int(ws.termination_code) == 1
    np.testing.assert_allclose(float(gs.initial_cost), float(ws.initial_cost), rtol=1e-9)
    np.testing.assert_allclose(float(gs.final_cost), float(ws.final_cost), rtol=1e-9,
                               atol=1e-18)
    np.testing.assert_allclose(np.asarray(gv), wv, rtol=0, atol=1e-8)


@pytest.mark.parametrize("w,h,c", [(8, 8, 3), (12, 10, 5)])
def test_solve_general_graph_matches_jax(w, h, c):
    """8×8 + 3 closures plans s = 1 (tridiagonal + Woodbury); 12×10 + 5
    plans s = 12, 36-wide fat blocks (the scatter into the fat layout and
    inv_spd's Schur recursion)."""
    values, summ, plan = _torch_general_default(w, h, c)
    assert plan.supernode == (1 if w == 8 else 12)
    _assert_same_run((values, summ), _jax_general(w, h, c))


def test_solve_general_graph_float32():
    values, summ, _ = _torch_general(12, 10, 5, dtype=torch.float32)
    assert values.dtype == torch.float32
    np.testing.assert_allclose(values.numpy(), _jax_general(12, 10, 5)[0], rtol=0, atol=2e-6)


def test_multi_chunk_woodbury_matches_jax(monkeypatch):
    """One out-of-band edge per Woodbury chunk (the 5 closures of the
    12×10 grid in 5 chunks) against JAX's single chunk."""
    monkeypatch.setattr(tb, "WOODBURY_CHUNK_BYTES", 1)
    _assert_same_run(_torch_general(12, 10, 5)[:2], _jax_general(12, 10, 5))


@pytest.mark.parametrize("form", ["pair", "callable"])
def test_fat_solve_forms_match_the_ladder(form):
    """fat_solve as a (factor, apply) pair and as one callable: the same
    run as the built-in ladder."""
    fat = ((tt.block_tridiag_factor, tt.block_tridiag_apply) if form == "pair"
           else tt.block_tridiag_solve)
    got = _torch_general(12, 10, 5, fat_solve=fat)[:2]
    want = _torch_general_default(12, 10, 5)[:2]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert [int(x) for x in got[1][2:]] == [int(x) for x in want[1][2:]]


def test_banded_lm_batch_is_its_members():
    """Two graphs in lock-step through solve_banded_lm: each equals its
    solo solve."""
    truth, initial, ef, et, meas, info = synthesize_grid(8, 8, 3)
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    init_b = torch.tensor(np.stack([initial, truth]))
    plan, values_b, args = tb.banded_problem(init_b, ef, et, meas, info, fixed, tdim=3)
    kw = dict(residual_fn=tpg.se2_edge_residual, retract_fn=tpg.se2_retract, tdim=3,
              supernode=plan.supernode, num_super=plan.num_super, gradient_tolerance=1e-10,
              step_tolerance=1e-10, cost_tolerance=1e-20)
    both, summ = tb.solve_banded_lm(values_b, *args, **kw)
    for k in range(2):
        solo, ss = tb.solve_banded_lm(values_b[k], *args, **kw)
        np.testing.assert_allclose(both[k].numpy(), solo.numpy(), rtol=0, atol=1e-12)
        assert int(ss.iterations) == int(summ.iterations[k])
        assert int(ss.termination_code) == int(summ.termination_code[k])
    assert int(summ.iterations[1]) < int(summ.iterations[0])  # the truth stops at once


def test_direct_routing_matches_jax():
    """optimize_pose_graph_2d(linear_solver="direct") takes the banded route
    on a grid and the chain route on a chain (by the solvers' call
    counters), and gives JAX's poses on both."""
    graphs = {"banded": synthesize_grid(8, 8, 3), "chain": synthesize_chain(120)}
    for route, (truth, initial, ef, et, meas, info) in graphs.items():
        calls = (tt.solve_chain_lm.calls, tb.solve_banded_lm.calls)
        got, ts = tpg.optimize_pose_graph_2d(initial, ef, et, meas, info, linear_solver="direct",
                                             device="cpu", dtype=F64, **KW)
        took = (tt.solve_chain_lm.calls - calls[0], tb.solve_banded_lm.calls - calls[1])
        assert took == ((0, 1) if route == "banded" else (1, 0))
        want, js = jpg.optimize_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                              jnp.asarray(info), linear_solver="direct", **KW)
        assert (ts.termination, ts.iterations, ts.accepted_steps) == \
            (js.termination, js.iterations, js.accepted_steps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8)
