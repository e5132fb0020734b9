"""The chain solver (`nlls/tridiag.py`) against the JAX package's, on the
same seeded numpy inputs: JAX on the CPU at x64, torch in float64 on the
CPU, plus float32 cases.

Tolerances. float64: the ladder, the Woodbury and the nested solves at
rtol 1e-10 of the solution's largest entry (both sides do the same block
algebra in another order; the gap measured on the CPU is ~1e-15); LM runs
at atol 1e-8 on poses, rtol 1e-9 on costs, and every count equal, on runs
that stop by the gradient test well above the rounding floor (these graphs have
exact measurements, so the cost falls to ~1e-15 and the gradient below the
1e-8 tolerance in one quadratic step; ROADMAP.md C). float32: the torch
solve against the float64 JAX optimum within 2e-6 on poses ~6 m long: the
f64 dense optimum sits at the truth (exact measurements), and an f32 solve
there is held by its own rounding, a few ulps of 6 (4.8e-7 each) times the
chain's conditioning; 1.9e-7 measured on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos.pose_graph_bench import rmse, synthesize_chain
from rust_robotics_tpu.nlls import tridiag as jt
from rust_robotics_tpu.slam import pose_graph as jpg
from rust_robotics_tpu_torch.nlls import tridiag as tt
from rust_robotics_tpu_torch.slam import pose_graph as tpg

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _tridiag_system(rng, n, d, r):
    b = rng.normal(size=(n, d, d))
    b = b @ b.transpose(0, 2, 1) + 5 * np.eye(d)
    return b, 0.3 * rng.normal(size=(n - 1, d, d)), rng.normal(size=(n, d, r))


@pytest.mark.parametrize("d", [3, 6, 12])
def test_inv_spd_matches_jax(d):
    rng = np.random.default_rng(d)
    m = rng.normal(size=(7, d, d))
    m = m @ m.transpose(0, 2, 1) + 3 * np.eye(d)
    want = np.asarray(jt.inv_spd(jnp.asarray(m)))
    got = tt.inv_spd(_t(m)).numpy()
    assert _rel(got, want) < 1e-12
    np.testing.assert_allclose(got @ m, np.broadcast_to(np.eye(d), m.shape), atol=1e-10)


@pytest.mark.parametrize("n,d,r", [(1, 3, 2), (2, 3, 1), (5, 3, 4), (16, 3, 2), (37, 6, 3),
                                   (100, 4, 5)])
def test_block_tridiag_solve_matches_jax(n, d, r):
    b, c, f = _tridiag_system(np.random.default_rng(0), n, d, r)
    want = np.asarray(jax.jit(jt.block_tridiag_solve)(*map(jnp.asarray, (b, c, f))))
    got = tt.block_tridiag_solve(_t(b), _t(c), _t(f)).numpy()
    assert _rel(got, want) < 1e-10


def test_block_tridiag_batched_equals_its_members():
    """One call over leading dims [2, 3] is the loop over its members."""
    rng = np.random.default_rng(1)
    systems = [[_tridiag_system(rng, 37, 3, 2) for _ in range(3)] for _ in range(2)]
    stack = [np.stack([np.stack([s[k] for s in row]) for row in systems]) for k in range(3)]
    got = tt.block_tridiag_solve(*map(_t, stack)).numpy()
    for i, row in enumerate(systems):
        for j, (b, c, f) in enumerate(row):
            np.testing.assert_array_equal(
                got[i, j], tt.block_tridiag_solve(_t(b), _t(c), _t(f)).numpy())


def _random_system(rng, n, t=3):
    a = rng.standard_normal((n, t, t)) * 0.3
    bd = np.einsum("nij,nkj->nik", a, a) + 4.0 * np.eye(t)
    return bd, rng.standard_normal((n - 1, t, t)) * 0.4, rng.standard_normal((n, t))


def _random_loops(rng, num_l, t=3, r=3):
    ji = rng.standard_normal((num_l, r, t))
    jj = rng.standard_normal((num_l, r, t))
    s = rng.standard_normal((num_l, r, r)) * 0.3
    return ji, jj, np.einsum("eij,ekj->eik", s, s) + 2.0 * np.eye(r)


# tests/test_tridiag_nested.py:42-57: stride loops, overlapping long loops,
# duplicate endpoints, an adjacent (i, i+1) parallel edge, endpoints at 0
# and n-1
MIXED_N = 300
MIXED_LF = np.array([0, 10, 40, 40, 100, 150, 17, 0], np.int32)
MIXED_LT = np.array([50, 110, 140, 41, 200, 299, 18, 299], np.int32)


@functools.lru_cache(maxsize=None)
def _mixed():
    rng = np.random.default_rng(0)
    bd, c, rhs = _random_system(rng, MIXED_N)
    ji, jj, w = _random_loops(rng, len(MIXED_LF))
    return bd, c, rhs, ji, jj, w


@functools.lru_cache(maxsize=None)
def _jax_woodbury(refine=0, nested=False, w_scale=1.0):
    bd, c, rhs, ji, jj, w = map(jnp.asarray, _mixed())
    w_inv = w_scale * jt.build_w_inv(w, len(MIXED_LF), 3, jnp.float64)
    if nested:
        part = jt.nested_partition(MIXED_N, MIXED_LF, MIXED_LT)
        return np.asarray(jax.jit(jt.chain_nested_solve)(bd, c, (ji, jj), w_inv, rhs, part,
                                                           w_blocks=w))
    return np.asarray(jax.jit(functools.partial(jt.chain_woodbury_solve, refine=refine))(
        bd, c, (ji, jj), jnp.asarray(MIXED_LF), jnp.asarray(MIXED_LT), w_inv, rhs, w_blocks=w))


def _torch_mixed():
    bd, c, rhs, ji, jj, w = map(_t, _mixed())
    w_inv = tt.build_w_inv(w, len(MIXED_LF), 3, F64)
    return bd, c, rhs, (ji, jj), w, w_inv, _t(MIXED_LF).long(), _t(MIXED_LT).long()


@pytest.mark.parametrize("chunk_bytes,refine", [(None, 0), (1, 0), (3 * 2 * 512 * 8 * 4 * 3 * 3, 0),
                                                (None, 1)])
def test_chain_woodbury_solve_matches_jax(chunk_bytes, refine):
    """One chunk; one edge a chunk (8 chunks); 3 edges a chunk (a short
    last chunk); and one refinement pass."""
    bd, c, rhs, jac, w, w_inv, lf, lt = _torch_mixed()
    got = tt.chain_woodbury_solve(bd, c, jac, lf, lt, w_inv, rhs, w_blocks=w, refine=refine,
                                  chunk_bytes=chunk_bytes)
    assert _rel(got.numpy(), _jax_woodbury(refine)) < 1e-10


def test_chain_woodbury_rejected_capacitance_gives_nan_as_jax():
    """W⁻¹ negative definite: S is not SPD, JAX's cho_factor gives NaN, and
    the port's rejected cholesky_ex gives a NaN solution too."""
    assert np.isnan(_jax_woodbury(w_scale=-100.0)).all()
    bd, c, rhs, jac, w, w_inv, lf, lt = _torch_mixed()
    solve, failed = tt.capacitance_solver(-100 * w_inv)
    assert bool(failed)
    got = tt.chain_woodbury_solve(bd, c, jac, lf, lt, -100 * w_inv, rhs, w_blocks=w)
    assert torch.isnan(got).all()


@pytest.mark.parametrize("k", [3, tt.BATCHED_CHOLESKY_MAX + 8])
def test_capacitance_factor_is_the_same_alone_and_in_a_batch(k):
    """A graph's capacitance factor does not depend on the batch around it
    (cuSOLVER's batched and single algorithms round differently, so small
    systems always take the batched one, large ones the single one), and
    a rejected member is flagged alone."""
    rng = np.random.default_rng(k)
    m = rng.normal(size=(3, k, k))
    s = _t(m @ m.transpose(0, 2, 1) + k * np.eye(k))
    s[1] = -s[1]
    solve, failed = tt.capacitance_solver(s)
    assert failed.tolist() == [False, True, False]
    r = _t(rng.normal(size=(3, k, 2)))
    x = solve(r)
    for g in (0, 2):
        solo, solo_failed = tt.capacitance_solver(s[g])
        assert solo_failed.shape == () and not bool(solo_failed)
        np.testing.assert_array_equal(solo(r[g]).numpy(), x[g].numpy())
        np.testing.assert_allclose(x[g].numpy(), np.linalg.solve(s[g].numpy(), r[g].numpy()),
                                   rtol=1e-10)


def test_nested_partition_matches_jax():
    want = jt.nested_partition(MIXED_N, MIXED_LF, MIXED_LT)
    got = tt.nested_partition(MIXED_N, MIXED_LF, MIXED_LT, device="cpu")
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_chain_nested_solve_matches_jax_and_the_woodbury():
    bd, c, rhs, jac, w, w_inv, lf, lt = _torch_mixed()
    part = tt.nested_partition(MIXED_N, lf, lt)
    calls = tt.chain_nested_solve.calls
    got = tt.chain_nested_solve(bd, c, jac, w_inv, rhs, part, w_blocks=w)
    assert tt.chain_nested_solve.calls == calls + 1
    assert _rel(got.numpy(), _jax_woodbury(nested=True)) < 1e-10
    want = tt.chain_woodbury_solve(bd, c, jac, lf, lt, w_inv, rhs, w_blocks=w)
    assert _rel(got.numpy(), want.numpy()) < 1e-10
    # a batch of two systems (the second scaled) is its members
    both = tt.chain_nested_solve(torch.stack([bd, 2 * bd]), torch.stack([c, 2 * c]),
                                 tuple(torch.stack([j, j]) for j in jac), w_inv,
                                 torch.stack([rhs, rhs]), part, w_blocks=w)
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        both[1].numpy(), tt.chain_nested_solve(2 * bd, 2 * c, jac, w_inv, rhs, part,
                                               w_blocks=w).numpy(), rtol=0, atol=1e-12)


def test_edge_classification_matches_jax():
    truth, initial, ef, et, meas, info = synthesize_chain(300)
    # a parallel (i, i+1) edge goes to the loop side
    ef, et = np.append(ef, 7), np.append(et, 8)
    meas, info = np.concatenate([meas, meas[7:8]]), np.concatenate([info, info[7:8]])
    for g, w in zip(tt.classify_chain_edges(300, ef, et, meas, info),
                    jt.classify_chain_edges(300, ef, et, meas, info)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tt.chain_edge_partition(300, ef, et), jt.chain_edge_partition(300, ef, et)):
        np.testing.assert_array_equal(g, w)
    assert tt.classify_chain_edges(300, ef, et, meas)[1] is None
    assert tt.has_full_chain(300, ef, et) and jt.has_full_chain(300, ef, et)
    assert not tt.has_full_chain(300, ef[1:], et[1:]) and not jt.has_full_chain(300, ef[1:],
                                                                                 et[1:])
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="consecutive pair"):
            mod.classify_chain_edges(50, ef[:45], et[:45], meas[:45], info[:45])


# solve_chain_lm on the reference's benchmark chain, 120 poses
N = 120
LM_KW = dict(tdim=3, max_iterations=25, gradient_tolerance=1e-8, step_tolerance=1e-8,
             cost_tolerance=1e-16)


@functools.lru_cache(maxsize=None)
def _chain(loops=True):
    truth, initial, ef, et, meas, info = synthesize_chain(N)
    if not loops:
        keep = et - ef == 1
        ef, et, meas, info = ef[keep], et[keep], meas[keep], info[keep]
    fixed = np.zeros(N, bool)
    fixed[0] = True
    return truth, initial, jt.classify_chain_edges(N, ef, et, meas, info), fixed


@functools.lru_cache(maxsize=None)
def _jax_chain_lm(loops=True, info_sign=1.0):
    _, initial, (cm, ci, lf, lt, lm, li), fixed = _chain(loops)
    values, summ = jt.solve_chain_lm(
        jnp.asarray(initial), jnp.asarray(cm), jnp.asarray(ci), jnp.asarray(lf, jnp.int32),
        jnp.asarray(lt, jnp.int32), jnp.asarray(lm), info_sign * jnp.asarray(li),
        jnp.asarray(fixed), residual_fn=jpg.se2_edge_residual, retract_fn=jpg.se2_retract,
        **LM_KW)
    return np.asarray(values), jax.tree_util.tree_map(np.asarray, summ)


def _torch_chain_args(loops=True, dtype=F64):
    _, initial, (cm, ci, lf, lt, lm, li), fixed = _chain(loops)
    return (_t(initial, dtype), _t(cm, dtype), _t(ci, dtype), _t(lf).long(), _t(lt).long(),
            _t(lm, dtype), _t(li, dtype), _t(fixed))


def _assert_same_run(got, want):
    (gv, gs), (wv, ws) = got, want
    assert (int(gs.iterations), int(gs.accepted_steps), int(gs.termination_code)) == \
        (int(ws.iterations), int(ws.accepted_steps), int(ws.termination_code))
    assert int(ws.termination_code) == 1  # stopped by the gradient test, above the floor
    np.testing.assert_allclose(float(gs.initial_cost), float(ws.initial_cost), rtol=1e-9,
                               atol=1e-18)
    np.testing.assert_allclose(float(gs.final_cost), float(ws.final_cost), rtol=1e-9,
                               atol=1e-18)
    np.testing.assert_allclose(np.asarray(gv), wv, rtol=0, atol=1e-8)


@pytest.mark.parametrize("loops,nested", [(True, False), (False, False), (True, True)])
def test_solve_chain_lm_matches_jax(loops, nested):
    """nested=True against JAX's plain run: the nested elimination is exact
    (its solves are held to JAX's above), so the run is the same."""
    calls = tt.chain_nested_solve.calls
    got = tt.solve_chain_lm(*_torch_chain_args(loops), residual_fn=tpg.se2_edge_residual,
                            retract_fn=tpg.se2_retract, nested=nested, **LM_KW)
    _assert_same_run(got, _jax_chain_lm(loops))
    assert tt.chain_nested_solve.calls - calls == (int(got[1].iterations) if nested else 0)


def test_solve_chain_lm_float32():
    truth = _chain()[0]
    got, summ = tt.solve_chain_lm(*_torch_chain_args(dtype=torch.float32),
                                  residual_fn=tpg.se2_edge_residual,
                                  retract_fn=tpg.se2_retract, **LM_KW)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_chain_lm()[0], rtol=0, atol=2e-6)
    assert rmse(got.numpy(), truth) < 1e-6


def test_solve_chain_lm_auto_nested_rule():
    """The auto rule stays off below 50 000 poses (JAX's rule)."""
    assert not tt._use_nested(1000, np.arange(100), np.arange(100) + 5, None, False)
    lf = np.arange(0, 99_000, 100)
    assert tt._use_nested(100_000, lf, lf + 100, None, False)
    assert not tt._use_nested(100_000, lf[:63], lf[:63] + 100, None, False)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt._use_nested(1000, lf, lf + 1, True, True)


def test_chain_lm_batch_freezes_converged_graphs_as_jax_vmap():
    """tests/test_tridiag.py:490: three graphs of differing difficulty (the
    first starts at the optimum) in lock-step; each equals jax.vmap's lane
    and its own solo torch solve: values, iterations, accepted steps and
    termination."""
    truth, initial, (cm, ci, lf, lt, lm, li), fixed = _chain()
    init_b = np.stack([truth, initial,
                       initial + 0.05 * np.sin(np.arange(N * 3.0)).reshape(N, 3)
                       * np.array([1.0, 1.0, 0.1])])
    init_b[:, 0] = truth[0]
    kw = dict(LM_KW, max_iterations=30, gradient_tolerance=1e-9, step_tolerance=1e-9,
              cost_tolerance=1e-18)
    jargs = (jnp.asarray(cm), jnp.asarray(ci), jnp.asarray(lf, jnp.int32),
             jnp.asarray(lt, jnp.int32), jnp.asarray(lm), jnp.asarray(li), jnp.asarray(fixed))
    jv, js = jax.vmap(lambda v: jt.solve_chain_lm(
        v, *jargs, residual_fn=jpg.se2_edge_residual, retract_fn=jpg.se2_retract, **kw))(
        jnp.asarray(init_b))
    targs = _torch_chain_args()[1:]
    tv, ts = tt.solve_chain_lm(_t(init_b), *targs, residual_fn=tpg.se2_edge_residual,
                               retract_fn=tpg.se2_retract, **kw)
    assert tv.shape == (3, N, 3) and ts.iterations.shape == (3,)
    assert int(ts.iterations[0]) < int(ts.iterations[2])
    for k in range(3):
        lane = (tv[k], tt.ChainSummary(*(x[k] for x in ts)))
        _assert_same_run(lane, (np.asarray(jv[k]), tt.ChainSummary(
            *(np.asarray(x[k]) for x in js))))
        sv, ss = tt.solve_chain_lm(_t(init_b[k]), *targs, residual_fn=tpg.se2_edge_residual,
                                   retract_fn=tpg.se2_retract, **kw)
        np.testing.assert_allclose(sv.numpy(), tv[k].numpy(), rtol=0, atol=1e-12)
        assert (int(ss.iterations), int(ss.accepted_steps), int(ss.termination_code)) == \
            (int(ts.iterations[k]), int(ts.accepted_steps[k]), int(ts.termination_code[k]))


def test_se3_chain_matches_jax():
    """solve_chain_lm is generic in the residual and retraction: an SE(3)
    chain of 14 poses with a closure (6×6 blocks: inv_spd's Schur branch),
    the data of tests/test_tridiag.py:173-205."""
    from rust_robotics_tpu_torch.core.lie import se3_exp, se3_inverse, se3_log

    n = 14
    truth_t = 0.2 * np.random.default_rng(4).standard_normal((n, 6))
    truth_t[0] = 0.0
    mats = se3_exp(_t(truth_t))
    meas = torch.cat([se3_log(se3_inverse(mats[:-1]) @ mats[1:]),
                      se3_log(se3_inverse(mats[0:1]) @ mats[n - 1:n])]).numpy()
    noisy = truth_t + 0.01 * np.random.default_rng(5).standard_normal((n, 6))
    noisy[0] = 0.0
    fixed = np.zeros(n, bool)
    fixed[0] = True
    kw = dict(tdim=6, max_iterations=30, gradient_tolerance=1e-9, step_tolerance=1e-9,
              cost_tolerance=1e-18)
    jv, js = jt.solve_chain_lm(
        jnp.asarray(noisy), jnp.asarray(meas[:-1]), None, jnp.array([0], jnp.int32),
        jnp.array([n - 1], jnp.int32), jnp.asarray(meas[-1:]), None, jnp.asarray(fixed),
        residual_fn=jpg.se3_edge_residual, retract_fn=jpg.se3_retract, **kw)
    got = tt.solve_chain_lm(_t(noisy), _t(meas[:-1]), None, torch.tensor([0]),
                            torch.tensor([n - 1]), _t(meas[-1:]), None, _t(fixed),
                            residual_fn=tpg.se3_edge_residual, retract_fn=tpg.se3_retract, **kw)
    _assert_same_run(got, (np.asarray(jv), jax.tree_util.tree_map(np.asarray, js)))


def test_rejected_capacitance_is_a_numerical_failure_as_jax():
    """Negative loop information makes the capacitance system indefinite:
    JAX's cho_factor NaNs and its finiteness guard stops the LM with
    termination 4 after one iteration; the port's cholesky_ex reports
    info != 0, the graph is marked bad on the device, and the run is the
    same."""
    jv, js = _jax_chain_lm(info_sign=-1e-3)
    args = list(_torch_chain_args())
    args[6] = -1e-3 * args[6]
    tv, ts = tt.solve_chain_lm(*args, residual_fn=tpg.se2_edge_residual,
                               retract_fn=tpg.se2_retract, **LM_KW)
    assert int(js.termination_code) == int(ts.termination_code) == 4
    assert int(js.iterations) == int(ts.iterations) == 1
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_chain_direct_route_matches_jax():
    """optimize_pose_graph_2d's chain_direct route (JAX's route runs the
    same solve_chain_lm as `_jax_chain_lm`)."""
    truth, initial, ef, et, meas, info = synthesize_chain(N)
    got, ts = tpg.optimize_pose_graph_2d(initial, ef, et, meas, info, max_iterations=25,
                                         tolerance=1e-8, linear_solver="chain_direct",
                                         device="cpu", dtype=F64)
    wv, ws = _jax_chain_lm()
    assert (ts.termination, ts.iterations, ts.accepted_steps, ts.linear_iterations) == \
        (jt.TERMINATION_NAMES[int(ws.termination_code)], int(ws.iterations),
         int(ws.accepted_steps), int(ws.iterations))
    np.testing.assert_allclose(got.numpy(), wv, rtol=0, atol=1e-8)
