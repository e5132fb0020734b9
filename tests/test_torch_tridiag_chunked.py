"""The SPIKE-chunked ladder (`nlls/tridiag.py::chunked_tridiag_factor` /
`chunked_tridiag_apply`, `chunks > 1` through the chain solver and the pose
graphs) against the JAX package's, on the same seeded numpy inputs: JAX on
the CPU at x64, torch in float64 on the CPU, plus a float32 case.

Tolerances. float64 solves at atol 1e-9, as the JAX test
(tests/test_tridiag.py:40-61) holds its chunked solve to the plain one; the
gap measured on the CPU is ~1e-15, the same block algebra in another order.
float32: the chunked solve against the float64 plain one within 1e-5 of
the solution's largest entry: these systems are well conditioned (diagonal
blocks ≥ 5·I against couplings of 0.3), so each side is a few ulps (6e-8)
off the exact solution times a conditioning of ~10. Lanes of a batch equal
their solo solves bitwise. LM runs: every count equal and poses within 1e-9
(the JAX test holds chunks=8 to the plain run at 1e-10 on its own side; the
port and JAX add in other orders, ~1e-13 apart after 25 steps)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos.pose_graph_bench import synthesize_chain
from rust_robotics_tpu.nlls import tridiag as jt
from rust_robotics_tpu.slam import pose_graph as jpg
from rust_robotics_tpu_torch.demos import pose_graph_bench as tbench
from rust_robotics_tpu_torch.nlls import tridiag as tt
from rust_robotics_tpu_torch.slam import pose_graph as tpg

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def _system(n, d, r, seed=3, lead=()):
    """tests/test_tridiag.py:40-61's system: SPD diagonal blocks, small
    couplings, random right-hand sides."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(*lead, n, d, d))
    b = b @ np.swapaxes(b, -1, -2) + 5 * np.eye(d)
    return b, 0.3 * rng.normal(size=(*lead, n - 1, d, d)), rng.normal(size=(*lead, n, d, r))


def _chunked(b, c, f, chunks, dtype=F64):
    fac = tt.chunked_tridiag_factor(torch.tensor(b, dtype=dtype), torch.tensor(c, dtype=dtype),
                                    chunks)
    return tt.chunked_tridiag_apply(fac, torch.tensor(f, dtype=dtype))


# JAX's five cases: chunks dividing n or not, a last chunk of padding, d = 6
# (beyond the closed-form inverse), chunks = 1
@pytest.mark.parametrize("n,d,r,chunks", [(37, 3, 2, 4), (64, 3, 1, 8), (100, 6, 3, 5),
                                          (9, 4, 2, 3), (16, 3, 2, 1)])
def test_chunked_tridiag_matches_jax_and_the_plain_ladder(n, d, r, chunks):
    b, c, f = _system(n, d, r)
    want = np.asarray(jax.jit(lambda b, c, f: jt.chunked_tridiag_apply(
        jt.chunked_tridiag_factor(b, c, chunks), f))(jnp.asarray(b), jnp.asarray(c),
                                                     jnp.asarray(f)))
    got = _chunked(b, c, f, chunks)
    plain = tt.block_tridiag_solve(torch.tensor(b), torch.tensor(c), torch.tensor(f))
    assert got.shape == (n, d, r) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-9)


def test_chunked_tridiag_float32():
    b, c, f = _system(37, 3, 2)
    got = _chunked(b, c, f, 4, torch.float32)
    want = tt.block_tridiag_solve(torch.tensor(b), torch.tensor(c), torch.tensor(f)).numpy()
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_chunked_tridiag_lanes_equal_their_solo_solves():
    b, c, f = _system(37, 3, 2, seed=4, lead=(2,))
    both = _chunked(b, c, f, 4)
    for g in range(2):
        assert torch.equal(both[g], _chunked(b[g], c[g], f[g], 4))


N = 500  # tests/test_tridiag.py:64-90
LM_KW = dict(tdim=3, max_iterations=25, gradient_tolerance=1e-10, step_tolerance=1e-10,
             cost_tolerance=1e-16)


@functools.lru_cache(maxsize=None)
def _chain():
    truth, initial, ef, et, meas, info = synthesize_chain(N)
    fixed = np.zeros(N, bool)
    fixed[0] = True
    return truth, initial, jt.classify_chain_edges(N, ef, et, meas, info), fixed


def test_solve_chain_lm_chunks_8_matches_jax():
    truth, initial, (cm, ci, lf, lt, lm, li), fixed = _chain()
    want, ws = jt.solve_chain_lm(
        jnp.asarray(initial), jnp.asarray(cm), jnp.asarray(ci), jnp.asarray(lf, jnp.int32),
        jnp.asarray(lt, jnp.int32), jnp.asarray(lm), jnp.asarray(li), jnp.asarray(fixed),
        residual_fn=jpg.se2_edge_residual, retract_fn=jpg.se2_retract, chunks=8, **LM_KW)
    t = torch.tensor
    got, gs = tt.solve_chain_lm(t(initial), t(cm), t(ci), t(lf).long(), t(lt).long(), t(lm),
                                t(li), t(fixed), residual_fn=tpg.se2_edge_residual,
                                retract_fn=tpg.se2_retract, chunks=8, **LM_KW)
    assert [int(x) for x in gs[2:]] == [int(x) for x in (ws.iterations, ws.accepted_steps,
                                                          ws.termination_code)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    assert tbench.rmse(got.numpy(), truth) < 5e-3


def test_chain_woodbury_chunked_streams_several_edge_chunks():
    """chunks=4 with a budget of 2 edges a chunk: the 500-pose chain's 4
    closures take 2 edge chunks, and the solve equals the one-chunk solve
    and JAX's."""
    lf, lt = _chain()[2][2:4]
    rng = np.random.default_rng(7)
    n, t = N, 3
    a = rng.standard_normal((n, t, t)) * 0.3
    bd = np.einsum("nij,nkj->nik", a, a) + 4.0 * np.eye(t)
    c = rng.standard_normal((n - 1, t, t)) * 0.4
    rhs = rng.standard_normal((n, t))
    ji, jj = rng.standard_normal((2, len(lf), 3, t))
    w = np.broadcast_to(np.eye(3), (len(lf), 3, 3))
    per_edge = 4 * 9 * 64 * 8 * 4 * 3  # woodbury_edge_chunk's bytes an edge at n=500, C=4
    assert tt.woodbury_edge_chunk(n, len(lf), 3, 2 * per_edge, 4) == 2 < len(lf)
    w_inv = tt.build_w_inv(torch.tensor(w), len(lf), 3, F64)
    args = (torch.tensor(bd), torch.tensor(c), (torch.tensor(ji), torch.tensor(jj)),
            torch.tensor(lf).long(), torch.tensor(lt).long(), w_inv, torch.tensor(rhs))
    got = tt.chain_woodbury_solve(*args, chunk_bytes=2 * per_edge, chunks=4)
    one = tt.chain_woodbury_solve(*args, chunks=4)
    want = np.asarray(jax.jit(functools.partial(
        jt.chain_woodbury_solve, chunk_bytes=2 * per_edge, chunks=4))(
        jnp.asarray(bd), jnp.asarray(c), (jnp.asarray(ji), jnp.asarray(jj)),
        jnp.asarray(lf, jnp.int32), jnp.asarray(lt, jnp.int32),
        jt.build_w_inv(jnp.asarray(w), len(lf), 3, jnp.float64), jnp.asarray(rhs)))
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-12)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)


def test_anchored_se3_chunks_4_matches_jax():
    _, tm, initial, ef, et, meas, info = tbench.synthesize_se3_chain(60, loop_stride=20)
    kw = dict(max_iterations=25, tolerance=1e-10, linear_solver="chain_direct", anchored=True,
              chunks=4)
    want, js = jpg.optimize_pose_graph_3d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                          jnp.asarray(info), **kw)
    got, ts = tpg.optimize_pose_graph_3d(initial, ef, et, meas, info, device="cpu", dtype=F64,
                                         **kw)
    assert (ts.termination, ts.iterations, ts.accepted_steps) == \
        (js.termination, js.iterations, js.accepted_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)
    assert tbench.se3_position_rmse(got, tm) < 1e-9


def test_nested_with_chunks_raises_as_jax():
    _, initial, (cm, ci, lf, lt, lm, li), fixed = _chain()
    t = torch.tensor
    args = (t(initial), t(cm), t(ci), t(lf).long(), t(lt).long(), t(lm), t(li), t(fixed))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt.solve_chain_lm(*args, residual_fn=tpg.se2_edge_residual, retract_fn=tpg.se2_retract,
                          chunks=2, nested=True, **LM_KW)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jt.solve_chain_lm(*map(jnp.asarray, (initial, cm, ci, lf, lt, lm, li, fixed)),
                          residual_fn=jpg.se2_edge_residual, retract_fn=jpg.se2_retract,
                          chunks=2, nested=True, **LM_KW)


def test_auto_chunks_follow_jax_above_262144_poses():
    """The 2-D chain route takes `_auto_chunks` as JAX's does (it passed
    `chunks or 0` before): 4 chunks of 75,000 rows at 300,000 poses."""
    for n in (10, 262144, 262145, 300_000, 524288, 524289, 1_000_000):
        want = 0
        if n > 262144:
            want = 2
            while -(-n // want) > 131072:
                want *= 2
        assert tpg._auto_chunks(n, None) == want
    assert tpg._auto_chunks(300_000, None) == 4 and tpg._auto_chunks(300_000, 0) == 0
