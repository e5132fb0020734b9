"""Exact results on the card: the divisions that JAX makes (ROADMAP C15,
C16) give the CPU's bits on cuda, and the chain LM's CUDA graph replays the
eager step bitwise on each route. No JAX here: the CPU run, or the eager
step, is the reference."""

import numpy as np
import pytest
import torch

from rust_robotics_tpu_torch.core.lie import se3_expm1
from rust_robotics_tpu_torch.demos.pose_graph_bench import batched_problem, synthesize_chain
from rust_robotics_tpu_torch.filters.particle import systematic_positions
from rust_robotics_tpu_torch.nlls import tridiag
from rust_robotics_tpu_torch.slam.icp import centroid
from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _same_on_both(fn, *args):
    """fn on the CPU and on cuda, of the same inputs: bitwise equal."""
    want = fn(*args)
    got = fn(*(a.cuda() for a in args)).cpu()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_systematic_positions_cuda_equal_cpu(dtype):
    """(i + u) / P at P = 1000, not a power of two (C15)."""
    _need_card()
    u = torch.tensor(np.random.default_rng(0).uniform(size=(64, 1)), dtype=dtype)
    _same_on_both(lambda u: systematic_positions(u, 1000), u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_icp_centroids_cuda_equal_cpu(dtype):
    """The ICP centroids over 1000 and 333 points (C16)."""
    _need_card()
    rng = np.random.default_rng(1)
    for shape in ((16, 1000, 2), (5, 333, 3)):
        _same_on_both(centroid, torch.tensor(rng.uniform(0, 10, shape), dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se3_expm1_cuda_equals_cpu(dtype):
    """se3_expm1's Horner steps divide by 10, 9, ..., 2 (C16)."""
    _need_card()
    xi = torch.tensor(np.random.default_rng(2).normal(size=(256, 6)) * 0.1, dtype=dtype)
    _same_on_both(se3_expm1, xi)


def _chain_on_cuda(n, batch=None):
    if batch is not None:
        _, init, args = batched_problem(n, batch, "cuda")
        return init, args
    _, initial, ef, et, meas, info = synthesize_chain(n)
    cm, ci, lf, lt, lm, li = tridiag.classify_chain_edges(n, ef, et, meas, info)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device="cuda")  # noqa: E731
    return t(initial)[None], (t(cm), t(ci), t(lf, torch.int64), t(lt, torch.int64), t(lm),
                              t(li), torch.arange(n, device="cuda") < 1)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["plain", "nested", "chunked", "lanes", "lu"])
def test_graphed_chain_step_equals_eager_step(route):
    """Three LM steps of the 2000-pose chain (four 200-pose graphs in
    lock-step for "lanes"), replayed from the graph and run eagerly: every
    field of every state bitwise equal."""
    _need_card()
    init, args = _chain_on_cuda(200, 4) if route == "lanes" else _chain_on_cuda(2000)
    kw = dict(residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3,
              nested=route == "nested", chunks=4 if route == "chunked" else 0,
              spd=route != "lu")
    state, eager = tridiag.chain_lm_start(init, *args, graphed=False, **kw)
    _, graphed = tridiag.chain_lm_start(init, *args, **kw)
    assert hasattr(graphed, "graph") and not hasattr(eager, "graph")
    want, got = state, state
    for _ in range(3):
        want = eager(want)
        got = graphed(got)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
