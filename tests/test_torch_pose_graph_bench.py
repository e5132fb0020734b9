"""The port's copy of the pose-graph benchmark problems
(`rust_robotics_tpu_torch/demos/pose_graph_bench.py`, numpy only) equals
the JAX package's, bitwise, on the same arguments; the batched serving
problem holds the same graphs as its chain; and the compaction runner
packs the same rounds as the JAX package's."""

import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import pose_graph_bench as jbench
from rust_robotics_tpu_torch.demos import pose_graph_bench as tbench

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_relative_is_bitwise_the_jax_package_s():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 50, 3))
    _assert_bitwise([tbench.relative(a, b), tbench.relative(a[0], b[0])],
                    [jbench.relative(a, b), jbench.relative(a[0], b[0])])


@pytest.mark.parametrize("size,stride", [(300, 100), (250, 30), (2, 100)])
def test_synthesize_chain_is_bitwise_the_jax_package_s(size, stride):
    _assert_bitwise(tbench.synthesize_chain(size, stride), jbench.synthesize_chain(size, stride))


@pytest.mark.parametrize("w,h,c", [(10, 12, 5), (6, 6, 0)])
def test_synthesize_grid_is_bitwise_the_jax_package_s(w, h, c):
    _assert_bitwise(tbench.synthesize_grid(w, h, c), jbench.synthesize_grid(w, h, c))


def test_rmse_is_the_jax_package_s():
    truth, initial, *_ = jbench.synthesize_chain(300)
    assert tbench.rmse(initial, truth) == jbench.rmse(initial, truth)
    assert tbench.rmse(truth, truth) == 0.0


def test_batched_problem_wobbles_the_chain():
    """Graph k starts at the chain's initial guess plus its phase-k wobble
    (in the working dtype), with the first pose at the truth."""
    truth, init_b, args = tbench.batched_problem(200, 3, device="cpu", dtype=torch.float64)
    _, initial, *_ = tbench.synthesize_chain(200)
    assert init_b.shape == (3, 200, 3) and args[2].tolist() == [0] and args[3].tolist() == [100]
    for k in range(3):
        wobble = 0.01 * np.sin(np.arange(600) * 0.01 + k).reshape(200, 3) * [1.0, 1.0, 0.1]
        np.testing.assert_array_equal(init_b[k, 1:].numpy(), (initial + wobble)[1:])
        np.testing.assert_array_equal(init_b[k, 0].numpy(), truth[0])


def test_batched_compaction_benchmark_matches_jax():
    """The compaction runner (the JAX package's
    `run_batched_compaction_benchmark`) at a size where a graph leaves the
    batch before the others, in float64: the rounds profile exactly (the
    run stops above the rounding floor), the worst RMSE within 1e-9."""
    kw = dict(size=40, batch=6, chunk_iters=3, max_rounds=4)  # one JAX compile: one bucket
    _, want_rmse, _, want_profile = jbench.run_batched_compaction_benchmark(**kw)  # x64: conftest
    seconds, rmse, graphs_per_s, profile = tbench.run_batched_compaction_benchmark(
        **kw, device="cpu", dtype=torch.float64)
    assert profile == want_profile == [(8, 6), (8, 6), (8, 6), (8, 5)]
    assert abs(rmse - want_rmse) <= 1e-9 and rmse < 1e-3
    assert seconds > 0 and graphs_per_s == 6 / seconds
