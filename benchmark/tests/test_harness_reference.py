"""The benchmark's frozen problem equals the port's generator, and its plain
reference solves that problem: it reaches the generator's truth, and agrees
with the port's `optimize_pose_graph_2d` on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import problems
from benchmark.reference import se2_lm
from rust_robotics_tpu_torch.demos import pose_graph_bench
from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)
SIZES = (200, 1000)


@pytest.mark.parametrize("size", SIZES)
def test_frozen_generator_is_the_port_s(size):
    got, want = problems.synthesize_chain(size), pose_graph_bench.synthesize_chain(size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(size)
    a, b = rng.normal(size=(2, 40, 3))
    np.testing.assert_array_equal(problems.relative(a, b), pose_graph_bench.relative(a, b))
    truth, initial = want[0], want[1]
    assert problems.rmse(initial, truth) == pose_graph_bench.rmse(initial, truth)


def test_frozen_wobble_is_batched_problem_s():
    """Graph k of the port's `batched_problem` is the wobble at phase k, to
    float64 rounding (the copy sums sin a · cos φ + cos a · sin φ)."""
    truth, init_b, _ = pose_graph_bench.batched_problem(200, 3, device="cpu",
                                                        dtype=torch.float64)
    _, initial, *_ = problems.synthesize_chain(200)
    x0 = problems.Wobbles(200)(np.arange(3.0), initial)
    np.testing.assert_allclose(init_b[:, 1:].numpy(), x0[:, 1:], rtol=0, atol=1e-15)


def _requests(size, graphs, seed=7):
    truth, initial, ef, et, meas, info = problems.synthesize_chain(size)
    phase = np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi, graphs)
    x0 = problems.Wobbles(size)(phase, initial)
    x0[:, 0] = truth[0]
    return truth, x0, ef, et, meas, info


@pytest.mark.parametrize("size", SIZES)
def test_reference_reaches_the_truth(size):
    """The generator's measurements are exact, so its truth is the optimum:
    the float64 reference ends there, at the configurations' settings."""
    truth, x0, ef, et, meas, info = _requests(size, 2)
    poses, summary = se2_lm.solve(torch.as_tensor(x0), ef, et, meas, info,
                                  max_iterations=50, tolerance=1e-13)
    assert problems.rmse(poses.numpy(), truth).max() < 1e-10
    assert not summary.failed.any()
    assert se2_lm.cost(poses, ef, et, meas, info).max() < 1e-20


@pytest.mark.parametrize("size", SIZES)
def test_reference_agrees_with_the_port(size):
    """The port's chain_direct LM in float64 on the CPU and the reference,
    each to its tolerance, give the same poses."""
    truth, x0, ef, et, meas, info = _requests(size, 1)
    want, _ = se2_lm.solve(torch.as_tensor(x0), ef, et, meas, info, max_iterations=50,
                           tolerance=1e-13)
    got, summary = optimize_pose_graph_2d(x0[0], ef, et, meas, info, max_iterations=50,
                                          tolerance=1e-13, linear_solver="chain_direct",
                                          device="cpu", dtype=torch.float64)
    assert summary.termination != "numerical_failure"
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=0, atol=1e-9)


def test_reference_batches_graphs_as_solo_solves():
    """Graphs solved side by side each follow their solo solve."""
    truth, x0, ef, et, meas, info = _requests(200, 3)
    together, _ = se2_lm.solve(torch.as_tensor(x0), ef, et, meas, info, max_iterations=8)
    for k in range(3):
        alone, _ = se2_lm.solve(torch.as_tensor(x0[k:k + 1]), ef, et, meas, info,
                                max_iterations=8)
        np.testing.assert_allclose(together[k].numpy(), alone[0].numpy(), rtol=0, atol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -3.0 - 2.0**-12,
                      0.1], dtype=torch.float32)
    got = se2_lm.round_tf32(x)
    assert got[:4].tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0]
    assert got[4].item() == -3.0
    assert abs(got[5].item() - 0.1) <= 0.1 * 2.0**-11
    bits = got.view(torch.int32) & 0x1FFF
    assert bits.eq(0).all()


def test_stratified_phases_spread_each_block():
    """Each block of `strata` items holds one phase in each 1/strata of the
    circle, whatever the slice asked for, and a seed gives the same phases."""
    strata = 16
    every = problems.stratified_phases(7, 0, 5 * strata, strata)
    for b in range(5):
        cells = np.floor(every[b * strata:(b + 1) * strata] / (2 * np.pi / strata))
        assert sorted(cells.tolist()) == list(range(strata))
    np.testing.assert_array_equal(problems.stratified_phases(7, 21, 30, strata), every[21:51])
    assert not np.array_equal(problems.stratified_phases(8, 0, strata, strata), every[:strata])
