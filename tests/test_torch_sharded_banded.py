"""The port's SPIKE fat-block ladder and sharded general-graph solve
(rust_robotics_tpu_torch/parallel/sharded_banded.py) against the
one-process ladder and banded solver and JAX's.

The SPMD program runs on 2 and 4 gloo ranks, spawned once per world size
(tests/torch_dist_workers.py), in f64 (JAX at x64):
- `make_sharded_fat_tridiag_solver` alone on random SPD block-tridiagonal
  systems (tests/test_sharded_banded.py's construction): 8 blocks of
  66 x 66, whose interface (2·D·66 = 264 and 528) takes block-Thomas,
  and 13 blocks of 24 x 24, padded to a multiple of the ranks, whose
  interface (96 and 192) is dense; against the port's
  `block_tridiag_solve` within 1e-10;
- the dryrun's 9 x 8 grid with 4 closures (program 7,
  `__graft_entry__.py::dryrun_multichip`, its LM settings) through
  `solve_general_graph_sharded`, against the port's one-process
  `solve_general_graph` and JAX's within 1e-9, with the same termination
  and iterations. Its runs stop on the gradient: the last gradient above
  the 1e-9 tolerance is 1.7e-7 and the one that ends the run 5.5e-10,
  both far from it against f64 rounding of ~1e-13 of them, so the count
  does not depend on the ranks' summation order.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from rust_robotics_tpu.nlls.banded import solve_general_graph as jax_solve_general_graph
from rust_robotics_tpu.slam.pose_graph import se2_edge_residual, se2_retract
from rust_robotics_tpu_torch.demos.pose_graph_bench import synthesize_grid
from rust_robotics_tpu_torch.nlls.banded import solve_general_graph
from rust_robotics_tpu_torch.nlls.tridiag import block_tridiag_solve
from rust_robotics_tpu_torch.parallel.sharded_tridiag import _DENSE_INTERFACE_MAX

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

WORLDS = (2, 4)
BANDED_KW = dict(max_iterations=12, tolerance=1e-9)
SOLVE_ATOL, GRID_ATOL = 1e-10, 1e-9


def _system(ns, b, seed, r=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.3, (ns, b, b))
    return (a @ np.swapaxes(a, 1, 2) + 6 * np.eye(b), rng.normal(0, 0.2, (ns - 1, b, b)),
            rng.normal(0, 1, (ns, b, r)))


SYSTEMS = {"thomas": _system(8, 66, 3), "dense_padded": _system(13, 24, 4)}
TRUTH, *GRID_DATA = synthesize_grid(9, 8, 4)
FIXED = np.zeros(len(TRUTH), bool)
FIXED[0] = True
GRID = (*GRID_DATA, FIXED)


@functools.lru_cache(maxsize=None)
def _jax_grid():
    initial, ef, et, meas, info, fixed = GRID
    values, summary, _ = jax_solve_general_graph(
        jnp.asarray(initial), ef, et, meas, info, fixed, residual_fn=se2_edge_residual,
        retract_fn=se2_retract, tdim=3, **BANDED_KW)
    return np.asarray(values), summary


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process grid solve, {world: the ranks' results}); JAX's
    solve compiles while the ranks run."""
    initial, ef, et, meas, info, fixed = GRID
    one = solve_general_graph(torch.as_tensor(initial), ef, et, meas, info, fixed,
                              **workers.se2_kw(), **BANDED_KW)
    tmp = tmp_path_factory.mktemp("fat")
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        spmd = {w: pool.submit(workers.run_spmd, workers.sharded_banded_program, w, tmp, SYSTEMS,
                               GRID, BANDED_KW) for w in WORLDS}
        _jax_grid()
        return one, {w: f.result() for w, f in spmd.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_fat_spike_solve_equals_the_ladder(runs, world):
    for name, (diag, upper, rhs) in SYSTEMS.items():
        dense = 2 * world * diag.shape[-1] <= _DENSE_INTERFACE_MAX
        assert dense == (name == "dense_padded")
        want = block_tridiag_solve(*(torch.as_tensor(a) for a in (diag, upper, rhs))).numpy()
        for out in runs[1][world]:
            np.testing.assert_allclose(out[name].numpy(), want, rtol=0, atol=SOLVE_ATOL,
                                       err_msg=f"{name} on {world} ranks")


def _check_grid(got, values, summary, label):
    got_values, got_summary = got
    np.testing.assert_allclose(got_values.numpy(), values, rtol=0, atol=GRID_ATOL,
                               err_msg=label)
    assert int(got_summary["termination_code"]) == int(summary.termination_code), label
    assert int(got_summary["iterations"]) == int(summary.iterations), label


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grid_equals_one_process_solve(runs, world):
    values, summary, _ = runs[0]
    for out in runs[1][world]:
        _check_grid(out["grid"], values.numpy(), summary, f"grid on {world} ranks")
    first = runs[1][world][0]["grid"][0]
    assert all(torch.equal(out["grid"][0], first) for out in runs[1][world])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grid_equals_jax(runs, world):
    values, summary = _jax_grid()
    for out in runs[1][world]:
        _check_grid(out["grid"], values, summary, f"grid on {world} ranks against JAX")
