"""The speed comparison's workloads, `extract_path`'s lanes and the
embedded demo (`demos/{speed_comparison,embedded_demo}.py`,
`planning/wavefront.py::extract_path`) against the JAX package's: JAX on
the CPU at x64, torch in float64 on the CPU.

The speed comparison's timings are host measurements and are checked for
shape only; its workloads are held to JAX (the A* cost on the walled grid
within 1e-12) and their batched lanes to their solo runs (A* walks and
RRT trees bitwise, the EKF chains and spline courses within 1e-12).
`extract_path` over a batch of starts is bitwise its solo walks. The
embedded demo is NumPy only: the port's copy imports neither torch nor
JAX, and its report equals JAX's bitwise. A `cuda` test holds the CUDA
graphs the port replays on the card bitwise to their eager runs (it skips
without a card).
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import embedded_demo as je
from rust_robotics_tpu.demos import speed_comparison as js
from rust_robotics_tpu.planning import wavefront as jw
from rust_robotics_tpu_torch.demos import embedded_demo as te
from rust_robotics_tpu_torch.demos import speed_comparison as ts
from rust_robotics_tpu_torch.planning import wavefront as tw

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def test_extract_path_lanes_are_bitwise_their_solo_walks():
    rng = np.random.default_rng(3)
    free = rng.uniform(size=(40, 33)) > 0.25
    free[0, 0] = free[39, 32] = True
    goals = np.zeros_like(free)
    goals[39, 32] = True
    free_t = torch.tensor(free)
    for conn in (4, 8):
        costs = tw.wavefront_costs(free_t, torch.tensor(goals), connectivity=conn, dtype=F64)
        cells = np.argwhere(free)
        starts = cells[rng.choice(len(cells), size=(2, 5))]  # [2, 5, 2] lanes
        idx, mask, cost = tw.extract_path(costs, free_t, torch.tensor(starts), max_len=160,
                                          connectivity=conn)
        assert idx.shape == (2, 5, 160, 2) and mask.shape == (2, 5, 160)
        want_costs = jw.wavefront_costs(jnp.asarray(free), jnp.asarray(goals), connectivity=conn)
        for a in range(2):
            for b in range(5):
                s_idx, s_mask, s_cost = tw.extract_path(costs, free_t, torch.tensor(starts[a, b]),
                                                        max_len=160, connectivity=conn)
                assert torch.equal(idx[a, b], s_idx) and torch.equal(mask[a, b], s_mask)
                assert torch.equal(cost[a, b], s_cost)
                j_idx, j_mask, j_cost = jw.extract_path(want_costs, jnp.asarray(free),
                                                        jnp.asarray(starts[a, b]), max_len=160,
                                                        connectivity=conn)
                np.testing.assert_array_equal(s_idx.numpy(), np.asarray(j_idx))
                np.testing.assert_array_equal(s_mask.numpy(), np.asarray(j_mask))
                assert float(s_cost) == float(j_cost) or (np.isinf(float(s_cost))
                                                          and np.isinf(float(j_cost)))


def test_extract_path_from_off_grid_starts_matches_jax():
    """A start one cell outside each edge (and corner) walks as JAX's does:
    the field read through JAX's gather, the raw positions emitted; a
    batch mixing them with on-grid starts is bitwise their solo walks."""
    rng = np.random.default_rng(11)
    free = rng.uniform(size=(23, 17)) > 0.2
    free[:, 0] = free[:, -1] = free[0, :] = free[-1, :] = True
    goals = np.zeros_like(free)
    goals[12, 9] = True
    free_t = torch.tensor(free)
    starts = np.array([(-1, 5), (23, 7), (4, -1), (9, 17), (-1, -1), (23, 17), (-3, 2),
                       (5, 5)])
    for conn in (4, 8):
        costs = tw.wavefront_costs(free_t, torch.tensor(goals), connectivity=conn, dtype=F64)
        want_costs = jw.wavefront_costs(jnp.asarray(free), jnp.asarray(goals), connectivity=conn)
        idx, mask, cost = tw.extract_path(costs, free_t, torch.tensor(starts), max_len=48,
                                          connectivity=conn)
        for k, start in enumerate(starts):
            j_idx, j_mask, j_cost = jw.extract_path(want_costs, jnp.asarray(free),
                                                    jnp.asarray(start), max_len=48,
                                                    connectivity=conn)
            s_idx, s_mask, s_cost = tw.extract_path(costs, free_t, torch.tensor(start),
                                                    max_len=48, connectivity=conn)
            np.testing.assert_array_equal(s_idx.numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(s_mask.numpy(), np.asarray(j_mask))
            assert float(s_cost) == float(j_cost)
            assert torch.equal(idx[k], s_idx) and torch.equal(mask[k], s_mask)
            assert torch.equal(cost[k], s_cost)


@pytest.fixture(scope="module")
def workloads():
    return ts.speed_workloads(batch=6, **CPU)


def test_astar_workload_matches_jax_and_its_lanes(workloads):
    one, many = workloads["a_star"]
    grid = js._grid_world()
    free = grid.free()
    goal = grid.world_to_index(jnp.array([90.0, 90.0]))
    start = grid.world_to_index(jnp.array([10.0, 10.0]))
    costs = jw.wavefront_costs(free, jw.goal_raster(free.shape, goal))
    want = float(jw.extract_path(costs, free, start, max_len=512)[2])
    got_one, got_many = one(), many()
    np.testing.assert_allclose(float(got_one), want, rtol=1e-12)
    assert got_many.shape == (6,) and torch.equal(got_many[0], got_one)


def test_rrt_ekf_spline_lanes_match_their_solo_runs(workloads):
    g = torch.Generator().manual_seed(5)
    draws = torch.rand((6, 499, 3), generator=g, dtype=F64)
    lanes = ts.speed_workloads(batch=6, rrt_draws=(draws[2], draws), **CPU)["rrt"]
    assert torch.equal(lanes[1]()[2], lanes[0]())
    for name in ("ekf", "cubic_spline"):
        one, many = workloads[name]
        solo, batch = one(), many()
        assert batch.shape == (6,) + solo.shape
        torch.testing.assert_close(batch, solo.expand_as(batch), atol=1e-12, rtol=0.0)


def test_speed_comparison_rows_and_reference_numbers(capsys):
    assert ts.REFERENCE_MS == js.REFERENCE_MS
    header, rows = ts.run_speed_comparison(runs=1, batch=2, **CPU)
    assert header == ("algorithm", "ms_per_run", "runs", "batch", "ms_per_run_batched",
                      "reference_rust_ms", "reference_python_ms")
    assert [r[0] for r in rows] == ["a_star", "rrt", "ekf", "cubic_spline"]
    for r in rows:
        assert float(r[1]) > 0 and float(r[4]) > 0 and r[2:4] == (1, 2)
        assert r[5:] == ts.REFERENCE_MS[r[0]]
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == ",".join(header) and len(printed) == 5


def test_embedded_demo_equals_jax_bitwise():
    got, want = te.run_embedded_demo(), je.run_embedded_demo()
    assert got == want and got["passed"]
    rng, jrng = te.Lcg(1), je.Lcg(1)
    assert [rng.next_u64() for _ in range(4)] == [jrng.next_u64() for _ in range(4)]


def test_embedded_demo_imports_neither_torch_nor_jax():
    tree = ast.parse(open(te.__file__).read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] in ("torch", "jax", "rust_robotics_tpu") for n in names)
    # run as a script, alone: it prints PASS and loads no torch or jax
    # (-S: no site hooks, which may import packages at start-up; the
    # packages' paths come through PYTHONPATH)
    code = ("import runpy, sys; sys.argv = ['embedded_demo']\n"
            "try:\n    runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit as e:\n    code = e.code\n"
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))\n"
            "sys.exit(code)\n") % te.__file__
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    out = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                         env=env, timeout=60)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "embedded demo PASS" in lines
    assert lines[-1] == "[]"


@pytest.mark.cuda
def test_cuda_graphs_replay_the_eager_kernels():
    """On the card the DARE's blocks replay a CUDA graph, bitwise the eager
    loop; the MPPI loop's steps replay one too, equal to the CPU's run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rust_robotics_tpu_torch.control import trackers
    from rust_robotics_tpu_torch.control._small import masked_fixpoint
    from rust_robotics_tpu_torch.demos import headless_family as hf

    cuda, f64 = torch.device("cuda"), torch.float64
    v = torch.tensor([0.5, 2.0, 4.5], dtype=f64, device=cuda)
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    a = torch.stack([torch.stack([one, zero + 0.1, zero, zero], -1),
                     torch.stack([zero, zero, v, zero], -1),
                     torch.stack([zero, zero, one, zero + 0.1], -1),
                     torch.stack([zero] * 4, -1)], -2)
    b = torch.stack([zero, zero, zero, v / 2.9], -1)[..., None]
    q, r = torch.diag_embed(torch.stack([one] * 4, -1)), one[..., None, None]
    graphed = trackers.solve_dare(a, b, q, r)
    eager = masked_fixpoint(trackers._dare_step(a, b, q, r), q.expand(a.shape), 150, 0.01)
    assert torch.equal(graphed, eager)
    draws = np.random.default_rng(4).standard_normal((3, 256, 25, 2))
    got = hf.headless_mppi_double_integrator(3, device=cuda, dtype=f64, draws=draws)
    want = hf.headless_mppi_double_integrator(3, device="cpu", dtype=f64, draws=draws)
    for k, w in want.items():
        assert got[k] == w if isinstance(w, bool) else abs(got[k] - w) <= 1e-9, k
