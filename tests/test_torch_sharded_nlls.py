"""The port's factor-sharded matrix-free PCG (rust_robotics_tpu_torch/
parallel/sharded_nlls.py) against JAX's (rust_robotics_tpu/parallel/
sharded_nlls.py).

`solve_sharded` runs on 2 and 4 gloo ranks over a flat 'model' mesh (and,
on the circle, over both axes of the ('data', 'model') mesh), spawned once
per mesh size (tests/torch_dist_workers.py). In f64 it must equal the
port's one-process run (a one-rank mesh) within 1e-12, with the same
termination and iterations (`optimize_pose_graph_2d_sharded` too), and
JAX's `solve_sharded` on a mesh of the same size of conftest's virtual
CPU devices within 1e-8; in f32 it is held to JAX's at the dryrun's
rtol/atol 5e-3 (`__graft_entry__.py::dryrun_multichip`). The graphs are
tests/test_sharded.py's.

The circle runs with a cost tolerance of 1e-10, where tests/test_sharded.py
takes 1e-12: there its last LM step changes the cost by less than the
PCG's rounding, so the psum's summation order decides whether the run
stops or takes more steps (the port on 4 ranks took 13 iterations to
"step_converged" where one rank took 6 to "cost_converged", 7.9e-9
apart), the rounding floor on which ROADMAP C holds runs to values and
costs, not counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_workers as workers
from rust_robotics_tpu.nlls import SolverConfig as JaxConfig
from rust_robotics_tpu.parallel.sharded_nlls import solve_sharded as jax_solve_sharded
from rust_robotics_tpu.slam.pose_graph import build_pose_graph_2d as jax_build

WORLDS = (2, 4)


def _circle(n=40, seed=0, noise=0.3, closures=True):
    """tests/test_sharded.py::_circle_graph: a noisy circle with odometry
    and loop-closure edges."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = np.stack([10 * np.cos(theta), 10 * np.sin(theta), theta + np.pi / 2], axis=-1)
    e_from = list(range(n - 1)) + [n - 1] + ([i for i in range(0, n, 5)] if closures else [])
    e_to = list(range(1, n)) + [0] + ([(i + n // 2) % n for i in range(0, n, 5)]
                                      if closures else [])
    meas = []
    for i, j in zip(e_from, e_to):
        c, s = np.cos(truth[i, 2]), np.sin(truth[i, 2])
        t = np.array([[c, s], [-s, c]]) @ (truth[j, :2] - truth[i, :2])
        meas.append([t[0], t[1], (truth[j, 2] - truth[i, 2] + np.pi) % (2 * np.pi) - np.pi])
    meas = np.asarray(meas) + rng.normal(0, 0.02, (len(e_from), 3))
    init = truth + rng.normal(0, noise, truth.shape)
    init[0] = truth[0]
    return init, np.asarray(e_from), np.asarray(e_to), meas


CFG = dict(method="lm", linear_solver="matfree_pcg", max_iterations=30, pcg_max_iterations=500,
           pcg_tolerance=1e-12)
ODD = _circle(n=24, seed=3)
# the dryrun's f32 program 2: a 16-pose circle, 10 LM iterations
CFG32 = dict(method="lm", linear_solver="matfree_pcg", max_iterations=10, gradient_tolerance=1e-5,
             step_tolerance=1e-6, cost_tolerance=1e-8, pcg_max_iterations=200,
             pcg_tolerance=1e-5)
GRAPHS = {
    "circle": (*_circle(), dict(CFG, cost_tolerance=1e-10), "float64"),
    # 47 odometry/closure edges: not divisible by 2 or 4 (the padding rows)
    "odd": (ODD[0], ODD[1][:-1], ODD[2][:-1], ODD[3][:-1], dict(CFG, max_iterations=20,
                                                             pcg_max_iterations=400), "float64"),
    "f32": (*_circle(n=16, noise=0.1, closures=False), CFG32, "float32"),
    "wrapper": (*_circle(n=32, seed=7), None, "float64"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {w: workers.run_spmd(workers.nlls_program, w, tmp_path_factory.mktemp("nlls"), GRAPHS)
           for w in WORLDS}
    out[1] = [workers.run_one_process(workers.nlls_program, GRAPHS)]
    return out


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    poses, ef, et, meas, cfg, dname = GRAPHS[name]
    dtype = getattr(jnp, dname)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("model",))
    args = (jnp.asarray(poses, dtype), jnp.asarray(ef, jnp.int32), jnp.asarray(et, jnp.int32),
            jnp.asarray(meas, dtype))
    solved, summary = jax_solve_sharded(jax_build(*args), JaxConfig(**cfg), mesh, ("model",))
    return np.asarray(solved.groups[0].values), summary


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_equals_one_process_run(runs, world):
    one = runs[1][0]
    for out in runs[world]:
        for name in ("circle", "odd", "wrapper", "circle_both_axes"):
            values, summary = out[name]
            want, want_summary = one["circle" if name == "circle_both_axes" else name]
            np.testing.assert_allclose(values.numpy(), want.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=name)
            assert summary["termination"] == want_summary["termination"], name
            assert summary["iterations"] == want_summary["iterations"], name


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_equals_jax(runs, world):
    for out in runs[world]:
        for name, tol in (("circle", 1e-8), ("odd", 1e-8), ("f32", 5e-3)):
            values, summary = out[name]
            want, want_summary = _jax(world, name)
            np.testing.assert_allclose(values.numpy(), want, rtol=tol, atol=tol, err_msg=name)
            if name != "f32":
                assert summary["termination"] == want_summary.termination, name
                assert abs(summary["final_cost"] - want_summary.final_cost) <= 1e-8 * max(
                    1.0, want_summary.final_cost), name
        values, summary = out["wrapper"]
        assert summary["final_cost"] < 0.1 * summary["initial_cost"]
        assert np.all(np.isfinite(values.numpy()))
