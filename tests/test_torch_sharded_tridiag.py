"""The port's SPIKE-partitioned chain LM and its IFT (rust_robotics_tpu_torch/
parallel/sharded_tridiag.py) against the one-process chain solver and JAX.

Each SPMD program runs on 2 and 4 gloo ranks, spawned once per world size
(tests/torch_dist_workers.py), in f64 (JAX at x64):
- `spike_solve_local` alone on tests/test_sharded_tridiag.py's random SPD
  block-tridiagonal system (n = 64, t = 3, r = 2) against the port's
  `block_tridiag_solve` and a dense solve (1e-10); the chain's 2·D·t
  interface takes the dense branch;
- the chain LM at n = 96 with a closure every 16 poses against the port's
  one-process `solve_chain_lm` and JAX's: poses within 1e-9, final cost
  within rel 1e-12 (or 1e-20 absolute, for the chain with no closures,
  whose optimum cost is 0), the same termination and iterations;
- the uneven n = 90 (23 rows a rank and 2 pad nodes on 4 ranks),
  `chain_info=None` and a chain with no closures, against the port's
  one-process solve alike;
- the IFT on the one-process n = 96 solution against the port's
  `chain_implicit_vjp` and JAX's (1e-9 of max|g|), and once against JAX's
  `make_sharded_chain_ift` on 4 virtual devices; on the padded n = 90
  solution against the port's.

The LM runs with the dryrun's tolerances (gradient 1e-8, step 1e-8, cost
1e-16; `__graft_entry__.py::dryrun_multichip`), where every run stops on
its gradient above the f64 rounding floor: the closest calls are n = 90's
seventh gradient, 3.5e-8, and the no-closure chain's last, 3.7e-9, against
f64 rounding of ~1e-13 of them, so the termination and the iteration
count do not depend on the ranks' summation order.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_workers as workers
from rust_robotics_tpu.nlls.implicit import chain_implicit_vjp as jax_chain_ift
from rust_robotics_tpu.nlls.tridiag import solve_chain_lm as jax_solve_chain_lm
from rust_robotics_tpu.parallel.sharded_tridiag import make_sharded_chain_ift as jax_sharded_ift
from rust_robotics_tpu.slam.pose_graph import se2_edge_residual, se2_retract
from rust_robotics_tpu_torch.demos.pose_graph_bench import synthesize_chain
from rust_robotics_tpu_torch.nlls.implicit import chain_implicit_vjp
from rust_robotics_tpu_torch.nlls.tridiag import (
    block_tridiag_solve,
    classify_chain_edges,
    solve_chain_lm,
)

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

WORLDS = (2, 4)
LM_KW = dict(max_iterations=20, gradient_tolerance=1e-8, step_tolerance=1e-8,
             cost_tolerance=1e-16)
POSE_ATOL, COST_RTOL, IFT_REL = 1e-9, 1e-12, 1e-9


def _system(n=64, t=3, r=2):
    """tests/test_sharded_tridiag.py::test_spike_solve_matches_serial's."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.3, (n, t, t))
    return (a @ np.swapaxes(a, 1, 2) + 4 * np.eye(t), rng.normal(0, 0.2, (n - 1, t, t)),
            rng.normal(0, 1, (n, t, r)))


def _chain(n, stride=16, info=True):
    """synthesize_chain's chain with N(0, 0.01) noise on its measurements
    (seeded by n and stride), so that a chain with closures has an optimum
    of nonzero cost, which f64 holds to ~1e-14 relative."""
    truth, initial, ef, et, meas, inf = synthesize_chain(n, loop_stride=stride)
    meas = meas + np.random.default_rng(n + stride).normal(0, 0.01, meas.shape)
    cm, ci, lf, lt, lm, li = classify_chain_edges(n, ef, et, meas, inf if info else None)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return truth, (initial, cm, ci, lf, lt, lm, li, fixed)


SYSTEM = _system()
TRUTH, CHAIN = _chain(96)
PROBLEMS = {"chain": CHAIN, "uneven": _chain(90)[1], "none_info": _chain(64, info=False)[1],
            "no_closures": _chain(64, stride=200)[1]}
TARGETS = {"chain": TRUTH + 0.05, "uneven": _chain(90)[0] + 0.05}


def _one_process(name):
    values0, args = workers.chain_args(PROBLEMS[name])
    return solve_chain_lm(values0, *args, **workers.se2_kw(), **LM_KW)


def _torch_ift(name, values):
    _, args = workers.chain_args(PROBLEMS[name])
    return chain_implicit_vjp(values, *args[:-1], args[-1], workers.ift_loss(TARGETS[name]),
                              **workers.se2_kw())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process solves, {world: the ranks' results}); JAX's oracles
    compile while the ranks run."""
    one = {name: _one_process(name) for name in PROBLEMS}
    ift_cases = {f"ift_{name}": (name, one[name][0].numpy(), TARGETS[name]) for name in TARGETS}
    tmp = tmp_path_factory.mktemp("spike")
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        spmd = {w: pool.submit(workers.run_spmd, workers.sharded_chain_program, w, tmp, SYSTEM,
                               PROBLEMS, LM_KW, ift_cases) for w in WORLDS}
        _jax_solve(), _jax_ift("chain"), _jax_ift("chain", sharded_on=4)
        return one, {w: f.result() for w, f in spmd.items()}


def _jax_args(problem):
    initial, cm, ci, lf, lt, lm, li, fixed = problem
    f = lambda a: None if a is None else jnp.asarray(a, jnp.float64)  # noqa: E731
    return f(initial), (f(cm), f(ci), jnp.asarray(lf, jnp.int32), jnp.asarray(lt, jnp.int32),
                        f(lm), f(li), jnp.asarray(fixed))


JAX_SE2 = dict(residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3)


def _jax_loss(target):
    target = jnp.asarray(target)
    return lambda values: jnp.sum((values[:, :2] - target[:, :2]) ** 2)


@functools.lru_cache(maxsize=None)
def _jax_solve():
    values0, args = _jax_args(CHAIN)
    values, summary = jax_solve_chain_lm(values0, *args, **JAX_SE2, **LM_KW)
    return np.asarray(values), summary


@functools.lru_cache(maxsize=None)
def _jax_ift(name, sharded_on=0):
    """JAX's chain_implicit_vjp (or, with sharded_on, its sharded IFT on
    that many virtual devices) at the port's one-process solution."""
    values = jnp.asarray(_one_process(name)[0].numpy())
    _, args = _jax_args(PROBLEMS[name])
    loss_fn = _jax_loss(TARGETS[name])
    if sharded_on:
        mesh = Mesh(np.asarray(jax.devices()[:sharded_on]), ("data",))
        out = jax_sharded_ift(mesh, "data", **JAX_SE2, loss_fn=loss_fn)(values, *args)
    else:
        out = jax_chain_ift(values, *args[:-1], args[-1], loss_fn, **JAX_SE2)
    return tuple(np.asarray(x) for x in out)


def _check_ift(got, want, label):
    loss, d_chain, d_loop = (np.asarray(x) for x in got)
    np.testing.assert_allclose(loss, want[0], rtol=1e-12, err_msg=label)
    scale = max(np.abs(want[1]).max(), np.abs(want[2]).max())
    for g, w in zip((d_chain, d_loop), want[1:]):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, rtol=0, atol=IFT_REL * scale, err_msg=label)


@pytest.mark.parametrize("world", WORLDS)
def test_spike_solve_equals_the_ladder(runs, world):
    diag, upper, rhs = (torch.as_tensor(a) for a in SYSTEM)
    want = block_tridiag_solve(diag, upper, rhs).numpy()
    n, t, r = rhs.shape
    dense = np.zeros((n * t, n * t))
    for i in range(n):
        dense[i * t:(i + 1) * t, i * t:(i + 1) * t] = SYSTEM[0][i]
        if i < n - 1:
            dense[i * t:(i + 1) * t, (i + 1) * t:(i + 2) * t] = SYSTEM[1][i]
            dense[(i + 1) * t:(i + 2) * t, i * t:(i + 1) * t] = SYSTEM[1][i].T
    exact = np.linalg.solve(dense, SYSTEM[2].reshape(n * t, r)).reshape(n, t, r)
    for out in runs[1][world]:
        np.testing.assert_allclose(out["spike"].numpy(), want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(out["spike"].numpy(), exact, rtol=0, atol=1e-10)


def _check_solve(got, want, label):
    values, summary = got
    np.testing.assert_allclose(values.numpy(), want[0].numpy(), rtol=0, atol=POSE_ATOL,
                               err_msg=label)
    want_s = want[1]
    assert float(summary["final_cost"]) == pytest.approx(float(want_s.final_cost),
                                                         rel=COST_RTOL, abs=1e-20), label
    assert int(summary["termination_code"]) == int(want_s.termination_code), label
    assert int(summary["iterations"]) == int(want_s.iterations), label


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_chain_lm_equals_one_process_solve(runs, world):
    one, spmd = runs
    for out in spmd[world]:
        for name in PROBLEMS:
            _check_solve(out[name], one[name], f"{name} on {world} ranks")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_chain_lm_equals_jax(runs, world):
    values, summary = _jax_solve()
    want = (torch.tensor(values), summary)
    for out in runs[1][world]:
        _check_solve(out["chain"], want, f"chain on {world} ranks against JAX")
    # the summary of every rank is the same, and the gathered values too
    first = runs[1][world][0]["chain"]
    for out in runs[1][world][1:]:
        assert torch.equal(out["chain"][0], first[0])
        assert out["chain"][1] == first[1]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ift_equals_chain_implicit_vjp(runs, world):
    one, spmd = runs
    for name in TARGETS:
        port = tuple(x.numpy() for x in _torch_ift(name, one[name][0]))
        for out in spmd[world]:
            _check_ift(out[f"ift_{name}"], port, f"{name} on {world} ranks against the port")
        _check_ift(out["ift_chain"], _jax_ift("chain"), f"chain on {world} ranks against JAX")
    assert np.abs(spmd[world][0]["ift_chain"][2].numpy()).max() > 0  # the closures pull back


def test_sharded_ift_equals_jax_sharded_ift(runs):
    for out in runs[1][4]:
        _check_ift(out["ift_chain"], _jax_ift("chain", sharded_on=4),
                   "chain on 4 ranks against JAX's sharded IFT on 4 devices")


@pytest.mark.cuda
def test_sharded_chain_lm_on_a_one_rank_nccl_mesh():
    """On the card, the SPIKE chain LM on a one-rank NCCL mesh equals
    `solve_chain_lm` there (chip_smoke.py phase 20 runs it at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there (chip_smoke.py phase 20)")
    from rust_robotics_tpu_torch.parallel import mesh as pmesh
    from rust_robotics_tpu_torch.parallel.sharded_tridiag import make_sharded_chain_solver

    dev = torch.device("cuda", 0)
    values0, args = workers.chain_args(CHAIN)
    values0, args = values0.to(dev), tuple(a.to(dev) for a in args)
    pmesh.init_process_group(0, 1, device_type="cuda")
    try:
        mesh = pmesh.make_mesh(axis_names=("data",), device_type="cuda")
        values, summary = make_sharded_chain_solver(mesh, "data", **workers.se2_kw(), **LM_KW)(
            values0, *args)
    finally:
        torch.distributed.destroy_process_group()
    want, want_summary = solve_chain_lm(values0, *args, **workers.se2_kw(), **LM_KW)
    _check_solve((values.cpu(), summary._asdict()), (want.cpu(), want_summary), "one NCCL rank")
