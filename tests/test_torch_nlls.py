"""The NLLS engine (`nlls/`) and the SE(2) pose graph against the JAX
package, mirroring tests/test_nlls.py: least squares, LM, Huber against
outliers, a fixed variable, PCG = dense, Schur = dense and an angle
retraction. Each problem is built from the same seeded numpy data in both
packages (the port's residuals written in torch), solved with the same
configuration in f64 on the CPU, and held to:
- the same termination, iterations, accepted steps and linear iterations;
- initial and final cost at rtol 1e-9 (atol 1e-12: a problem solved to
  the rounding floor ends at a cost of ~1e-20, whose digits are noise);
- values within 1e-8.
Under the default tolerances an LM run on a problem whose minimum cost is
not zero (the fits below end at ~1e-3 and ~18) converges quadratically
onto the rounding floor and stops only there, where a trial and the
current cost tie and which is smaller depends on the order of the sums
(XLA's against torch's): its termination and counts are then noise. Those
runs are held to the same costs and values, and are also run with
step_tolerance=1e-7, which both meet with a step of ~1e-9 after a step of
~1e-6, above the floor, with termination and every count held equal.
Also every `RobustKernel` kind at rtol 1e-12, and `optimize_pose_graph_2d`
(dense, pcg, matfree_pcg) on a 30-pose chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu import nlls as jn
from rust_robotics_tpu.core.angles import normalize_angle as j_wrap
from rust_robotics_tpu.demos.pose_graph_bench import synthesize_chain
from rust_robotics_tpu.slam import pose_graph as jpg
from rust_robotics_tpu_torch import nlls as tn
from rust_robotics_tpu_torch.core.angles import normalize_angle as t_wrap
from rust_robotics_tpu_torch.nlls import solver as tsolver
from rust_robotics_tpu_torch.slam import pose_graph as tpg

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a))


def quadratic(pkg, outliers=False, robust=None):
    """Fit y = a x² + b x + c; one 3-vector parameter variable."""
    rng = np.random.default_rng(0)
    xs = np.linspace(-2, 2, 40)
    ys = 0.7 * xs**2 - 1.3 * xs + 0.5 + 0.01 * rng.normal(size=xs.shape)
    if outliers:
        ys[::7] += 30.0
    if robust is None:
        robust = ("huber", 0.1) if outliers else ("l2", 1.0)
    if pkg == "jax":
        def residual(theta, m):
            x, y = m
            return jnp.array([theta[0] * x**2 + theta[1] * x + theta[2] - y])

        return jn.Problem((jn.VariableGroup("theta", jnp.zeros((1, 3))),), (jn.FactorBlock(
            "fit", residual, ("theta",), jnp.zeros((40, 1), jnp.int32),
            measurement=(jnp.asarray(xs), jnp.asarray(ys)), robust=jn.RobustKernel(*robust)),))

    def residual(theta, m):
        x, y = m
        return (theta[0] * x**2 + theta[1] * x + theta[2] - y)[None]

    return tn.Problem((tn.VariableGroup("theta", torch.zeros((1, 3), dtype=F64)),), (tn.FactorBlock(
        "fit", residual, ("theta",), torch.zeros((40, 1), dtype=torch.int64),
        measurement=(_t(xs), _t(ys)), robust=tn.RobustKernel(*robust)),))


def chain(pkg):
    """1D pose chain: 5 scalar positions, odometry + a prior on the last."""
    n = 5
    fixed = np.zeros(n, bool)
    fixed[0] = True
    idx = np.array([[i, i + 1] for i in range(n - 1)])
    if pkg == "jax":
        return jn.Problem(
            (jn.VariableGroup("x", jnp.zeros((n, 1)), fixed_mask=jnp.asarray(fixed)),),
            (jn.FactorBlock("odo", lambda a, b, m: b - a - m, ("x", "x"),
                            jnp.asarray(idx, jnp.int32), measurement=jnp.ones((n - 1, 1))),
             jn.FactorBlock("loop", lambda a, m: a - m, ("x",), jnp.array([[n - 1]], jnp.int32),
                            measurement=jnp.array([[3.6]]))))
    return tn.Problem(
        (tn.VariableGroup("x", torch.zeros((n, 1), dtype=F64), fixed_mask=_t(fixed)),),
        (tn.FactorBlock("odo", lambda a, b, m: b - a - m, ("x", "x"), _t(idx),
                        measurement=torch.ones((n - 1, 1), dtype=F64)),
         tn.FactorBlock("loop", lambda a, m: a - m, ("x",), torch.tensor([[n - 1]]),
                        measurement=torch.tensor([[3.6]], dtype=F64))))


def two_groups(pkg):
    """Cameras-like 'a' and landmarks-like 'b'; Schur eliminates 'b'."""
    rng = np.random.default_rng(3)
    a0, b0 = rng.normal(size=(3, 2)), rng.normal(size=(6, 2))
    pairs = np.array([[i, j] for i in range(3) for j in range(6)])
    meas = rng.normal(size=(len(pairs), 2))
    mod, arr, idx = (jn, jnp.asarray, lambda x: jnp.asarray(x, jnp.int32)) if pkg == "jax" \
        else (tn, _t, _t)
    zeros = jnp.zeros((1, 2)) if pkg == "jax" else torch.zeros((1, 2), dtype=F64)
    return mod.Problem(
        (mod.VariableGroup("a", arr(a0)), mod.VariableGroup("b", arr(b0))),
        (mod.FactorBlock("rel", lambda ai, bj, m: ai - bj - m, ("a", "b"), idx(pairs),
                         measurement=arr(meas)),
         mod.FactorBlock("anchor", lambda ai, m: ai - m, ("a",), idx(np.array([[0]])),
                         measurement=zeros)))


def angle(pkg):
    """A prior across the wrap: from 3.0 to -3.0 the short way is through pi."""
    if pkg == "jax":
        return jn.Problem(
            (jn.VariableGroup("ang", jnp.array([[3.0]]),
                              retract=lambda v, d: jnp.array([j_wrap(v[0] + d[0])])),),
            (jn.FactorBlock("prior", lambda a, m: jnp.array([j_wrap(a[0] - m[0])]), ("ang",),
                            jnp.array([[0]], jnp.int32), measurement=jnp.array([[-3.0]])),))
    return tn.Problem(
        (tn.VariableGroup("ang", torch.tensor([[3.0]], dtype=F64),
                          retract=lambda v, d: t_wrap(v[0] + d[0])[None]),),
        (tn.FactorBlock("prior", lambda a, m: t_wrap(a[0] - m[0])[None], ("ang",),
                        torch.tensor([[0]]), measurement=torch.tensor([[-3.0]], dtype=F64)),))


def assert_same_solve(build, counts=True, **config):
    """Solve `build(pkg)` in both packages with one configuration; hold
    the port to JAX (termination and every count only when `counts`).
    Returns the port's (solved problem, summary)."""
    j_solved, js = jn.solve(build("jax"), jn.SolverConfig(**config))
    t_solved, ts = tn.solve(build("torch"), tn.SolverConfig(**config))
    if counts:
        assert (ts.termination, ts.iterations, ts.accepted_steps, ts.linear_iterations) == \
            (js.termination, js.iterations, js.accepted_steps, js.linear_iterations), (ts, js)
    for got, want in ((ts.initial_cost, js.initial_cost), (ts.final_cost, js.final_cost)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    for tg, jg in zip(t_solved.groups, j_solved.groups):
        assert tg.values.dtype == F64
        np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg.values), atol=1e-8)
    return t_solved, ts


def test_gauss_newton_converges_to_lstsq():
    solved, summary = assert_same_solve(quadratic, method="gn", max_iterations=5)
    np.testing.assert_allclose(solved.groups[0].values[0].numpy(), [0.7, -1.3, 0.5], atol=0.02)
    assert summary.final_cost < summary.initial_cost


# (counts held, step_tolerance): the default, and one above the floor
ABOVE_FLOOR = [(False, 1e-10), (True, 1e-7)]


@pytest.mark.parametrize("counts,step_tolerance", ABOVE_FLOOR)
def test_lm_converges(counts, step_tolerance):
    solved, summary = assert_same_solve(quadratic, counts, method="lm",
                                        step_tolerance=step_tolerance)
    np.testing.assert_allclose(solved.groups[0].values[0].numpy(), [0.7, -1.3, 0.5], atol=0.02)
    assert summary.termination in ("cost_converged", "gradient_converged", "step_converged")


@pytest.mark.parametrize("counts,step_tolerance", ABOVE_FLOOR)
def test_huber_rejects_outliers(counts, step_tolerance):
    huber, _ = assert_same_solve(lambda pkg: quadratic(pkg, outliers=True), counts,
                                 step_tolerance=step_tolerance)
    l2, _ = assert_same_solve(lambda pkg: quadratic(pkg, outliers=True, robust=("l2", 1.0)),
                              counts, step_tolerance=step_tolerance)
    truth = np.array([0.7, -1.3, 0.5])
    err_huber = np.abs(huber.groups[0].values[0].numpy() - truth).max()
    err_l2 = np.abs(l2.groups[0].values[0].numpy() - truth).max()
    assert err_huber < 0.05 and err_huber < err_l2


@pytest.mark.parametrize("counts,step_tolerance", ABOVE_FLOOR)
@pytest.mark.parametrize("kind", ["pseudo_huber", "cauchy"])
def test_other_robust_kernels_solve_alike(kind, counts, step_tolerance):
    assert_same_solve(lambda pkg: quadratic(pkg, outliers=True, robust=(kind, 0.5)), counts,
                      step_tolerance=step_tolerance)


def test_fixed_variable_stays_fixed():
    solved, _ = assert_same_solve(chain, method="gn", max_iterations=10)
    x = solved.groups[0].values[:, 0].numpy()
    assert x[0] == 0.0
    assert 3.6 < x[-1] + 0.3 and x[-1] < 4.0


@pytest.mark.parametrize("linear_solver", ["pcg", "matfree_pcg"])
def test_pcg_matches_dense(linear_solver):
    dense, _ = assert_same_solve(chain, method="gn", max_iterations=10)
    pcg, _ = assert_same_solve(chain, method="gn", max_iterations=10, linear_solver=linear_solver)
    np.testing.assert_allclose(pcg.groups[0].values.numpy(), dense.groups[0].values.numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("reduced_solver", ["dense", "pallas_chol", "auto"])
def test_schur_matches_dense(reduced_solver):
    dense, _ = assert_same_solve(two_groups, method="gn", max_iterations=8)
    schur, _ = assert_same_solve(two_groups, method="gn", max_iterations=8,
                                 linear_solver="schur", reduced_solver=reduced_solver)
    for g in range(2):
        np.testing.assert_allclose(schur.groups[g].values.numpy(),
                                   dense.groups[g].values.numpy(), atol=1e-9)


def test_schur_lm_matches_jax():
    assert_same_solve(two_groups, linear_solver="schur", reduced_solver="pallas_chol")


def test_manifold_angle_retraction():
    solved, _ = assert_same_solve(angle)
    val = float(solved.groups[0].values[0, 0])
    assert abs(float(t_wrap(torch.tensor(val + 3.0)))) < 1e-6


@pytest.mark.parametrize("kind", ["l2", "huber", "pseudo_huber", "cauchy"])
@pytest.mark.parametrize("delta", [0.0, 0.3, 2.0])
def test_robust_kernel_matches_jax(kind, delta):
    s = np.array([-1.0, 0.0, 1e-20, 0.05, 0.09, 0.3 ** 2, 1.0, 4.0, 17.5, 1e6])
    want = jn.RobustKernel(kind, delta).evaluate(jnp.asarray(s))
    got = tn.RobustKernel(kind, delta).evaluate(torch.tensor(s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_unknown_kernel_and_solver_raise():
    with pytest.raises(ValueError, match="unknown robust kernel"):
        tn.RobustKernel("tukey").evaluate(torch.zeros(2))
    with pytest.raises(ValueError):
        tn.solve(chain("torch"), tn.SolverConfig(linear_solver="qr"))


def test_not_yet_ported_names_say_which_slice():
    """Slice 4's names are all ported now: each is exported and callable, as
    in the JAX package's `nlls`."""
    for name in ("solve_device", "implicit_vjp", "solve_implicit", "solve_chain_lm",
                 "block_tridiag_solve", "classify_chain_edges"):
        assert callable(getattr(tn, name))
    with pytest.raises(AttributeError):
        getattr(tn, "no_such_name")


# solve_device on synthesize_chain(60) (tests/test_nlls.py:193-215, with a
# PCG budget of 200: the masked PCG runs every step of its budget on the
# CPU too). Held to JAX's solve_device: termination and every count equal,
# costs at rtol 1e-9 (atol 1e-20: they end at ~1e-21), poses within 1e-8.
SOLVE_DEVICE = dict(method="lm", max_iterations=25, gradient_tolerance=1e-10,
                    step_tolerance=1e-10, cost_tolerance=1e-14, pcg_max_iterations=200,
                    pcg_tolerance=1e-10)


def _chain60(dtype=F64):
    _, initial, ef, et, meas, info = synthesize_chain(60)
    return (jpg.build_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                    jnp.asarray(info)),
            tpg.build_pose_graph_2d(_t(initial).to(dtype), _t(ef), _t(et), _t(meas).to(dtype),
                                    _t(info).to(dtype)))


@pytest.mark.parametrize("linear_solver", ["dense", "matfree_pcg"])
def test_solve_device_matches_jax(linear_solver):
    jp, tp = _chain60()
    cfg = dict(SOLVE_DEVICE, linear_solver=linear_solver)
    j_solved, js = jn.solve_device(jp, jn.SolverConfig(**cfg))
    t_solved, ts = tn.solve_device(tp, tn.SolverConfig(**cfg))
    assert (ts.termination, ts.iterations, ts.accepted_steps, ts.linear_iterations) == \
        (js.termination, js.iterations, js.accepted_steps, js.linear_iterations), (ts, js)
    assert all(isinstance(v, (int, float, str)) for v in vars(ts).values())
    for got, want in ((ts.initial_cost, js.initial_cost), (ts.final_cost, js.final_cost)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-20)
    assert t_solved.groups[0].values.dtype == F64
    np.testing.assert_allclose(t_solved.groups[0].values.numpy(),
                               np.asarray(j_solved.groups[0].values), atol=1e-8)
    # the host loop reaches the same solution
    host, hs = tn.solve(tp, tn.SolverConfig(**cfg))
    assert hs.termination == ts.termination
    np.testing.assert_allclose(t_solved.groups[0].values.numpy(),
                               host.groups[0].values.numpy(), atol=1e-10)


def test_masked_pcg_iterates_equal_the_stopping_loop():
    """`_pcg_masked` runs its whole budget with each step masked by `_pcg`'s
    test, so x and the count equal `_pcg`'s bitwise, and a converged solve
    stands still for the rest of the budget."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(30, 30))
    h = _t(a @ a.T + 30 * np.eye(30))
    b = _t(rng.normal(size=30))
    pre = torch.diag(1.0 / torch.diagonal(h))
    want, k = tsolver._pcg(lambda p: h @ p, lambda r: pre @ r, b, 200, 1e-10)
    got, k_masked = tsolver._pcg_masked(lambda p: h @ p, lambda r: pre @ r, b, 200, 1e-10)
    assert 0 < k < 200 and int(k_masked) == k
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_solve_device_float32_and_its_limits():
    _, tp = _chain60(torch.float32)
    solved, summary = tn.solve_device(tp, tn.SolverConfig(**SOLVE_DEVICE))
    assert solved.groups[0].values.dtype == torch.float32
    assert summary.termination != "numerical_failure" and summary.final_cost < 1e-8
    with pytest.raises(ValueError, match="dense|matfree_pcg"):
        tn.solve_device(tp, tn.SolverConfig(linear_solver="pcg"))
    empty = tn.Problem((tn.VariableGroup("x", torch.zeros((0, 2), dtype=F64)),), ())
    _, s0 = tn.solve_device(empty)
    assert (s0.iterations, s0.termination) == (0, "gradient_converged")


@pytest.mark.parametrize("linear_solver", ["dense", "pcg", "matfree_pcg"])
def test_pose_graph_2d_chain_matches_jax(linear_solver):
    _, initial, ef, et, meas, info = synthesize_chain(30, loop_stride=10)
    kw = dict(max_iterations=25, linear_solver=linear_solver, pcg_tolerance=1e-10)
    want, js = jpg.optimize_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                          jnp.asarray(info), **kw)
    got, ts = tpg.optimize_pose_graph_2d(initial, ef, et, meas, info, device="cpu", dtype=F64,
                                         **kw)
    assert (ts.termination, ts.iterations, ts.accepted_steps, ts.linear_iterations) == \
        (js.termination, js.iterations, js.accepted_steps, js.linear_iterations)
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)


def test_pose_graph_routes_of_a_later_slice_raise():
    """The chain routes take the SPIKE-chunked ladder (chunks > 1) as JAX's
    do (poses within 1e-8, counts equal), and `refine` belongs to
    chain_direct alone, as in JAX."""
    _, initial, ef, et, meas, _ = synthesize_chain(5)
    for solver in ("direct", "chain_direct"):
        kw = dict(linear_solver=solver, chunks=2)
        want, js = jpg.optimize_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                              **kw)
        got, ts = tpg.optimize_pose_graph_2d(initial, ef, et, meas, device="cpu", dtype=F64,
                                             **kw)
        assert (ts.termination, ts.iterations, ts.accepted_steps) == \
            (js.termination, js.iterations, js.accepted_steps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)
    for solver in ("banded_direct", "dense"):
        with pytest.raises(ValueError, match="refine"):
            tpg.optimize_pose_graph_2d(initial, ef, et, meas, linear_solver=solver, refine=1,
                                       device="cpu")


def test_se3_edge_residual_and_retract_match_jax():
    rng = np.random.default_rng(5)
    xi, xj, z = (0.3 * rng.standard_normal((7, 6)) for _ in range(3))
    want = [jpg.se3_edge_residual(*map(jnp.asarray, a)) for a in zip(xi, xj, z)]
    got = torch.func.vmap(tpg.se3_edge_residual)(_t(xi), _t(xj), _t(z))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-12, atol=1e-14)
    want = [jpg.se3_retract(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(xi, xj)]
    got = torch.func.vmap(tpg.se3_retract)(_t(xi), _t(xj))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-12, atol=1e-14)


def test_linearization_matches_jax():
    """The dense Hessian and gradient of the chain pose graph, at its
    initial values, against the JAX package's at 1e-10."""
    from rust_robotics_tpu.nlls import solver as jsolver

    _, initial, ef, et, meas, info = synthesize_chain(30, loop_stride=10)
    jp = jpg.build_pose_graph_2d(jnp.asarray(initial), ef, et, jnp.asarray(meas),
                                 jnp.asarray(info))
    tp = tpg.build_pose_graph_2d(_t(initial), _t(ef), _t(et), _t(meas), _t(info))
    jh, jg, jc, _ = jsolver._linearize_dense(jp, jp.values(), jnp.float64)
    th, tg, tc, _ = tsolver._linearize_dense(tp, tp.values(), F64)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-10)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-12)


def test_scatter_add_is_reproducible_and_sums_like_index_put():
    """ROADMAP C8: torch's CPU `index_put_(accumulate=True)` adds repeated
    indices in the order its threads take them, so the f32 BA's Hessian, and
    with it a whole VIO run, changed from run to run on fixed inputs (and
    once turned a landmark block indefinite). `scatter_add_` sums in a fixed
    order: repeated calls give the same bits (these inputs gave five
    different results in five repeats of `index_put_` on 8 threads), equal
    to `index_put_`'s sums within rounding."""
    gen = torch.Generator().manual_seed(8)
    n, f = 2000, 200_000
    idx = torch.randint(0, n, (f,), generator=gen)
    vals = torch.randn(f, generator=gen)
    rows = torch.randint(0, 300, (f // 10, 3), generator=gen)
    cols = torch.randint(0, 300, (f // 10, 3), generator=gen)
    blocks = torch.randn(f // 10, 3, 3, generator=gen)
    for make, index, v in ((lambda: torch.zeros(n), (idx,), vals),
                           (lambda: torch.zeros(300, 300), (rows[:, :, None], cols[:, None, :]),
                            blocks),
                           (lambda: torch.zeros(300, 3, 3), (rows[:, 0],), blocks)):
        first = tsolver.scatter_add_(make(), index, v)
        for _ in range(5):
            assert torch.equal(tsolver.scatter_add_(make(), index, v), first)
        want = make().double().index_put_(index, v.double(), accumulate=True)
        np.testing.assert_allclose(first.double().numpy(), want.numpy(), rtol=0, atol=1e-4)

