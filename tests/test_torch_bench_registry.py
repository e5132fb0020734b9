"""The pinned benchmark registry (`demos/benchmarks.py`) against the JAX
package's: torch in float64 on the CPU, each bench's CSV held to the
checked-in baseline under docs/assets/ by `utils/bench_gate.compare_csv`
(headers and rows exact, numerics 1e-6, wall-clock columns ignored), as
tests/test_bench_gate.py holds JAX's. The benches that draw get JAX's own
draws, rebuilt here from the keys JAX's benches split, laid out as each
bench's docstring says.

The unmarked tests run the benches that are cheapest on the CPU (each
under ~0.5 s), `icp-benchmark` and the arm's RRT* on JAX's draws;
every bench has a `slow` test.

`mppi-value-benchmark` is held to its functional columns only: its
70-step closed loops amplify rounding ~10× a step (a 1e-13 state
difference at step 10 is 4e-6 at step 25), and JAX's own run with its
`mppi_plan` under `jax.jit` misses its CSV at 1e-6 (0.0958 against
0.0908 m), so the CSV pins the rounding of JAX's eager run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import benchmarks as jb
from rust_robotics_tpu_torch.demos import benchmarks as tb
from rust_robotics_tpu_torch.utils.bench_gate import compare_csv

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs",
                      "assets")
F = jnp.float64
# the deterministic benches run unmarked, by measured CPU time (< 0.5 s each)
CHEAP = ["grid-planner-benchmark", "admm-formation-benchmark", "admm-graph-consensus-benchmark",
         "racing-motor-benchmark", "racing-powertrain-recovery-benchmark",
         "ekf-localization-benchmark", "frenet-benchmark", "coverage-benchmark",
         "stl-cbs-benchmark", "safe-decode-benchmark", "conformal-coverage-benchmark",
         "conformal-sipp-benchmark", "traversal-risk-sweep-benchmark"]


def normals(k, shape):
    return np.asarray(jax.random.normal(k, shape, F))


def uniforms(k, shape, lo=0.0, hi=1.0):
    return np.asarray(jax.random.uniform(k, shape, F, lo, hi))


def loop_normals(seed, steps, shape):
    """The normals of the subkeys `key, sub = split(key)` of PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(normals(sub, shape))
    return np.stack(out)


def race_normals(seed, steps, k=128, h=14):
    """`simulate_gate_race`'s: one normal draw a step key of split(key, steps)."""
    return np.stack([normals(kk, (k, h, 4))
                     for kk in jax.random.split(jax.random.PRNGKey(seed), steps)])


def rrt_uniforms(seed, n=300):
    """`rrt_plan`'s: iteration i draws uniform(split(keys[i])[0], (3,))."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (3,), F))(
        keys)[:n - 1])


def pf_draws(init_seed, seed, steps, particles, per_step_splits):
    """A particle filter's: init normals of PRNGKey(init_seed), then a
    subkey a step of PRNGKey(seed) (split into `per_step_splits`), which
    `pf_step` splits into its predict normals and resample uniform."""
    init = normals(jax.random.PRNGKey(init_seed), (particles, 4))
    key, pred, unif = jax.random.PRNGKey(seed), [], []
    for _ in range(steps):
        key, sub = jax.random.split(key, per_step_splits)[:2]
        k_pred, k_res = jax.random.split(sub)
        pred.append(normals(k_pred, (particles, 2)))
        unif.append(uniforms(k_res, (1,)))
    return init, np.stack(pred), np.stack(unif)


@jax.jit
def _arm_draws():
    def body(key, _):
        key, k1, k2 = jax.random.split(key, 3)
        return key, (jax.random.uniform(k1, (7,), F, -np.pi, np.pi),
                     jax.random.uniform(k2, (), F))
    return jax.lax.scan(body, jax.random.PRNGKey(0), None, length=190)[1]


def arm_draws():
    """`rrt_star_arm_plan`'s: key, k1, k2 = split(key, 3) an iteration."""
    return tuple(np.asarray(d) for d in _arm_draws())


def pusher_draws():
    """`simulate_push`'s: split(key, 40), each step's key split over 4 faces."""
    return np.stack([np.stack([normals(kf, (64, 12, 3)) for kf in jax.random.split(ks, 4)])
                     for ks in jax.random.split(jax.random.PRNGKey(0), 40)])


def sampling_draws():
    """The two cells' `CellDraws` of JAX's key 0 (tests/test_torch_experiments.py)."""
    from rust_robotics_tpu.experiments import point_cloud_sampling as jpc
    from test_torch_experiments import _cell_draws

    out = {}
    for cases in _jax_sampling_problems(jpc):
        for case in cases:
            for bucket in case.buckets:
                out[case.family_name, bucket] = _cell_draws(jax.random.PRNGKey(0), case, bucket,
                                                            4, 256)
    return out


def _jax_sampling_problems(jpc):
    return [[jpc.CloudCase("plane_baseline", (24,), base_point_count=96)],
            [jpc.CloudCase("ring_sector", (24,), kind="ring", base_point_count=96,
                           corruption="sector_drop", sector_start=0.4, sector_end=1.8,
                           drop_probability=0.9)]]


# JAX's draws of every bench of `DRAWS`
JAX_DRAWS = {
    "rrt-star-benchmark": lambda: np.stack([rrt_uniforms(0), rrt_uniforms(1)]),
    "mppi-benchmark": lambda: loop_normals(0, 40, (256, 25, 2)),
    "mppi-value-benchmark": lambda: loop_normals(7, 70, (512, 25, 2)),
    "icp-benchmark": lambda: uniforms(jax.random.PRNGKey(3), (120, 2)),
    "particle-filter-benchmark": lambda: pf_draws(1, 0, 60, 512, 3),
    "arm-rrt-star-benchmark": arm_draws,
    "sampling-quality-benchmark": sampling_draws,
    "localizers-benchmark": lambda: pf_draws(0, 1, 120, 512, 2),
    "pusher-slider-benchmark": pusher_draws,
    "racing-powertrain-benchmark": lambda: race_normals(0, 90, 128, 15),
    "rigid-body-backends-benchmark": lambda: int(
        jax.random.randint(jax.random.PRNGKey(0), (), 0, 2**31 - 1)),
    "adap-rpf-metrics-benchmark": lambda: loop_normals(5, 24, (360, 16, 2)),
    "racing-mppi-3d-benchmark": lambda: race_normals(11, 60),
    "racing-quadrotor-benchmark": lambda: race_normals(13, 60),
    "racing-powertrain-aware-benchmark": lambda: race_normals(17, 60),
    "racing-powertrain-budget-benchmark": lambda: race_normals(19, 60),
    "racing-powertrain-endurance-benchmark": lambda: race_normals(23, 80),
}


def gate(name, draws=None):
    """The bench's CSV on the CPU in f64 against docs/assets/<name>.csv."""
    header, rows = tb.run_benchmark(name, device="cpu", draws=draws)
    with open(os.path.join(ASSETS, f"{name}.csv")) as fh:
        problems = compare_csv(fh.read(), tb.csv_text(header, rows))
    assert not problems, (name, problems)


def test_registry_names_and_draws_match_jax():
    assert set(tb.PINNED) == set(jb.PINNED) and len(tb.PINNED) == 41
    assert set(tb.DRAWS) == set(JAX_DRAWS) <= set(tb.PINNED)
    assert tb._fmt(True) == jb._fmt(True) == "true"
    for v in (0.1, 1e-12, 123456.789, 3, "x"):
        assert tb._fmt(v) == jb._fmt(v)


@pytest.mark.parametrize("name", CHEAP)
def test_cheap_bench_equals_its_baseline(name):
    gate(name)


@pytest.mark.parametrize("name", ["icp-benchmark", "arm-rrt-star-benchmark"])
def test_drawing_bench_on_jax_draws_equals_its_baseline(name):
    gate(name, JAX_DRAWS[name]())


def test_check_gate_and_run_all(tmp_path, monkeypatch):
    ok, failures = tb.check_gate(ASSETS, names=["grid-planner-benchmark", "icp-benchmark"],
                                 device="cpu",
                                 draws={"icp-benchmark": JAX_DRAWS["icp-benchmark"]()})
    assert ok, failures
    ok, failures = tb.check_gate(str(tmp_path), names=["frenet-benchmark"], device="cpu")
    assert not ok and failures == [("frenet-benchmark", "missing baseline")]
    with pytest.raises(ValueError):
        tb.run_benchmark("frenet-benchmark", device="cpu", draws=np.zeros(3))
    monkeypatch.setattr(tb, "PINNED", {"frenet-benchmark": tb.bench_frenet})
    paths = tb.run_all(str(tmp_path / "out"), device="cpu")
    assert list(paths) == ["frenet-benchmark"]
    with open(paths["frenet-benchmark"]) as got, \
            open(os.path.join(ASSETS, "frenet-benchmark.csv")) as want:
        assert not compare_csv(want.read(), got.read())


def test_own_draws_are_the_same_on_every_call():
    """Without draws a bench draws from a CPU generator seeded with JAX's
    key number: two runs give the same CSV."""
    a = tb.run_benchmark("icp-benchmark", device="cpu")
    assert a == tb.run_benchmark("icp-benchmark", device="cpu")
    assert a != tb.run_benchmark("icp-benchmark", device="cpu",
                                 generator=torch.Generator().manual_seed(1))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(set(tb.PINNED) - {"mppi-value-benchmark"}))
def test_every_bench_equals_its_baseline(name):
    gate(name, JAX_DRAWS[name]() if name in JAX_DRAWS else None)


@pytest.mark.slow
def test_mppi_value_bench_functional_columns():
    header, rows = tb.run_benchmark("mppi-value-benchmark", device="cpu",
                                    draws=JAX_DRAWS["mppi-value-benchmark"]())
    with open(os.path.join(ASSETS, "mppi-value-benchmark.csv")) as fh:
        base = [ln.split(",") for ln in fh.read().split()]
    assert header == base[0] and [r[0] for r in rows] == [r[0] for r in base[1:]]
    assert rows[0][2] == "1" and float(rows[0][1]) < 0.5 < float(rows[1][1])
