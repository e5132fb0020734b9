"""The experiment suites (`experiments/`) against the JAX package's: JAX on
the CPU at x64 (its programs under `jax.jit`), torch in float64 on the CPU,
given JAX's own draws (rebuilt from its keys), at the sizes of
tests/test_experiments.py or smaller, as stated.

Tolerances: per-cell metrics within 1e-9 (the closed loops run tens of
steps through JAX's fused multiply-adds; an RMSE sums its steps in
another order); slot selections, escalations, win counts and winners
exactly; point-cloud scores within 1e-9 with the clouds within 1e-12.
Seed lanes equal their solo runs bit for bit.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.experiments import drone_quality as jdq
from rust_robotics_tpu.experiments import path_tracking as jpt
from rust_robotics_tpu.experiments import point_cloud_sampling as jpc
from rust_robotics_tpu.experiments import ukf_ckf_accuracy as juk
from rust_robotics_tpu_torch.experiments import drone_quality as tdq
from rust_robotics_tpu_torch.experiments import path_tracking as tpt
from rust_robotics_tpu_torch.experiments import point_cloud_sampling as tpc
from rust_robotics_tpu_torch.experiments import ukf_ckf_accuracy as tuk

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def close(got, want, atol=1e-9):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def _reports_equal(got, want, atol=1e-9):
    assert [r.variant.name for r in got] == [r.variant.name for r in want]
    for g, w in zip(got, want):
        assert len(g.observations) == len(w.observations)
        for go, wo in zip(g.observations, w.observations):
            assert set(go) == set(wo)
            close([go[k] for k in wo], [wo[k] for k in wo], atol)
        for k in w.summary:
            close(g.summary[k], w.summary[k], atol)
            close(g.reference_deltas[k], w.reference_deltas[k], atol)


def test_path_tracking_suite_matches_jax_and_seed_lanes_are_solo():
    seeds, steps = (0, 1), 20
    want = jpt.run_path_tracking_accuracy(seeds=seeds, steps=steps)
    draws = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(s), (2,), minval=-1.0,
                                                    maxval=1.0)) for s in seeds])
    got = tpt.run_path_tracking_accuracy(seeds=seeds, steps=steps, draws=draws, dtype=F64,
                                         device="cpu")
    _reports_equal(got, want)
    assert got[0].reference_deltas["mean_cross_track_rmse"] == 0.0
    pts, mask = tpt._course("chicane", dtype=F64)
    fleet = tpt._rollout(torch.tensor(draws), pts, mask, "lqr_steer", 12)
    for i in range(2):
        solo = tpt._rollout(torch.tensor(draws[i:i + 1]), pts, mask, "lqr_steer", 12)
        assert all(torch.equal(fleet[k][i:i + 1], solo[k]) for k in fleet)


def _family_draws(key, steps, n):
    """JAX's noise streams of `simulate_family_rmse` for one family."""

    def one(k):
        ks = jax.random.split(k, 6)
        return (jax.random.normal(ks[0], (steps,)), jax.random.normal(ks[1], (steps,)),
                jax.random.normal(ks[2], (steps, 4)), jax.random.normal(ks[3], (steps, 2)),
                jax.random.uniform(ks[4], (steps,)))

    out = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return tuk.FamilyDraws(*(torch.tensor(np.asarray(x)) for x in out))


MIXED = dict(control_latency_steps=2, observation_refresh_interval=3,
             observation_outlier_probability=0.2, true_yaw_wave_deg=20.0, control_bias_v=0.15)


def test_ukf_ckf_suite_matches_jax():
    """One family that mixes the latency, biased-control, yaw-wave,
    sparse-observation and outlier families' settings (one JAX compile)."""
    steps, n = 16, 8
    want = juk.run_ukf_ckf_accuracy(seed=0, families={"mixed": juk.MotionProfile(**MIXED)},
                                    steps=steps, n_scenarios=n, buckets=(4, 8))
    draws = {"mixed": _family_draws(jax.random.PRNGKey(0), steps, n)}
    got = tuk.run_ukf_ckf_accuracy(seed=0, families={"mixed": tuk.MotionProfile(**MIXED)},
                                   steps=steps, n_scenarios=n, buckets=(4, 8), draws=draws,
                                   dtype=F64, device="cpu")
    assert set(got) == set(want) == {"full_coverage", "strided_2", "strided_4", "head_8",
                                     "escalating"}
    for v in want:
        assert len(got[v]) == len(want[v]) == 2
        for g, w in zip(got[v], want[v]):
            for k in ("family_name", "bucket", "total_scenarios", "selected_slots", "escalated",
                      "ckf_wins"):
                assert getattr(g, k) == getattr(w, k), (v, k)
            for k in ("ukf_bucket_median_rmse", "ckf_bucket_median_rmse", "ukf_min_rmse",
                      "ukf_max_rmse", "ckf_min_rmse", "ckf_max_rmse"):
                close(getattr(g, k), getattr(w, k))
            assert g.winner() == w.winner() and g.coverage_ratio() == w.coverage_ratio()
    nominal = tuk.simulate_family_rmse(tuk.SCENARIO_FAMILIES["nominal"], 20, 4,
                                       generator=torch.Generator().manual_seed(0), dtype=F64,
                                       device="cpu")
    assert all(float(e.max()) < 1.0 for e in nominal)  # both filters track


def test_drone_quality_suite_matches_jax():
    """The suite's minimum-snap flight (drone_quality.py's own closed loop)
    against JAX's jitted flight, and both variants' metrics through JAX's
    `_metrics` (the quintic flight is control/aerial.py's, held in
    tests/test_torch_aerial_meta_arena.py)."""
    seed = 0
    wps = jax.jit(jdq._waypoints)(jax.random.PRNGKey(seed))
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (1, 5, 3), minval=-1.0,
                                          maxval=1.0))
    twps = tdq._waypoints(torch.tensor(draws[0]))
    np.testing.assert_array_equal(twps.numpy(), np.asarray(wps))
    jps, jrefs = jax.jit(jdq._fly_min_snap)(wps)
    tps, trefs = tdq._fly_min_snap(twps)
    close(tps, jps, 1e-9)
    close(trefs, jrefs, 1e-9)
    got = tdq.run_drone_trajectory_quality(seeds=(seed,), draws=draws, dtype=F64, device="cpu")
    by = {r.variant.name: r for r in got}
    assert set(by) == {"quintic", "min_snap"}
    flights = {"min_snap": (jps, jrefs),
               "quintic": tuple(jnp.asarray(x.numpy()) for x in tdq._fly_quintic(twps))}
    for name, (ps, refs) in flights.items():
        for k, v in jdq._metrics(ps, refs).items():
            close(by[name].observations[0][k], v, 1e-9 * max(1.0, abs(v)))
    assert by["min_snap"].summary["mean_jerk"] <= by["quintic"].summary["mean_jerk"] * 5.0


@functools.partial(jax.jit, static_argnums=(2, 3))
def _slot_draws(keys, lo, n, n_out):
    """`_generate_cell_clouds`' draws for each slot key (lo: the low end of
    the structure uniforms)."""

    def one(k):
        ks, kc, ko, kb = jax.random.split(k, 4)
        ks2, kj = jax.random.split(ks)
        kd1, kd2 = jax.random.split(kb)
        return {"structure": jax.random.uniform(ks2, (n, 3), minval=lo, maxval=1.0),
                "jitter": jax.random.normal(kj, (n, 3)), "extra": jax.random.normal(kc, (n, 3)),
                "drop": jax.random.uniform(ko, (n,)),
                "outliers": jax.random.uniform(kb, (n_out, 3), minval=-1.0, maxval=1.0),
                "dup_src": jax.random.randint(kd1, (n_out,), 0, n),
                "dup_noise": jax.random.normal(kd2, (n_out, 3))}

    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnums=(2,))
def _poisson_draws(keys, valid, max_iter):
    """`_score_cloud`'s Poisson draws (first, candidates) for each slot key."""

    def one(kp, v):
        k0, kseq = jax.random.split(kp)
        return (jax.random.categorical(k0, jnp.log(jnp.where(v, 1.0, 0.0) + 1e-30)),
                jax.random.randint(kseq, (max_iter,), 0, v.shape[0]))

    return jax.vmap(lambda k, v: jax.vmap(one, (0, None))(jax.random.split(k, 6), v))(keys,
                                                                                      valid)


def _cell_draws(key, case, bucket, n_slots, max_iter):
    """JAX's splits of one (case, bucket) cell, as `CellDraws`."""
    name_tag = zlib.crc32(case.family_name.encode()) % (2**31)
    kgen, kscore = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, name_tag), bucket))
    _, valid = jpc._generate_cell_clouds(kgen, case, bucket, n_slots)
    out = _slot_draws(jax.random.split(kgen, n_slots), -1.0 if case.kind == "twin_cluster"
                      else 0.0, case.base_point_count, tpc._n_out_max(case))
    first, cands = _poisson_draws(jax.random.split(kscore, n_slots), valid, max_iter)
    keep = {"structure": case.kind != "layered_plane",
            "dup_src": case.corruption == "density_shift",
            "dup_noise": case.corruption == "density_shift"}
    draws = {k: torch.tensor(np.asarray(v)) if keep.get(k, True) else None for k, v in out.items()}
    return tpc.CellDraws(**draws, poisson_first=torch.tensor(np.asarray(first)),
                         poisson_cands=torch.tensor(np.asarray(cands)))


def _port_case(case):
    return tpc.CloudCase(**{f: getattr(case, f) for f in case.__dataclass_fields__})


# two cells of one cloud size (96 + 9 outlier slots), so that JAX's
# scoring and draw programs compile once: tests/test_experiments.py's
# density shift, and a ring with a burst slot (more outliers) and a sector
# drop
PROBLEMS = {
    "density_shift": [jpc.CloudCase(
        "twin_density", (24,), kind="twin_cluster", base_point_count=96,
        corruption="density_shift", corruption_axis=0, corruption_center=-7.0,
        corruption_half_width=4.0, dense_duplicate_probability=0.5,
        sparse_keep_probability=0.55)],
    "sparse_outlier_burst": [jpc.CloudCase(
        "ring_det", (24,), kind="ring", base_point_count=96, base_outlier_fraction=0.03,
        burst_slots=(1,), burst_noise_scales=(0.3, 0.3, 0.2), burst_outlier_multiplier=4 / 3,
        corruption="sector_drop", sector_start=0.4, sector_end=1.8, drop_probability=0.9)],
}
SLOTS, MAX_ITER = 3, 96


@functools.lru_cache(maxsize=None)
def jax_suite():
    key = jax.random.PRNGKey(0)
    cells = {(c.family_name, b): c for v in PROBLEMS.values() for c in v for b in c.buckets}
    scores = {k: np.asarray(jpc.slot_scores_for_cell(key, c, k[1], SLOTS, max_iter=MAX_ITER))
              for k, c in cells.items()}
    draws = {k: _cell_draws(key, c, k[1], SLOTS, MAX_ITER) for k, c in cells.items()}
    report = jpc.run_point_cloud_sampling_quality(0, problems=PROBLEMS, scenarios_per_bucket=SLOTS,
                                                  max_iter=MAX_ITER)
    return cells, draws, scores, report


@pytest.mark.parametrize("family", ["ring_det", "twin_density"])
def test_cell_clouds_and_scores_match_jax_given_its_draws(family):
    cells, draws, scores, _ = jax_suite()
    (name, bucket), case = next((k, c) for k, c in cells.items() if k[0] == family)
    got = tpc.slot_scores_for_cell(_port_case(case), bucket, SLOTS, max_iter=MAX_ITER,
                                   draws=draws[name, bucket], dtype=F64, device="cpu")
    close(got, scores[name, bucket])
    kgen = jax.random.split(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), zlib.crc32(name.encode()) % (2**31)), bucket))[0]
    jp, jv = jpc._generate_cell_clouds(kgen, case, bucket, SLOTS)
    tp, tv = tpc._generate_cell_clouds(_port_case(case), bucket, draws[name, bucket])
    close(tp, jp, 1e-12)
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_score_sample_quality_matches_jax():
    g = np.linspace(-5, 5, 8)
    pts = np.concatenate([np.stack(np.meshgrid(g, g), -1).reshape(-1, 2), np.zeros((64, 1))], 1)
    valid = np.arange(64) < 60
    sels = np.stack([np.arange(64) % 4 == 0, np.arange(64) < 16, np.arange(64) == 5,
                     np.zeros(64, bool)])
    score = jax.jit(jax.vmap(jpc.score_sample_quality, (None, None, 0, None)), static_argnums=3)
    want = score(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(sels), 16)
    got = tpc.score_sample_quality(torch.tensor(pts), torch.tensor(valid), torch.tensor(sels), 16)
    close(got, want, 1e-12)
    assert float(got[0]) < float(got[1]) and got[3] == np.inf


def test_point_cloud_suite_matches_jax():
    cells, draws, _, want = jax_suite()
    got = tpc.run_point_cloud_sampling_quality(
        0, problems={k: [_port_case(c) for c in v] for k, v in PROBLEMS.items()},
        scenarios_per_bucket=SLOTS, max_iter=MAX_ITER, draws=draws, dtype=F64, device="cpu")
    assert set(got) == set(want)
    for name in want:
        for k in ("agreement_vs_reference", "average_coverage_ratio"):
            assert got[name][k] == want[name][k], (name, k)
        close(got[name]["mean_ratio_error_vs_reference"],
              want[name]["mean_ratio_error_vs_reference"])
        for g, w in zip(got[name]["observations"], want[name]["observations"]):
            for k in ("family_name", "bucket", "total_scenarios", "initial_slots",
                      "selected_slots", "escalated", "wins"):
                assert getattr(g, k) == getattr(w, k), (name, k)
            for k in ("median_scores", "min_scores", "max_scores"):
                close(getattr(g, k), getattr(w, k))
            assert g.winner() == w.winner()
    assert got["first-scenario"]["average_coverage_ratio"] == 1 / SLOTS
