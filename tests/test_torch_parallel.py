"""The port's mesh, collectives, accounting, systolic pipeline and ring-halo
scan odometry (rust_robotics_tpu_torch/parallel/) against JAX.

The SPMD programs run on 2 and 4 gloo ranks, spawned once per mesh size
(tests/torch_dist_workers.py). The pipeline and the scan odometry must
equal the port's one-process functions bitwise, and JAX's same program on
a mesh of the same size of conftest's virtual CPU devices within 1e-10 in
f64 and within the JAX dryrun's tolerances in f32 (pipeline rtol/atol
1e-6, scan rtol 1e-4 / atol 1e-5, `__graft_entry__.py::dryrun_multichip`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_workers as workers
from rust_robotics_tpu.parallel import accounting as jacc
from rust_robotics_tpu.parallel.pipeline import pipeline_shard_map as jax_pipeline
from rust_robotics_tpu.parallel.sharded_scan import (
    compose_trajectory as jax_compose,
    make_sharded_scan_odometry as jax_scan_odometry,
    se2_compose as jax_se2_compose,
    shard_scans as jax_shard_scans,
)
from rust_robotics_tpu_torch.parallel import accounting as tacc
from rust_robotics_tpu_torch.parallel import mesh as pmesh
from rust_robotics_tpu_torch.parallel.sharded_scan import compose_trajectory, se2_compose

WORLDS = (2, 4)
ITERATIONS = 8
RTOL_F64 = 1e-10


def _scans(t=16, m=96):
    """tests/test_sharded_scan.py's scan sequence, f64: a fixed point cloud
    seen from a slowly moving SE(2) trajectory."""
    world = 4.0 * jax.random.uniform(jax.random.PRNGKey(7), (m, 2), dtype=jnp.float64) - 2.0
    steps = jnp.arange(t, dtype=jnp.float64)

    def view(x, y, yaw):
        c, s = jnp.cos(yaw), jnp.sin(yaw)
        return (world - jnp.array([x, y])) @ jnp.array([[c, s], [-s, c]]).T

    return np.asarray(jax.vmap(view)(0.05 * steps, 0.02 * jnp.sin(0.3 * steps), 0.03 * steps))


XS = np.arange(32, dtype=np.float64).reshape(8, 4) / 7.0
SCANS = _scans()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: workers.run_spmd(workers.parallel_program, w, tmp_path_factory.mktemp("par"), XS,
                                SCANS, ITERATIONS) for w in WORLDS}


@functools.lru_cache(maxsize=None)
def _jax_runs(n, dtype_name):
    dtype = getattr(jnp, dtype_name)
    devs = np.asarray(jax.devices()[:n])

    def stage(k, x):
        return jnp.tanh(x * (k + 1.5)) + k

    pipe = np.asarray(jax_pipeline(stage, jnp.asarray(XS, dtype), Mesh(devs, ("pipe",))))
    mesh = Mesh(devs, ("data",))
    rel, absolute = jax_scan_odometry(mesh, iterations=ITERATIONS)(
        jax_shard_scans(mesh, jnp.asarray(SCANS, dtype)))
    return pipe, np.asarray(rel), np.asarray(absolute)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shape_and_collectives(runs, world):
    data, model = (world // 2, 2) if world == 4 else (world, 1)
    for rank, out in enumerate(runs[world]):
        assert out["shape"] == (data, model)
        d, m = out["coords"]
        assert (d, m) == divmod(rank, model)  # row-major, as devices.reshape(data, model)
        x = lambda r: torch.arange(3, dtype=torch.float64) + 10.0 * r  # noqa: E731
        col = [dd * model + m for dd in range(data)]
        assert torch.equal(out["psum_data"], sum(x(r) for r in col))
        assert torch.equal(out["psum_both"], sum(x(r) for r in range(world)))
        assert torch.equal(out["gather_data"], torch.stack([x(r) for r in col]))
        assert torch.equal(out["ring_left"], x(col[(d + 1) % data]))
        want = x(col[0]) if d == data - 1 else torch.zeros(3, dtype=torch.float64)
        assert torch.equal(out["partial"], want)
        assert torch.equal(out["bcast"], x(col[-1]))
        assert out["roundtrip0"] and out["roundtrip1"]


def test_one_rank_ring_is_a_local_copy():
    def program():
        mesh = pmesh.make_mesh(axis_names=("pipe",), device_type="cpu")
        x = torch.arange(4.0)
        return (pmesh.ppermute(x, mesh, "pipe", [(0, 0)]), pmesh.all_gather(x, mesh, "pipe"),
                pmesh.psum(x, mesh, "pipe"), pmesh.broadcast(x, mesh, "pipe", 0))

    ring, gathered, summed, bcast = workers.run_one_process(program)
    x = torch.arange(4.0)
    assert torch.equal(ring, x) and torch.equal(gathered, x[None])
    assert torch.equal(summed, x) and torch.equal(bcast, x)


def test_accounting_equals_jax():
    for ns, b, d, r in ((10000, 3, 8, 3), (333, 6, 4, 12), (100, 300, 2, 1)):
        for kw in ({}, {"dense_interface_max": 8, "dtype_bytes": 8}):
            assert tacc.spike_accounting(ns, b, d, r, **kw) == tuple(
                jacc.spike_accounting(ns, b, d, r, **kw))
            assert tacc.lm_iteration_flops(ns, b, d, r, 16, 4, **kw) == jacc.lm_iteration_flops(
                ns, b, d, r, 16, 4, **kw)
    assert tacc.ladder_factor_flops(7, 3) == jacc.ladder_factor_flops(7, 3)
    assert tacc.ladder_apply_flops(7, 3, 2) == jacc.ladder_apply_flops(7, 3, 2)


def test_se2_compose_and_trajectory_equal_jax():
    rng = np.random.default_rng(0)
    a, b = 0.3 * rng.standard_normal((2, 5, 3))
    np.testing.assert_allclose(se2_compose(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_se2_compose(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-14)
    rel = 0.1 * rng.standard_normal((13, 3))
    np.testing.assert_allclose(compose_trajectory(torch.from_numpy(rel)).numpy(),
                               np.asarray(jax_compose(jnp.asarray(rel))), rtol=0, atol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_equals_composition_and_jax(runs, world):
    for out in runs[world]:
        for name, tol in (("f64", RTOL_F64), ("f32", 1e-6)):
            got = out[f"pipe_{name}"]
            assert got.shape == XS.shape
            assert torch.equal(got, out[f"pipe_direct_{name}"]), name
            want, _, _ = _jax_runs(world, "float64" if name == "f64" else "float32")
            np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_scan_odometry_equals_serial_and_jax(runs, world):
    first = runs[world][0]
    for out in runs[world]:
        for name, (rtol, atol) in (("f64", (RTOL_F64, RTOL_F64)), ("f32", (1e-4, 1e-5))):
            rel, absolute = out[f"scan_{name}"]
            rel_s, abs_s = out[f"scan_serial_{name}"]
            assert rel.shape == (SCANS.shape[0] - 1, 3)
            assert torch.equal(rel, rel_s) and torch.equal(absolute, abs_s), name
            assert torch.equal(rel, first[f"scan_{name}"][0])  # the same on every rank
            _, jrel, jabs = _jax_runs(world, "float64" if name == "f64" else "float32")
            np.testing.assert_allclose(rel.numpy(), jrel, rtol=rtol, atol=atol, err_msg=name)
            np.testing.assert_allclose(absolute.numpy(), jabs, rtol=rtol, atol=atol, err_msg=name)
    # the composed trajectory tracks the simulated motion (x = 0.05 t, yaw = 0.03 t)
    final = first["scan_f64"][1][-1]
    assert abs(float(final[0]) - 0.75) < 0.02 and abs(float(final[2]) - 0.45) < 0.02
