"""`mapping/` (occupancy, distance, ndt, gp, gaussian_map, cluster, lines)
against the JAX package's, on numpy inputs made from a seed: JAX on the
CPU at x64, torch in float64 on the CPU.

Tolerances: integer, bool and label outputs (cells, masks, labels, sample
indices, breakpoints) are held exactly; floats at 1e-10 (sums of at most
~10^3 terms of O(1), whose order differs between XLA and torch; 1e-13 or
0 measured). The UDF also equals scipy's `distance_transform_edt`
exactly. `random_sample` and `poisson_disk_sample` take JAX's own draws.
Normals are compared up to sign (an eigenvector's sign is arbitrary in
both packages): |n·n_jax| within 1e-10 of 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from rust_robotics_tpu.core.types import GridSpec2D as JGridSpec2D
from rust_robotics_tpu.mapping import cluster as jc
from rust_robotics_tpu.mapping import distance as jd
from rust_robotics_tpu.mapping import gaussian_map as jgm
from rust_robotics_tpu.mapping import gp as jgp
from rust_robotics_tpu.mapping import lines as jl
from rust_robotics_tpu.mapping import ndt as jn
from rust_robotics_tpu.mapping import occupancy as jo
from rust_robotics_tpu_torch.core.types import GridSpec2D
from rust_robotics_tpu_torch.mapping import cluster as tc
from rust_robotics_tpu_torch.mapping import distance as td
from rust_robotics_tpu_torch.mapping import gaussian_map as tgm
from rust_robotics_tpu_torch.mapping import gp as tgp
from rust_robotics_tpu_torch.mapping import lines as tl
from rust_robotics_tpu_torch.mapping import ndt as tn
from rust_robotics_tpu_torch.mapping import occupancy as to

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-10
F64 = torch.float64


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# occupancy
# ---------------------------------------------------------------------------

SPEC = dict(min_x=-5.0, min_y=-4.0, resolution=0.25, width=40, height=36)


@functools.lru_cache(maxsize=None)
def scan(seed, beams=90):
    r = rng(seed)
    angles = np.linspace(-np.pi, np.pi, beams, endpoint=False)
    ranges = r.uniform(0.5, 6.0, beams)
    ranges[::7] = 6.0  # max-range beams carve free space only
    return np.array([0.3, -0.2]), angles, ranges


BOUNDARY = np.array([[0.3, 0.7], [-0.3, 2.3], [0.6, 1.1]])  # x/0.1 != x·(1/0.1) here


def test_grid_spec_world_to_index_divides_as_jax():
    """A point on a cell boundary stays in the cell JAX puts it in (ROADMAP
    C9: CUDA's division by a number multiplied by its reciprocal)."""
    spec = dict(min_x=0.0, min_y=0.0, resolution=0.1, width=50, height=50)
    want = np.asarray(JGridSpec2D(**spec).world_to_index(jnp.asarray(BOUNDARY)))
    assert (want != np.floor(BOUNDARY * (1 / 0.1))).any()
    exact(GridSpec2D(**spec).world_to_index(t64(BOUNDARY)), want)


@pytest.mark.cuda
def test_grid_spec_world_to_index_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = GridSpec2D(min_x=0.0, min_y=0.0, resolution=0.1, width=50, height=50)
    for dt in (torch.float32, F64):
        xy = torch.tensor(BOUNDARY, dtype=dt)
        assert torch.equal(spec.world_to_index(xy.cuda()).cpu(), spec.world_to_index(xy))


@pytest.mark.parametrize("max_range", [None, 6.0])
def test_lidar_to_grid_matches_jax(max_range):
    origin, angles, ranges = scan(0)
    want = jax.jit(jo.lidar_to_grid, static_argnums=(3, 4, 5, 6))(
        jnp.asarray(origin), jnp.asarray(angles), jnp.asarray(ranges), JGridSpec2D(**SPEC),
        max_range, jo.OccupancyGridConfig(), 64)
    got = to.lidar_to_grid(origin, angles, ranges, GridSpec2D(**SPEC), max_range=max_range,
                           samples=64, device="cpu", dtype=F64)
    close(got, want)
    assert np.unique(np.asarray(want)).size > 3
    close(to.occupancy_probability(got), jo.occupancy_probability(want))
    # host data and tensors alike; the same bits on a second call
    again = to.lidar_to_grid(t64(origin), t64(angles), t64(ranges), GridSpec2D(**SPEC),
                             max_range=max_range, samples=64)
    assert again.dtype == F64 and torch.equal(again, got)


def test_raycast_update_matches_jax():
    origin, angles, ranges = scan(1)
    end = origin + np.stack([ranges * np.cos(angles), ranges * np.sin(angles)], -1)
    prior = rng(2).uniform(-4.9, 4.9, (SPEC["width"], SPEC["height"]))
    hit = ranges < 6.0
    want = jax.jit(jo.raycast_update, static_argnums=(3, 5, 6))(
        jnp.asarray(prior), jnp.asarray(origin), jnp.asarray(end), JGridSpec2D(**SPEC),
        jnp.asarray(hit), jo.OccupancyGridConfig(), 48)
    got = to.raycast_update(t64(prior), t64(origin), t64(end), GridSpec2D(**SPEC),
                            torch.tensor(hit), samples=48)
    close(got, want)


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(23, 17), (2, 9, 12)])
def test_distance_fields_match_jax_and_scipy(shape):
    obs = rng(3).random(shape) < 0.08
    obs[..., 0, 0] = True
    close(td.squared_edt(torch.tensor(obs), F64), jd.squared_edt(jnp.asarray(obs)), 0.0)
    udf = td.compute_udf(torch.tensor(obs), F64)
    close(udf, jd.compute_udf(jnp.asarray(obs)), 0.0)
    close(td.compute_sdf(torch.tensor(obs), F64), jd.compute_sdf(jnp.asarray(obs)), 0.0)
    for k, o in enumerate(obs.reshape(-1, *shape[-2:])):
        close(udf.reshape(-1, *shape[-2:])[k], ndimage.distance_transform_edt(~o), 0.0)
    # float32's squared distances are exact too
    close(td.squared_edt(torch.tensor(obs)), td.squared_edt(torch.tensor(obs), F64), 0.0)


# ---------------------------------------------------------------------------
# NDT
# ---------------------------------------------------------------------------

def test_ndt_grid_and_score_match_jax():
    r = rng(4)
    centers = r.uniform(0.0, 8.0, (12, 2))
    pts = (centers[r.integers(0, 12, 600)] + 0.3 * r.standard_normal((600, 2)))
    want = jax.jit(jn.ndt_grid, static_argnums=(1, 2, 3, 4))(jnp.asarray(pts), (0.0, 0.0), 0.5,
                                                             16, 16)
    got = tn.ndt_grid(t64(pts), (0.0, 0.0), 0.5, 16, 16)
    for g, w in zip(got, want):
        close(g, w)
    assert got[2].dtype == torch.float32 and int(np.asarray(want[3]).sum()) > 20
    q = pts[::3] + 0.05 * r.standard_normal((200, 2))
    close(tn.ndt_score(t64(q), *got[:2], got[3], (0.0, 0.0), 0.5),
          jax.jit(jn.ndt_score, static_argnums=(4, 5))(jnp.asarray(q), *want[:2], want[3],
                                                      (0.0, 0.0), 0.5))


# ---------------------------------------------------------------------------
# GP and the Gaussian grid map
# ---------------------------------------------------------------------------

def test_gp_regression_matches_jax():
    r = rng(5)
    x = r.uniform(-3.0, 3.0, (40, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.01 * r.standard_normal(40)
    q = r.uniform(-4.0, 4.0, (70, 2))
    close(tgp.rbf_kernel(t64(x), t64(q), 0.8, 1.3), jgp.rbf_kernel(x, q, 0.8, 1.3))
    kw = dict(length_scale=0.9, signal_var=1.2, noise_var=1e-3)
    want = jax.jit(functools.partial(jgp.gp_regression, **kw))(x, y, q)
    got = tgp.gp_regression(t64(x), t64(y), t64(q), **kw)
    close(got[0], want[0])
    close(got[1], want[1])


def test_gaussian_grid_map_matches_jax():
    r = rng(6)
    ox, oy = r.uniform(-3.0, 3.0, (2, 15))
    want = jgm.gaussian_grid_map(jnp.asarray(ox), jnp.asarray(oy), 0.4, 0.7, extend=2.0)
    got = tgm.gaussian_grid_map(ox, oy, 0.4, 0.7, extend=2.0, device="cpu", dtype=F64)
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# clustering, fitting, normals, sampling
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def blobs(seed, n=60, k=3, dim=2):
    r = rng(seed)
    centers = r.uniform(-6.0, 6.0, (k, dim))
    pts = centers[np.arange(n) % k] + 0.4 * r.standard_normal((n, dim))
    return pts, centers


def test_kmeans_matches_jax():
    pts, centers = blobs(7, 90, 4)
    init = centers + 1.0
    want = jax.jit(jc.kmeans, static_argnums=2)(jnp.asarray(pts), jnp.asarray(init), 12)
    got = tc.kmeans(t64(pts), t64(init), 12)
    close(got[0], want[0])
    exact(got[1], want[1])


@pytest.mark.parametrize("eps,min_points", [(0.6, 3), (1.2, 5)])
def test_dbscan_matches_jax(eps, min_points):
    pts, _ = blobs(8, 80, 3)
    pts = np.concatenate([pts, [[20.0, -20.0], [21.0, 20.0]]])
    want = jc.dbscan(jnp.asarray(pts), eps, min_points)
    got = tc.dbscan(t64(pts), eps, min_points)
    exact(got, want)
    assert (np.asarray(want) == -1).any() and len(np.unique(np.asarray(want))) > 2


def test_fit_circle_and_rectangle_match_jax():
    r = rng(9)
    th = r.uniform(0.0, 2.0 * np.pi, 50)
    circ = np.stack([2.0 + 1.5 * np.cos(th), -1.0 + 1.5 * np.sin(th)], -1)
    circ += 0.02 * r.standard_normal(circ.shape)
    for g, w in zip(tc.fit_circle(t64(circ)), jc.fit_circle(jnp.asarray(circ))):
        close(g, w)
    rot = np.array([[np.cos(0.4), -np.sin(0.4)], [np.sin(0.4), np.cos(0.4)]])
    xs, ys = np.linspace(0, 2, 20), np.linspace(0, 1, 10)
    ell = np.concatenate([np.stack([xs, 0 * xs], -1), np.stack([0 * ys, ys], -1)]) @ rot.T
    for pts in (ell, ell + 0.01 * r.standard_normal(ell.shape)):
        want = jax.jit(jc.fit_rectangle)(jnp.asarray(pts))
        got = tc.fit_rectangle(t64(pts))
        close(got[0], want[0])
        close(got[1], want[1])


def test_estimate_normals_match_jax_up_to_sign():
    r = rng(10)
    xy = r.uniform(0.0, 4.0, (70, 2))
    pts = np.concatenate([xy, (0.3 * xy[:, :1] - 0.1 * xy[:, 1:]
                               + 0.01 * r.standard_normal((70, 1)))], -1)
    pts[5] = pts[6]  # a duplicate: equal distances, the lower index first
    want = np.asarray(jc.estimate_normals(jnp.asarray(pts), k=6))
    got = tc.estimate_normals(t64(pts), k=6).numpy()
    close(np.abs(np.sum(got * want, -1)), np.ones(70))
    close(np.linalg.norm(got, axis=-1), np.ones(70))


def test_sampling_matches_jax():
    r = rng(11)
    pts = r.uniform(0.0, 10.0, (120, 3))
    exact(tc.voxel_sample_mask(t64(pts), 2.0), jc.voxel_sample_mask(jnp.asarray(pts), 2.0))
    valid = r.random(120) > 0.2
    fps = jax.jit(jc.farthest_point_sample, static_argnums=(1, 2))
    for v in (None, valid):
        want = fps(jnp.asarray(pts), 17, 3, None if v is None else jnp.asarray(v))
        got = tc.farthest_point_sample(t64(pts), 17, start=3,
                                       valid=None if v is None else torch.tensor(v))
        exact(got, want)
        assert got.dtype == torch.int32
    key = jax.random.PRNGKey(3)
    want = jc.random_sample(key, jnp.asarray(pts), 25)
    draws = torch.tensor(np.asarray(jax.random.permutation(key, 120)))
    exact(tc.random_sample(t64(pts), 25, draws=draws), want)
    assert tc.random_sample(t64(pts), 25, generator=torch.Generator().manual_seed(0)).unique(
        ).numel() == 25


@pytest.mark.parametrize("use_valid", [False, True])
def test_poisson_disk_sample_matches_jax(use_valid):
    r = rng(12)
    pts = r.uniform(0.0, 10.0, (150, 2))
    valid = r.random(150) > 0.3 if use_valid else np.ones(150, bool)
    key = jax.random.PRNGKey(5)
    args = (20, 1.2, 80)
    want = jax.jit(jc.poisson_disk_sample, static_argnums=(2, 4))(
        key, jnp.asarray(pts), *args, jnp.asarray(valid) if use_valid else None)
    # JAX's own draws (poisson_disk_sample's split and draws)
    k0, kseq = jax.random.split(key)
    first = jax.random.categorical(k0, jnp.log(jnp.where(jnp.asarray(valid), 1.0, 0.0) + 1e-30))
    cands = jax.random.randint(kseq, (args[2],), 0, 150)
    draws = (torch.tensor(int(first)), torch.tensor(np.asarray(cands)))
    got = tc.poisson_disk_sample(t64(pts), *args, valid=torch.tensor(valid) if use_valid else None,
                                 draws=draws)
    exact(got, want)
    assert 5 < int(np.asarray(want).sum()) <= 20
    gen = tc.poisson_disk_sample(t64(pts), *args, valid=torch.tensor(valid),
                                 generator=torch.Generator().manual_seed(1))
    assert not (gen & ~torch.tensor(valid)).any()


# ---------------------------------------------------------------------------
# lines
# ---------------------------------------------------------------------------

def polyline_scan(seed, n=120):
    """An ordered scan along three walls with noise."""
    r = rng(seed)
    corners = np.array([[0.0, 0.0], [4.0, 0.0], [4.0, 3.0], [1.0, 5.0]])
    t = np.linspace(0.0, 3.0, n)
    seg = np.minimum(t.astype(int), 2)
    frac = t - seg
    pts = corners[seg] + frac[:, None] * (corners[seg + 1] - corners[seg])
    return pts + 0.01 * r.standard_normal(pts.shape)


@pytest.mark.parametrize("seed", [13, 14])
def test_split_and_merge_matches_jax(seed):
    pts = polyline_scan(seed)
    want = jax.jit(jl.split_and_merge)(jnp.asarray(pts))
    got = tl.split_and_merge(t64(pts))
    exact(got, want)
    assert 4 <= int(np.asarray(want).sum()) < 20
    segs, want_segs = tl.segments_from_breaks(t64(pts), got), jl.segments_from_breaks(pts, want)
    assert len(segs) == len(want_segs)
    for (a, b), (c, d) in zip(segs, want_segs):
        close(a, c, 0.0)
        close(b, d, 0.0)


def test_imls_matches_jax():
    r = rng(15)
    th = np.linspace(0.0, np.pi, 40)
    pts = np.stack([np.cos(th), np.sin(th)], -1)
    normals = pts.copy()
    q = r.uniform(-1.5, 1.5, (25, 2))
    close(tl.imls_distance(t64(q), t64(pts), t64(normals), 0.4),
          jl.imls_distance(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(normals), 0.4))
    project = jax.jit(jl.imls_project, static_argnums=3)
    for p0 in ([0.2, 1.4], [0.9, 0.3]):
        want = project(jnp.asarray(p0), jnp.asarray(pts), jnp.asarray(normals), 0.4)
        got = tl.imls_project(t64(p0), t64(pts), t64(normals), 0.4)
        close(got, want)


@pytest.mark.cuda
def test_lidar_to_grid_cuda_equals_cpu():
    """The same cells on both devices, and two calls on the card bitwise;
    the values within 1e-12: CUDA's sort-based scatter may sum a cell's
    repeated −0.4s in another order than the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    origin, angles, ranges = scan(0)
    want = to.lidar_to_grid(origin, angles, ranges, GridSpec2D(**SPEC), max_range=6.0,
                            device="cpu", dtype=F64)
    got = to.lidar_to_grid(origin, angles, ranges, GridSpec2D(**SPEC), max_range=6.0,
                           dtype=F64)
    again = to.lidar_to_grid(origin, angles, ranges, GridSpec2D(**SPEC), max_range=6.0,
                             dtype=F64)
    assert got.is_cuda and torch.equal(got, again)
    assert torch.equal(got.cpu() != 0, want != 0)
    close(got.cpu(), want, 1e-12)
