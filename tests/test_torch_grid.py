"""Occupancy grids: the port's `planning.grid` against the JAX package's on
the same numpy inputs made from a seed, exact. Obstacle coordinates are
multiples of 1/8, so every distance term is exact in float64 and cells on
the inflation radius fall on the same side in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import grid as jgrid
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.planning import grid as tgrid

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = dict(device="cpu", dtype=torch.float64)


def assert_same_grid(got, want):
    np.testing.assert_array_equal(got.blocked.numpy(), np.asarray(want.blocked))
    for name in ("min_x", "min_y", "resolution"):
        assert float(getattr(got, name)) == float(getattr(want, name)), name
    assert (got.x_width, got.y_width) == (want.x_width, want.y_width)


@pytest.mark.parametrize("min_x,min_y,res", [(0.0, 0.0, 1.0), (-3.5, 2.25, 0.5)])
def test_grid_from_raster_and_index_maps(min_x, min_y, res):
    rng = np.random.default_rng(0)
    blocked = rng.uniform(size=(13, 9)) < 0.3
    want = jgrid.grid_from_raster(jnp.asarray(blocked), min_x, min_y, res)
    got = tgrid.grid_from_raster(blocked, min_x, min_y, res, **F64)
    assert_same_grid(got, want)
    np.testing.assert_array_equal(got.free().numpy(), np.asarray(want.free()))
    # points on cell corners, random points, and exact half-cell ties
    # (round half to even in both packages)
    k = rng.integers(-2, 15, size=(40, 2)).astype(np.float64)
    xy = np.concatenate([
        np.array([min_x, min_y]) + res * k,
        np.array([min_x, min_y]) + res * (k + 0.5),
        rng.uniform(-5.0, 10.0, size=(40, 2)),
    ])
    idx_want = np.asarray(want.world_to_index(jnp.asarray(xy)))
    idx_got = got.world_to_index(torch.from_numpy(xy))
    assert idx_got.dtype == torch.int32
    np.testing.assert_array_equal(idx_got.numpy(), idx_want)
    np.testing.assert_array_equal(
        got.index_to_world(idx_got).numpy(),
        np.asarray(want.index_to_world(jnp.asarray(idx_want))))


@pytest.mark.parametrize("res,radius,tile", [(1.0, 1.5, 4096), (0.5, 1.0, 7), (0.25, 0.75, 64)])
def test_grid_from_obstacle_points(res, radius, tile):
    rng = np.random.default_rng(1)
    # a walled 12x10 box plus scattered points, all multiples of 1/8
    wall_x = np.concatenate([np.arange(0, 12.5, 0.5), np.full(21, 12.0), np.zeros(21)])
    wall_y = np.concatenate([np.zeros(25), np.arange(0, 10.5, 0.5), np.arange(0, 10.5, 0.5)])
    ox = np.concatenate([wall_x, rng.integers(0, 96, 15) / 8.0])
    oy = np.concatenate([wall_y, rng.integers(0, 80, 15) / 8.0])
    want = jgrid.grid_from_obstacle_points(jnp.asarray(ox), jnp.asarray(oy), res, radius)
    got = tgrid.grid_from_obstacle_points(ox, oy, res, radius, tile=tile, **F64)
    assert_same_grid(got, want)
    assert got.blocked.any() and not got.blocked.all()


def test_grid_from_obstacle_points_rejects_a_line():
    with pytest.raises(ValueError, match="non-zero 2D area"):
        tgrid.grid_from_obstacle_points([0.0, 5.0], [1.0, 1.0], 1.0, 0.5, **F64)


def test_tensors_keep_their_device_and_numpy_crosses_over():
    blocked = torch.zeros(4, 5, dtype=torch.bool)
    assert tgrid.grid_from_raster(blocked).blocked.device.type == "cpu"
    ox = torch.tensor([0.0, 4.0, 4.0], dtype=torch.float64)
    oy = torch.tensor([0.0, 0.0, 3.0], dtype=torch.float64)
    grid = tgrid.grid_from_obstacle_points(ox, oy, 1.0, 0.5, dtype=torch.float64)
    assert grid.blocked.device.type == "cpu" and grid.blocked.shape == (4, 3)

    jax_grid = jgrid.grid_from_raster(jnp.asarray(np.eye(6, 4, dtype=bool)), -1.0, 2.0, 0.25)
    got = convert.grid_from_numpy(np.asarray(jax_grid.blocked), np.asarray(jax_grid.min_x),
                                  np.asarray(jax_grid.min_y), np.asarray(jax_grid.resolution),
                                  **F64)
    assert_same_grid(got, jax_grid)
