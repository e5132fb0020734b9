"""The control layer on the card: the value-guided MPPI's terminal-value
grid (demos/benchmarks.py's bench_mppi_value) through B2, against the same
code on the CPU. No JAX here: the CPU run is the reference."""

import numpy as np
import pytest
import torch

from rust_robotics_tpu_torch.control import mppi_value as tv
from rust_robotics_tpu_torch.ops.wavefront_sweep import wavefront_relax
from rust_robotics_tpu_torch.planning.wavefront import goal_raster, wavefront_costs

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


@pytest.mark.cuda
def test_value_grid_of_bench_mppi_value_cuda_equals_cpu():
    """demos/benchmarks.py's value-guided MPPI grid: 48x48 with a wall, its
    wavefront field in one B2 launch, bitwise the CPU's, and the value
    lookup on the card equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, origin, w, h = 0.25, (-2.0, -4.0), 48, 48
    free = np.ones((w, h), bool)
    free[int((2.5 - origin[0]) / res):int((2.5 - origin[0]) / res) + 2,
         :int((2.0 - origin[1]) / res)] = False
    goal_idx = (int((6.0 - origin[0]) / res), int((0.0 - origin[1]) / res))
    xy = np.random.default_rng(8).uniform(-2, 8, (512, 2))
    out = {}
    for dev in ("cpu", "cuda"):
        f = torch.tensor(free, device=dev)
        wavefront_relax.launches = 0
        field = wavefront_costs(f, goal_raster((w, h), torch.tensor(goal_idx, device=dev))) * res
        if dev == "cuda":
            torch.cuda.synchronize()
            assert wavefront_relax.launches == 1
        grid = tv.TerminalValueGrid(torch.tensor(origin, device=dev), torch.tensor(res, device=dev),
                                    field)
        out[dev] = (field.cpu(), tv.grid_value_at(grid, torch.tensor(xy, dtype=torch.float32,
                                                                     device=dev)).cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
