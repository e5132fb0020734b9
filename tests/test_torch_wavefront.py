"""Wavefront planning: the port's `planning.wavefront` and kernel B2's
wrapper (`ops.wavefront_sweep`, its plain twin on the CPU) against the JAX
package's `wavefront_costs` and `wavefront_costs_pallas` (interpret mode, as
tests/test_wavefront_pallas.py runs it) on the same seeded numpy rasters.

Tolerance: f64 at rtol 1e-12 with the same inf pattern. The operations are
the same adds and mins in every implementation, so the values agree to the
bit; the kernel on the card is held to the twin bitwise by chip_smoke.py.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.ops.wavefront_pallas import wavefront_costs_pallas
from rust_robotics_tpu.planning import grid as jgrid
from rust_robotics_tpu.planning import wavefront as jwf
from rust_robotics_tpu_torch.ops import wavefront_sweep as ws
from rust_robotics_tpu_torch.planning import grid as tgrid
from rust_robotics_tpu_torch.planning import wavefront as twf

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def random_maps(b=3, w=32, h=32, p_free=0.75, seed=0):
    """free [B, W, H] with both corners free, goals at the far corner."""
    rng = np.random.default_rng(seed)
    free = rng.uniform(size=(b, w, h)) < p_free
    free[:, 0, 0] = free[:, -1, -1] = True
    goals = np.zeros((b, w, h), bool)
    goals[:, -1, -1] = True
    return free, goals


def same_costs(got, want):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("connectivity,corner_cutting", [(4, False), (8, False), (8, True)])
def test_incoming_masks_and_bit_plane(connectivity, corner_cutting):
    free, _ = random_maps(b=2, w=11, h=7, p_free=0.6, seed=1)
    want = jwf._incoming_masks(jnp.asarray(free), jwf.MOTIONS_8 if connectivity == 8
                               else jwf.MOTIONS_4, corner_cutting)
    motions = twf._motions(connectivity, twf.SQRT2)
    got = twf._incoming_masks(torch.from_numpy(free), motions, corner_cutting)
    assert len(got) == len(want) == connectivity
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bits = ws.incoming_bits(got)
    assert bits.dtype == torch.uint8
    for i, g in enumerate(got):
        assert torch.equal((bits >> i) & 1 == 1, g)


def test_direction_table_matches_the_motion_model():
    assert ws.OFFSETS == tuple((dx, dy) for dx, dy, _ in twf.MOTIONS_8)
    assert twf.MOTIONS_8 == jwf.MOTIONS_8 and twf.MOTIONS_4 == jwf.MOTIONS_4


def test_goal_raster_single_and_batched():
    want = jwf.goal_raster((6, 5), jnp.array([4, 2]))
    got = twf.goal_raster((6, 5), torch.tensor([4, 2]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = np.array([[0, 0], [5, 4], [3, 1]])
    want = jwf.goal_raster((6, 5), jnp.asarray(idx))
    got = twf.goal_raster((6, 5), torch.from_numpy(idx))
    assert got.shape == (3, 6, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = {
    # name: (connectivity, corner_cutting, unbatched, wall, max_iters)
    "8-connected": (8, False, False, False, None),
    "4-connected": (4, False, False, False, None),
    "corner-cutting": (8, True, False, False, None),
    "unbatched-with-wall": (8, False, True, True, None),
    "max-iters-cuts": (8, False, False, False, 12),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_wavefront_costs_match_jax_and_pallas(case):
    connectivity, corner_cutting, unbatched, wall, max_iters = CASES[case]
    free, goals = random_maps(seed=3)
    if wall:
        free[:, :, 10] = False  # splits the map: a part is unreachable
    if unbatched:
        free, goals = free[0], goals[0]
    kw = dict(connectivity=connectivity, corner_cutting=corner_cutting, max_iters=max_iters)
    want = jwf.wavefront_costs(jnp.asarray(free), jnp.asarray(goals), block=8, **kw)
    want_pallas = wavefront_costs_pallas(jnp.asarray(free), jnp.asarray(goals), k_sweeps=8,
                                         interpret=True, **kw)
    tfree, tgoals = torch.from_numpy(free), torch.from_numpy(goals)
    before = ws.wavefront_sweeps.launches
    got = twf.wavefront_costs(tfree, tgoals, block=8, dtype=torch.float64, **kw)
    got_fused = ws.wavefront_costs_fused(tfree, tgoals, k_sweeps=8, dtype=torch.float64, **kw)
    assert ws.wavefront_sweeps.launches == before  # CPU tensors run the twin
    assert got.shape == free.shape and got.dtype == torch.float64
    for g in (got, got_fused):
        same_costs(g, want)
        same_costs(g, want_pallas)
    if wall:
        assert np.isinf(got.numpy()).any()
    if max_iters is not None:  # the cut left cells that a full run reaches
        full = jwf.wavefront_costs(jnp.asarray(free), jnp.asarray(goals), **kw | {"max_iters": None})
        assert np.isinf(got.numpy()).sum() > np.isinf(np.asarray(full)).sum()


def test_float32_default_agrees_with_the_f64_field():
    """The port's default dtype is float32: on these maps (costs are sums
    of 1 and √2 along paths of < 100 steps) it agrees with JAX's f64 field
    to f32 precision, with the same inf pattern."""
    free, goals = random_maps(b=2, seed=4)
    got = twf.wavefront_costs(torch.from_numpy(free), torch.from_numpy(goals))
    assert got.dtype == torch.float32
    want = np.asarray(jwf.wavefront_costs(jnp.asarray(free), jnp.asarray(goals)))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-6)


def test_sweeps_wrapper_routes_cpu_to_the_twin_and_checks_inputs():
    free, goals = random_maps(b=2, w=9, h=12, seed=5)
    motions = twf._motions(8, twf.SQRT2)
    bits = ws.incoming_bits(twf._incoming_masks(torch.from_numpy(free), motions, False))
    d = torch.full(free.shape, ws.sentinel(torch.float64), dtype=torch.float64)
    d[torch.from_numpy(goals & free)] = 0.0
    costs = tuple(c for _, _, c in motions)
    got, changed = ws.wavefront_sweeps(d, bits, 3, costs)
    want, want_changed = ws.wavefront_sweeps_plain(d, bits, 3, costs)
    assert torch.equal(got, want) and torch.equal(changed, want_changed)
    assert changed.tolist() == [True, True]
    again, unchanged = ws.wavefront_sweeps(want, bits, 200, costs)
    fixed, none = ws.wavefront_sweeps(again, bits, 1, costs)
    assert torch.equal(fixed, again) and not none.any()
    with pytest.raises(ValueError, match="k must be"):
        ws.wavefront_sweeps(d, bits, 0, costs)
    with pytest.raises(TypeError, match="uint8"):
        ws.wavefront_sweeps(d, bits.bool(), 1, costs)
    with pytest.raises(ValueError, match=r"\[B, W, H\]"):
        ws.wavefront_sweeps(d[0], bits[0], 1, costs)
    with pytest.raises(ValueError, match="4 or 8"):
        ws.wavefront_sweeps(d, bits, 1, costs[:5])
    with pytest.raises(ValueError, match="cuda or cpu"):
        ws.wavefront_sweeps(d.to("meta"), bits.to("meta"), 1, costs)
    assert ws.resident_fits(128, 128, torch.float32) and ws.resident_fits(128, 128, torch.float64)
    assert not ws.resident_fits(512, 512, torch.float32)


def bench_grid_planners_map():
    """demos/benchmarks.py:69-83: a 64x64 map with an L-shaped wall."""
    free = np.ones((64, 64), bool)
    free[20:44, 20] = False
    free[20, 20:50] = False
    return free


@pytest.mark.parametrize("connectivity", [4, 8])
def test_plan_grid_matches_jax_on_the_benchmark_map(connectivity):
    blocked = ~bench_grid_planners_map()
    want_path, want_cost = jwf.plan_grid(jgrid.grid_from_raster(jnp.asarray(blocked)),
                                         (2.0, 2.0), (60.0, 60.0), connectivity=connectivity)
    grid = tgrid.grid_from_raster(blocked, device="cpu", dtype=torch.float64)
    path, cost = twf.plan_grid(grid, (2.0, 2.0), (60.0, 60.0), connectivity=connectivity)
    assert float(cost) == float(want_cost)
    np.testing.assert_array_equal(path.mask.numpy(), np.asarray(want_path.mask))
    np.testing.assert_array_equal(path.points.numpy(), np.asarray(want_path.points))
    assert int(path.mask.sum()) > 58


def test_extract_path_matches_jax_from_random_starts():
    free, goals = random_maps(b=1, w=24, h=20, p_free=0.8, seed=6)
    free, goals = free[0], goals[0]
    free[:, 7] = False  # a wall: starts beyond it are unreachable
    costs = jwf.wavefront_costs(jnp.asarray(free), jnp.asarray(goals))
    tcosts = torch.from_numpy(np.array(costs))
    for start in ((0, 0), (12, 15), (3, 2), (23, 19)):
        for kw in (dict(connectivity=8), dict(connectivity=4), dict(corner_cutting=True)):
            want = jwf.extract_path(costs, jnp.asarray(free), jnp.asarray(start), max_len=96, **kw)
            got = twf.extract_path(tcosts, torch.from_numpy(free), torch.tensor(start),
                                   max_len=96, **kw)
            assert got[0].dtype == torch.int32 and got[0].shape == (96, 2)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            assert float(got[2]) == float(want[2]) or np.isinf(float(want[2])) == np.isinf(
                float(got[2]))


@pytest.mark.cuda
def test_kernel_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    free, goals = random_maps(b=3, seed=7)
    for dtype in (torch.float32, torch.float64):
        want = ws.wavefront_costs_fused(torch.from_numpy(free), torch.from_numpy(goals),
                                        dtype=dtype)
        before = ws.wavefront_relax.launches
        got = ws.wavefront_costs_fused(torch.from_numpy(free).cuda(),
                                       torch.from_numpy(goals).cuda(), dtype=dtype)
        assert ws.wavefront_relax.launches == before + 1  # one launch per call
        assert torch.equal(got.cpu(), want)


def sweep_operands(free, goals, dtype=torch.float64, connectivity=8, corner_cutting=False):
    """(initial field, bit plane, costs) as `relax_wavefront` builds them."""
    motions = twf._motions(connectivity, twf.SQRT2)
    free, goals = torch.as_tensor(free), torch.as_tensor(goals)
    bits = ws.incoming_bits(twf._incoming_masks(free, motions, corner_cutting)).contiguous()
    d0 = torch.full(free.shape, ws.sentinel(dtype), dtype=dtype).masked_fill_(goals & free, 0.0)
    return d0, bits, tuple(c for _, _, c in motions)


def needed_sweeps(d, bits, costs):
    """Sweeps that lower a cell of map d [1, W, H] before its fixed point."""
    m = 0
    while True:
        d, lowered = ws.wavefront_sweeps_plain(d, bits, 1, costs)
        if not bool(lowered.any()):
            return m
        m += 1


RELAX_CASES = CASES | {"cap-37": (8, False, False, False, 37)}


@pytest.mark.parametrize("case", RELAX_CASES, ids=list(RELAX_CASES))
def test_relax_twin_matches_the_block_loop_and_jax(case):
    """`wavefront_relax_plain` with the cap K·⌈max_iters/K⌉ (K=8) gives
    bitwise the field of the CPU's K-sweep block loop and JAX's (XLA and
    the Pallas kernel in interpret mode), each map stopping on its own."""
    connectivity, corner_cutting, unbatched, wall, max_iters = RELAX_CASES[case]
    free, goals = random_maps(seed=3)
    if wall:
        free[:, :, 10] = False
    if unbatched:
        free, goals = free[:1], goals[:1]
    kw = dict(connectivity=connectivity, corner_cutting=corner_cutting, max_iters=max_iters)
    d0, bits, costs = sweep_operands(free, goals, connectivity=connectivity,
                                     corner_cutting=corner_cutting)
    cap = ws.sweep_cap(free.shape[1] * free.shape[2] if max_iters is None else max_iters, 8)
    before = ws.wavefront_relax.launches
    got, sweeps = ws.wavefront_relax(d0, bits, costs, cap)
    assert ws.wavefront_relax.launches == before  # CPU tensors run the twin
    got = torch.where(got >= ws.sentinel(torch.float64), torch.inf, got)
    loop = ws.wavefront_costs_fused(torch.from_numpy(free), torch.from_numpy(goals), k_sweeps=8,
                                    dtype=torch.float64, **kw)
    assert torch.equal(got, loop)
    same_costs(got, jwf.wavefront_costs(jnp.asarray(free), jnp.asarray(goals), block=8, **kw))
    same_costs(got, wavefront_costs_pallas(jnp.asarray(free), jnp.asarray(goals), k_sweeps=8,
                                           interpret=True, **kw))
    assert sweeps.dtype == torch.int32 and sweeps.shape == (free.shape[0],)
    assert int(sweeps.max()) <= cap
    if max_iters is not None:  # the cap binds on a map that a full run takes further
        assert cap in sweeps.tolist()


@pytest.mark.parametrize("cap", [None, 16, 37])
def test_relax_twin_counts_each_maps_own_sweeps(cap):
    """On maps that converge at different counts, each map runs its own
    needed sweeps + 1 (the sweep that lowers nothing), or the cap when that
    comes first, and ends with the field it reaches alone."""
    free, goals = random_maps(b=4, w=24, h=20, p_free=0.8, seed=8)
    goals[1] = False
    goals[1, 12, 10] = free[1, 12, 10] = True  # a goal in the middle: half the distance
    goals[2] = False  # no goal: nothing is lowered, one sweep
    free[3, :, 5] = False  # a wall: the far side stays unreached
    d0, bits, costs = sweep_operands(free, goals)
    alone = [needed_sweeps(d0[i:i + 1], bits[i:i + 1], costs) for i in range(4)]
    assert alone[2] == 0 and len(set(alone)) == 4
    cap = 24 * 20 if cap is None else cap
    got, sweeps = ws.wavefront_relax_plain(d0, bits, costs, cap)
    assert sweeps.tolist() == [min(m + 1, cap) for m in alone]
    for i in range(4):
        want, _ = ws.wavefront_sweeps_plain(d0[i:i + 1], bits[i:i + 1], int(sweeps[i]), costs)
        assert torch.equal(got[i:i + 1], want)
    if cap < max(alone):
        assert any(m + 1 > cap for m in alone) and any(m + 1 <= cap for m in alone)


def test_relax_cap_rule_and_argument_checks():
    assert [ws.sweep_cap(m, 8) for m in (-3, 0, 1, 8, 12, 37)] == [0, 0, 8, 8, 16, 40]
    assert ws.sweep_cap(16384, 16) == 16384
    free, goals = random_maps(b=2, w=9, h=12, seed=5)
    d0, bits, costs = sweep_operands(free, goals)
    same, none = ws.wavefront_relax(d0, bits, costs, 0)
    assert torch.equal(same, d0) and none.tolist() == [0, 0]
    with pytest.raises(ValueError, match="max_sweeps"):
        ws.wavefront_relax(d0, bits, costs, -1)
    with pytest.raises(TypeError, match="uint8"):
        ws.wavefront_relax(d0, bits.bool(), costs, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ws.wavefront_relax(d0.to("meta"), bits.to("meta"), costs, 4)
    # the kernel's launch refuses a cost that does not vanish beside the
    # sentinel (1e32 against the f32 sentinel's spacing of ~1e31)
    with pytest.raises(ValueError, match="vanish"):
        ws._launch(d0.float(), bits, costs[:4] + (1e32,) * 4, 4)


def test_kernel_bodies_by_shape_and_dtype():
    """f32 maps of at most 32 warps of 32 rows x 16 columns take the
    register body, other maps that fit one block the shared-memory body,
    the rest the tiled variant; the constants match the kernel source."""
    f32, f64 = torch.float32, torch.float64
    assert [ws.body(w, h, f32) for w, h in ((128, 128), (37, 29), (512, 32), (400, 40),
                                            (131, 127), (512, 512))] == [
        "registers", "registers", "registers", "resident", "tiled", "tiled"]
    assert [ws.body(w, h, f64) for w, h in ((128, 128), (37, 29), (512, 512))] == [
        "resident", "resident", "tiled"]
    for w in range(1, 600, 7):
        for h in range(1, 300, 11):
            if ws.registers_fit(w, h, f32):
                assert ws.resident_fits(w, h, f32)
    source = (pathlib.Path(ws.__file__).parents[1] / "csrc" / "wavefront_sweep.cu").read_text()
    constant = {name: int(re.search(rf"constexpr int {name} = (\d+)", source).group(1))
                for name in ("kThreads", "kPerThread", "kStrip")}
    assert constant["kStrip"] == ws.REGISTER_STRIP
    assert constant["kThreads"] // 32 == ws.REGISTER_MAX_WARPS
    assert constant["kThreads"] * constant["kPerThread"] == ws.RESIDENT_MAX_CELLS


@pytest.mark.cuda
def test_relax_kernel_matches_twin_on_cuda():
    """One launch per call, field and per-map sweeps bitwise the twin's, on
    the register body (32x32 f32), the shared-memory body (32x32 f64,
    400x40 f32) and the tiled variant (140x130), with and without a
    binding cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    for w, h in ((32, 32), (400, 40), (140, 130)):
        free, goals = random_maps(b=3, w=w, h=h, seed=9)
        for dtype in (torch.float32, torch.float64):
            d0, bits, costs = sweep_operands(free, goals, dtype)
            for cap in (w * h, 12, 37):
                want = ws.wavefront_relax_plain(d0, bits, costs, cap)
                before = ws.wavefront_relax.launches
                got = ws.wavefront_relax(d0.cuda(), bits.cuda(), costs, cap)
                assert ws.wavefront_relax.launches == before + 1
                assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
