#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the root of a checkout with one CUDA card: `python3 chip_smoke.py`.
It imports only `rust_robotics_tpu_torch` (no JAX), builds every kernel from
`rust_robotics_tpu_torch/csrc/` with nvcc, and runs these phases in order;
any failure exits non-zero before the final line.

 1. print the card's name and power limit (nvidia-smi);
 2. fail without CUDA;
 3. turn TF32 off for matmuls and cuDNN;
 4. build the kernels (ekf_scan, wavefront_sweep, resample, cholesky: one
    nvcc each, all at once), print the build time and ptxas's resource
    report;
 5. hold the EKF scan kernel (B1) against its plain-PyTorch twin on the card;
 6. the EKF main path at full width: bench.py's batched-EKF workload
    (B=131072 filters, T=200 steps, f32), rebuilt from a numpy seed,
    through `ekf_scan_lanes` on cuda, with launch counts reset just before;
    then kernel and twin times (CUDA events, min over bursts) beside the
    bound;
 7. one batched `ekf_step` at B=1024 (dense Q and R) on cuda against CPU;
 8. the 330-step EKF localization demo on cuda at f64 against a numpy
    transcription of the reference semantics;
 9. the wavefront kernel (B2) against its twins, bitwise: K-sweep launches
    of `wavefront_sweeps` one by one at bench.py's grid shape (B=64 maps
    of 128x128, f32, 8-connected), in f64 and on the tiled variant (B=2 of
    512x512); `wavefront_relax` (one launch per call, field and per-map
    sweeps) to convergence and at caps of 12 and 37 sweeps: the bench
    shape (f32 register body, f64 shared-memory body), 512x512 tiled in
    f32 and f64, 400x40 f32 (shared memory); random fields and bit planes
    at 37x29, 400x40 and 131x127, 4 and 8 directions; at 32x32 the
    4-connected, corner-cutting and unbatched cases through the public
    entry;
10. the grid main path at full width: bench.py's grid workload through
    `wavefront_costs` and `wavefront_costs_fused`, counted (one B2 launch
    per call) and run under torch's sync debug mode (no device read
    inside the call), each bitwise the CPU's field; sweeps per map against
    the sweeps needed; the kernel's time per call (and in f64, the
    shared-memory body), the twin's, the 16-sweep launch's, whole calls
    (host clock), cells relaxed/s and the bounds; then `plan_grid` on cuda on
    the 64x64 walled map of `bench_grid_planners`, equal to `plan_grid`
    on the CPU;
11. the resampling kernel (B3) against its twin: B=8192 x P=1024 and
    B=2048 x P=4096 in f32, a ragged B=4099 in f64, all mass on one
    particle, and the P=1280 ValueError;
12. the particle-filter main path at full width: a fleet of B=8192 filters
    x P=1024 particles (and B=2048 x P=4096) for 20 steps of predict,
    range update, `resample_if_needed_fused` and estimate, counted; then 3
    plain `pf_step`s; then B3's times at bench.py's three shapes;
13. the blocked Cholesky (B4/B5, one cooperative launch per
    factorisation) against the f64 factor (numpy) and its twin: f32 at
    n = 1200, 1280, 2560 and 4001 and at the ragged 1, 63, 65, 127 and
    129, f64 at 1200; the pivot-clamp case in f64 against the twin at
    rtol 1e-15; the f32 solve's residual; `cholesky_blocked_large` (B5's
    entry) on its own path at n = 2560, counted; kernel, twin,
    `torch.linalg.cholesky` and `torch.linalg.cholesky_ex` times at
    n = 64 (one diagonal block), 1200 and 2560 in f32 and 1200 in f64,
    interleaved burst by burst, beside the bound; the kernel's own phase
    clock at 1200 and 2560;
14. the BA main path at full width: 200 cameras x 2000 points (~76k
    observations) through `bundle_adjust` in f32 on cuda (Schur,
    reduced_solver "auto", so the n = 1200 retained system goes to B4),
    counted, its reprojection RMSE in f64 numpy; the same in f64 with
    reduced_solver "pallas_chol" (B4) and "dense", which must agree; one LM
    iteration's device time by phase; last, a torch.profiler breakdown of
    each grid call (one B2 launch), one PF step and one BA iteration
    (device busy and idle share, top device consumers), and of one B4
    factorisation, which must be one kernel launch; ptxas's registers and
    spills of B2's bodies (the register body must not spill);
15. bench.py's four pose-graph workloads (bench.py:113-117; no kernel on
    their path), f32 on cuda, LM at most 25 iterations, tolerance 1e-8: the
    10k chain through `chain_direct` (RMSE < 5e-3, warm time best of 2,
    iterations, the same solve in f64 on cuda and on the CPU within
    PG_F64_ATOL, one LM step under sync debug mode "error", the device
    reads of a whole solve counted under "warn", one step's profile and
    launches); the 100k chain (the auto rule's nested solve, by counter;
    RMSE < 5e-3); 256 distinct 200-pose graphs in lock-step (worst RMSE,
    graphs/s, three lanes equal to their solo solves); the 100x100 grid
    with 50 closures through `banded_direct` (the plan, RMSE < 2.2e-3, at
    least 3 iterations, one step's profile) and `direct`'s routes on the
    grid and a 2000-pose chain, by counter; then one JSON line
    `{"pose_graph": {...}}`;
16. one JSON line `{"kernels": [...]}`;
17. the last line, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.demos.ekf_localization import run_ekf_localization_demo
from rust_robotics_tpu_torch.filters.kalman import ekf_step
from rust_robotics_tpu_torch.filters.particle import (
    init_particles,
    pf_estimate,
    pf_predict,
    pf_step,
    pf_update_ranges,
    resample_if_needed_fused,
)
from rust_robotics_tpu_torch.core.lie import se3_exp
from rust_robotics_tpu_torch.models.motion import unicycle_propagate
from rust_robotics_tpu_torch.nlls import SolverConfig
from rust_robotics_tpu_torch.nlls import solver as nlls_solver
from rust_robotics_tpu_torch.ops import _build
from rust_robotics_tpu_torch.ops.cholesky import (
    cholesky_blocked,
    cholesky_blocked_large,
    cholesky_blocked_plain,
    cholesky_phase_stamps,
    cholesky_solve_blocked,
)
from rust_robotics_tpu_torch.ops.ekf_scan import ekf_scan_lanes, ekf_scan_plain
from rust_robotics_tpu_torch.ops.resample import (
    systematic_resample_gather,
    systematic_resample_gather_plain,
)
from rust_robotics_tpu_torch.ops.wavefront_sweep import (
    body,
    incoming_bits,
    resident_fits,
    sentinel,
    sweep_cap,
    wavefront_costs_fused,
    wavefront_relax,
    wavefront_relax_plain,
    wavefront_sweeps,
    wavefront_sweeps_plain,
)
from rust_robotics_tpu_torch.demos import pose_graph_bench
from rust_robotics_tpu_torch.nlls import banded, tridiag
from rust_robotics_tpu_torch.planning.grid import grid_from_raster
from rust_robotics_tpu_torch.planning.wavefront import (
    SQRT2,
    _incoming_masks,
    _motions,
    plan_grid,
    wavefront_costs,
)
from rust_robotics_tpu_torch.slam.bundle_adjustment import (
    CameraIntrinsics,
    build_bundle_adjustment,
    bundle_adjust,
)
from rust_robotics_tpu_torch.slam.pose_graph import (
    optimize_pose_graph_2d,
    se2_edge_residual,
    se2_retract,
)

SEED = 0
B, T, DT = 131072, 200, 0.1  # bench.py:34-51
Q = (0.01, 0.01, 3e-4, 0.01)
R = (1.0, 1.0)
RAGGED_B = 4099
ATOL_F64 = 1e-12
ATOL_F32_MEAN, ATOL_F32_COV = 1e-4, 1e-5

# Data-sheet peaks (dense), by a fragment of torch.cuda.get_device_name();
# the first match wins. Each type's peak at its full precision: float32
# outside the tensor cores (TF32 rounds), float64 on the tensor cores
# (DMMA keeps full FP64 precision, at twice the FP64 vector rate).
CARDS = (
    ("H100 PCIe", {"bytes_per_s": 2.0e12, "flops": {torch.float32: 51e12, torch.float64: 51e12}}),
    ("H100 NVL", {"bytes_per_s": 3.9e12, "flops": {torch.float32: 60e12, torch.float64: 60e12}}),
    ("H200", {"bytes_per_s": 4.8e12, "flops": {torch.float32: 67e12, torch.float64: 67e12}}),
    ("H100", {"bytes_per_s": 3.35e12, "flops": {torch.float32: 67e12, torch.float64: 67e12}}),
)
# Least arithmetic of one EKF step of the unicycle + GPS model, counting
# only terms the model's sparsity leaves non-zero: 118 adds/multiplies/
# divides plus 4 sin/cos counted as one operation each.
EKF_OPS_PER_STEP = 122

# bench.py:154-159: B=64 maps of 128x128, 20 % blocked, goal at the far corner
GRID_B, GRID_W, GRID_H = 64, 128, 128
GRID_K = 16  # sweeps per launch of wavefront_costs_fused (wavefront_pallas.py:95)
# The least work of one sweep of one cell, min(cur, s + straight, g +
# diagonal): per direction a bit test and a min into s or g, and per kind
# of direction (straight, and with 8 directions diagonal) an add and a min
# with the cell. None of them is an FMA, so each is one instruction per
# lane per clock: half the float32 peak, which counts an FMA as two.
WAVEFRONT_OPS_PER_DIRECTION = 2
WAVEFRONT_OPS_PER_KIND = 2

# bench.py:182-221: resampling at D=4, pinned (B=256), saturated (B=8192)
# and tiled (B=2048, P=4096)
RESAMPLE_SHAPES = {"pinned": (256, 1024), "saturated": (8192, 1024), "tiled": (2048, 4096)}
RESAMPLE_D = 4
RESAMPLE_IDX_OFF_LIMIT = 1e-3  # share of draws whose index may differ (f32)
# how far from its position a CDF boundary that a differing index crosses
# may lie: the two f32 prefix sums of up to 4096 terms differ by their
# summation order, a few units of 2^-24 times sqrt(P)
RESAMPLE_CDF_ATOL = 1e-5
# per particle: normalise, square-add, scan add, CDF divide, position
# add+divide, and a log2(P)-step binary search
RESAMPLE_OPS_PER_PARTICLE = 7

# demos/benchmarks.py:245-271 (bench_particle_filter), for a fleet of filters
PF_LANDMARKS = ((10.0, 0.0), (10.0, 10.0), (0.0, 15.0), (-5.0, 20.0))
PF_DT, PF_U, PF_CONTROL_NOISE, PF_RANGE_NOISE, PF_SPREAD = 0.1, (1.0, 0.1), (0.1, 0.05), 0.2, 0.1
PF_STEPS = 20
# (filters, particles): B3b's shape, then B3a's, the main width, which the
# plain pf_step run continues
PF_FLEETS = ((2048, 4096), (8192, 1024))
# The fleet's median position error after 20 steps must stay below this:
# `run_pf_fleet` on the CPU at B=64, seeds 0-3, gave medians of
# 0.0096-0.0118 (P=1024) and 0.0096-0.0102 (P=4096); 0.03 is 2.5 times
# the largest.
PF_MEDIAN_ERROR_LIMIT = 0.03

# B4/B5: SPD inputs m·mᵀ + n·I. 1200 is the BA's retained size (200 cameras
# x 6), 1280 the JAX kernel's padded size for it, 2560 the size docs/PERF.md
# measured the JAX B5 at, 4001 ragged.
CHOL_SIZES_F32 = (1200, 1280, 2560, 4001)
CHOL_SIZE_F64 = 1200
# one short of a block, one past, and the same about two blocks
CHOL_RAGGED_F32 = (1, 63, 65, 127, 129)
# 64 is one diagonal block (its serial column factor, no panel rows, no
# update); 1200 and 2560 as above
CHOL_TIMED = ((64, torch.float32), (1200, torch.float32), (2560, torch.float32),
              (1200, torch.float64))
CHOL_PHASED = (1200, 2560)  # f32, the kernel's phase clock
CHOL_CLAMP_RTOL = 1e-15  # tests/test_torch_cholesky.py::test_pivot_clamp_matches_jax_pallas
CHOL_REL_F32 = 5e-5  # |L - L64| / max|L64| (tests/test_cholesky_pallas.py:100)
# kernel against twin, both f32: each is within CHOL_REL_F32 of the f64
# factor, so they are within twice that of each other
CHOL_TWIN_REL_F32 = 2 * CHOL_REL_F32
CHOL_ATOL_F64_PER_N = 1e-10  # tests/test_cholesky_pallas.py:22
# ‖a·x − b‖ / ‖b‖ of the f32 solve: a = m·mᵀ + n·I has condition number
# at most ~5 (the eigenvalues of m·mᵀ lie below ~4n), and a Cholesky solve's
# backward error is of order n·u (u = 2^-24) times that: ~3.6e-4 at
# n = 1200; the limit is that bound, rounded up.
CHOL_SOLVE_REL_F32 = 5e-4

# The BA main path at full width: 200 keyframes x 2000 landmarks, the size
# of a visual-SLAM map's loop-closure refinement. Cameras 0.1 m apart along
# x, looking along +z at points 5-9 m away; camera i sees point p when
# |0.1·i − x_p| <= 2 (about 40 cameras per point).
BA_CAMERAS, BA_POINTS, BA_WINDOW = 200, 2000, 2.0
BA_INTRINSICS = (400.0, 400.0, 320.0, 240.0)  # as the JAX tests use
BA_FIXED = 2  # fixes scale as well as pose (tests/test_vio_gradients.py:90)
BA_ITERATIONS = 20
BA_CAMERA_NOISE, BA_POINT_NOISE = 0.01, 0.05
# f32 final reprojection RMSE limit in px: ten times the f32 floor of ~1e-4 px
# at pixel coordinates ~300 (300 * 2^-24 = 2e-5 px per coordinate and
# evaluation, a few times that after the solve)
BA_RMSE_LIMIT_F32 = 1e-3
BA_F64_ATOL = 1e-8  # pallas_chol against dense, cameras and points

# bench.py's four pose-graph rows (bench.py:113-117), with the LM settings
# of benchmark_large_pose_graph.rs:66-75 (25 iterations, tolerance 1e-8)
PG_CHAIN, PG_NESTED, PG_GRID = 10000, 100000, (100, 100, 50)
PG_SERVING = (200, 256)  # poses, graphs
PG_ITERATIONS, PG_TOLERANCE = 25, 1e-8
PG_CHAIN_RMSE = 5e-3  # benchmark_large_pose_graph.rs:97 (tests/test_tridiag.py:170)
PG_REFERENCE_RMSE = 2.2e-3  # the reference's measured 10k RMSE (README.md:728-730)
PG_GRID_RMSE, PG_GRID_MIN_ITERATIONS = 2.2e-3, 3  # tests/test_banded.py:153-168
# f64 on cuda against f64 on the CPU, the 10k chain's poses: the two runs
# take the same steps, and each step's solve carries a rounding error of
# ~kappa·eps of the step, kappa ~ n^2 = 1e8 for a 10k chain: 1e8 · 1.1e-16 ·
# 0.05 (a first step) ~ 6e-10 a step, < 2e-8 over 25 steps; 1e-6 leaves 50x.
PG_F64_ATOL = 1e-6
# a serving lane against its solo solve, f32 poses: both solve the same
# 200-pose graph in f32 and each ends within a few ulps of the truth (an
# ulp at the chain's 10 m extent is 9.5e-7); 1e-5 is ~10 ulps.
PG_LANE_ATOL_F32 = 1e-5
PG_LANES = (0, 127, 255)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_peaks(name: str) -> dict:
    for fragment, peaks in CARDS:
        if fragment in name:
            return peaks
    fail(f"no data-sheet peaks known for card {name!r}")


def ekf_scan_bound(t, b, dtype, peaks):
    """(bound_ms, bound_by): each input read once and each output written
    once over the memory rate, against the operations over the peak rate."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (2 * t * 2 * b + 2 * (4 + 16) * b)
    ops = EKF_OPS_PER_STEP * t * b
    by_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    by_ops = ops / peaks["flops"][dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn, reps, bursts):
    """Device time of one call: CUDA events around `reps` back-to-back calls,
    the minimum over `bursts`, after one warm-up call."""
    return time_interleaved_ms((fn,), reps, bursts)[0]


def time_interleaved_ms(fns, reps, bursts):
    """`time_ms` for several contenders alike: each burst times every one
    of `fns` in turn, so each gets the same number of bursts under the
    same conditions; returns each one's minimum."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    best = [math.inf] * len(fns)
    for _ in range(bursts):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            best[i] = min(best[i], start.elapsed_time(end) / reps)
    return best


def scan_inputs(rng, t, b, dtype, device):
    """bench.py's workload: z ≈ 10 + 0.3·N, v ≈ 1 + 0.1·N, ω = 0.1,
    mean0 = (0, 0, π/2, 0), cov0 = I, lane-major."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    zs = 10.0 + 0.3 * rng.standard_normal((t, 2, b), dtype=npdt)
    us = np.empty((t, 2, b), npdt)
    us[:, 0] = 1.0 + 0.1 * rng.standard_normal((t, b), dtype=npdt)
    us[:, 1] = 0.1
    mean0 = np.zeros((4, b), npdt)
    mean0[2] = np.pi / 2
    cov0 = np.repeat(np.eye(4, dtype=npdt).reshape(16, 1), b, axis=1)
    return tuple(torch.from_numpy(a).to(device) for a in (zs, us, mean0, cov0))


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(label, got, want, atol):
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{label}: non-finite values")
    err = max_err(got, want)
    print(f"{label}: max|diff| = {err!r} (atol {atol!r})")
    if not err <= atol:
        fail(f"{label}: max|diff| {err!r} > atol {atol!r}")
    return err


def bitwise_equal(a, b):
    """Same shape and the same bits (floats compared as integers)."""
    as_int = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def grid_workload(rng, b, w, h, device, p_blocked=0.2):
    """bench.py:154-159 from a numpy seed: free = uniform > p_blocked, both
    corners free, the goal at (w-1, h-1) in every map."""
    free = rng.uniform(size=(b, w, h)) > p_blocked
    free[:, 0, 0] = free[:, -1, -1] = True
    goals = np.zeros((b, w, h), bool)
    goals[:, -1, -1] = True
    return torch.from_numpy(free).to(device), torch.from_numpy(goals).to(device)


def sweep_operands(free, goals, dtype, connectivity=8, corner_cutting=False):
    """(initial field, bit plane, costs) as `relax_wavefront` builds them."""
    motions = _motions(connectivity, SQRT2)
    bits = incoming_bits(_incoming_masks(free, motions, corner_cutting)).contiguous()
    d0 = torch.full(free.shape, sentinel(dtype), dtype=dtype, device=free.device)
    d0.masked_fill_(goals & free, 0.0)
    return d0, bits, tuple(c for _, _, c in motions)


def check_sweeps_bitwise(label, free, goals, dtype, k=GRID_K):
    """Drive the convergence loop with the kernel and hold every launch's
    field and flags to the twin's from the same input, bitwise."""
    d, bits, costs = sweep_operands(free, goals, dtype)
    launches = 0
    changed = True
    while changed and launches * k < free.shape[-2] * free.shape[-1]:
        got, flags = wavefront_sweeps(d, bits, k, costs)
        want, want_flags = wavefront_sweeps_plain(d, bits, k, costs)
        if not (bitwise_equal(got, want) and torch.equal(flags, want_flags)):
            fail(f"{label}: launch {launches} differs from the twin "
                 f"(max|diff| {max_err(got, want)!r})")
        d, changed, launches = got, bool(flags.any()), launches + 1
    reached = int((d < sentinel(dtype)).sum())
    print(f"{label}: {launches} launches of {k} sweeps, every field and flag bitwise equal "
          f"to the twin (max|diff| = 0.0); {reached} cells reached")
    return 0.0


def check_relax_bitwise(label, d, bits, costs, cap):
    """One `wavefront_relax` call, which must be one launch, against its
    twin on the same input: the field and each map's sweeps bitwise equal.
    Returns the sweeps."""
    before = wavefront_relax.launches
    got, sweeps = wavefront_relax(d, bits, costs, cap)
    launched = wavefront_relax.launches - before
    want, want_sweeps = wavefront_relax_plain(d, bits, costs, cap)
    if launched != 1:
        fail(f"{label}: {launched} launches in one call, not 1")
    if not (bitwise_equal(got, want) and torch.equal(sweeps, want_sweeps)):
        fail(f"{label} cap {cap}: differs from the twin (max|diff| {max_err(got, want)!r}; "
             f"sweeps {sweeps[:8].tolist()}, twin {want_sweeps[:8].tolist()})")
    print(f"{label} cap {cap}: one launch; field and sweeps bitwise equal to the twin; sweeps "
          f"per map max {int(sweeps.max())}, mean {float(sweeps.double().mean())!r}")
    return sweeps


def check_random_bits(label, rng, shape, dtype, ndirs, device, k=5):
    """On a random field and a random bit plane, every bit set at random
    (off-map directions included), the field's values at most the sentinel
    (the kernel's domain): one K-sweep launch, and one `wavefront_relax` call to convergence,
    against their twins, bitwise: the kernel must ignore what the twin's
    padded shift ignores, and offer the sentinel where the twin does."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    d = rng.uniform(0.0, 50.0, size=shape).astype(npdt)
    d[rng.uniform(size=shape) < 0.5] = sentinel(dtype)
    d[rng.uniform(size=shape) < 0.02] = 0.0
    bits = rng.integers(0, 256, size=shape, dtype=np.uint8)
    d, bits = torch.from_numpy(d).to(device), torch.from_numpy(bits).to(device)
    costs = (1.0,) * 4 + (SQRT2,) * (ndirs - 4)
    got, flags = wavefront_sweeps(d, bits, k, costs)
    want, want_flags = wavefront_sweeps_plain(d, bits, k, costs)
    if not (bitwise_equal(got, want) and torch.equal(flags, want_flags)):
        fail(f"{label}: differs from the twin (max|diff| {max_err(got, want)!r})")
    print(f"{label}: {k} sweeps bitwise equal to the twin")
    check_relax_bitwise(f"{label} wavefront_relax", d, bits, costs, shape[1] * shape[2])


def check_costs_equal(label, device, free, goals, **kw):
    """The public entry on cuda against the same entry on the CPU (the
    twin), bitwise, with the same inf pattern."""
    got = wavefront_costs_fused(free.to(device), goals.to(device), **kw).cpu()
    want = wavefront_costs_fused(free.cpu(), goals.cpu(), **kw)
    if not bitwise_equal(got, want):
        fail(f"{label}: cuda and cpu fields differ")
    print(f"{label}: bitwise equal to the twin, {int(torch.isinf(got).sum())} unreachable cells")


def wavefront_bound(updates, cells, ndirs, peaks):
    """(bound_ms, bound_by) for `updates` f32 cell updates (sweeps x cells,
    summed over the maps) of fields of `cells` cells in all: the field in
    and out and the bit plane once, against the operations of
    WAVEFRONT_OPS_PER_* at one instruction per lane per clock."""
    by_bytes = cells * (2 * 4 + 1) / peaks["bytes_per_s"] * 1e3
    kinds = 2 if ndirs == 8 else 1
    ops = updates * (ndirs * WAVEFRONT_OPS_PER_DIRECTION + kinds * WAVEFRONT_OPS_PER_KIND)
    by_ops = ops / (peaks["flops"][torch.float32] / 2) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def resample_inputs(rng, b, p, d, dtype, device):
    """bench.py:190-196 from a numpy seed: weights uniform + 1e-6, one
    uniform per row, normal states [B, D, P]."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    w = rng.uniform(size=(b, p)).astype(npdt) + npdt(1e-6)
    u = rng.uniform(size=(b,)).astype(npdt)
    s = rng.standard_normal((b, d, p), dtype=npdt)
    return tuple(torch.from_numpy(a).to(device) for a in (w, u, s))


def check_resample(label, args, exact_idx):
    """Kernel against twin on the same inputs: neff at rtol 1e-5; the
    kernel's states are the states at its own indices, bitwise; indices
    equal (f64), or (f32) different in at most 1e-3 of the draws, and then
    only across CDF boundaries within RESAMPLE_CDF_ATOL of the position.

    The kernel's block scan sums in another order than torch.cumsum, so
    where a position falls on a boundary the index moves by one; where
    particles of weight below the CDF's rounding sit at that boundary, the
    CDF is flat there and the index moves over them too (by two or more)."""
    weights, u, states = args
    got_s, got_i, got_n = systematic_resample_gather(*args)
    want_s, want_i, want_n = systematic_resample_gather_plain(*args)
    torch.cuda.synchronize()
    own = torch.gather(states, 2, got_i.long()[:, None, :].expand_as(states))
    if not bitwise_equal(got_s, own):
        fail(f"{label}: states are not the states at the kernel's indices")
    neff_err = float(((got_n - want_n).abs() / want_n.abs()).max())
    if not neff_err <= 1e-5:
        fail(f"{label}: neff rtol {neff_err!r} > 1e-5")
    off = got_i != want_i
    share = float(off.double().mean())
    diff = (got_i.long() - want_i.long()).abs()
    worst = int(diff.max())
    if exact_idx and share > 0:
        fail(f"{label}: {int(off.sum())} indices differ from the twin's")
    if share > RESAMPLE_IDX_OFF_LIMIT:
        fail(f"{label}: {share!r} of indices differ (limit {RESAMPLE_IDX_OFF_LIMIT})")
    # the boundaries a differing index crosses: twin CDF entries lo..hi-1
    p = weights.shape[1]
    wn = weights / weights.sum(-1, keepdim=True)
    cum = torch.cumsum(wn, -1)
    cum = cum / cum[:, -1:]
    pos = (torch.arange(p, dtype=weights.dtype, device=weights.device) + u[:, None]) / p
    lo = torch.minimum(got_i, want_i).long()
    hi = torch.maximum(got_i, want_i).long() - 1
    gap = torch.maximum((cum.gather(1, lo) - pos).abs(), (cum.gather(1, hi.clamp(min=0)) - pos).abs())
    gap = float(gap[off].max()) if bool(off.any()) else 0.0
    if not gap <= RESAMPLE_CDF_ATOL:
        fail(f"{label}: a differing index crosses a CDF boundary {gap!r} from its position "
             f"(limit {RESAMPLE_CDF_ATOL})")
    print(f"{label}: neff rtol {neff_err!r}; states = gather at own idx (bitwise); "
          f"{int(off.sum())} of {off.numel()} indices differ ({share!r}): "
          f"{int((diff == 1).sum())} by one, {int((diff > 1).sum())} by more (max {worst}); "
          f"largest |CDF boundary - position| crossed {gap!r}")
    return {"neff_rtol": neff_err, "max_abs_err": float((got_n - want_n).abs().max()),
            "idx_differ_share": share, "idx_max_abs_diff": worst, "cdf_gap_crossed": gap}


def resample_bound(b, p, d, dtype, peaks):
    """(bound_ms, bound_by, bytes): weights, u and states read once; states,
    idx and neff written once; against the per-particle operations."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (b * p + b + 2 * b * d * p + b) + 4 * b * p
    ops = b * p * (RESAMPLE_OPS_PER_PARTICLE + math.log2(p))
    by_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    by_ops = ops / peaks["flops"][dtype] * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")), nbytes


def run_pf_fleet(b, p, steps, device, seed=SEED):
    """bench_particle_filter's problem (demos/benchmarks.py:245-271) for a
    fleet of b filters x p particles, f32: every filter tracks the same
    truth, from zeros, with u = (1.0, 0.1), ranges to the four landmarks
    plus 0.05·sin(l + 0.3k), and its own particle noise from one seeded
    generator. Each step is predict -> range update ->
    `resample_if_needed_fused` -> estimate. Returns (belief, estimate,
    position error [b])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    landmarks = torch.tensor(PF_LANDMARKS, dtype=torch.float64)
    truth = torch.zeros(4, dtype=torch.float64)
    u = torch.tensor(PF_U, dtype=torch.float32, device=device)
    lm = landmarks.to(device=device, dtype=torch.float32)
    belief = init_particles(gen, torch.zeros(b, 4, device=device), PF_SPREAD, p)
    for k in range(steps):
        truth = unicycle_propagate(truth, torch.tensor(PF_U, dtype=torch.float64), PF_DT)
        z = torch.linalg.norm(landmarks - truth[:2], dim=-1) \
            + 0.05 * torch.sin(torch.arange(4.0, dtype=torch.float64) + 0.3 * k)
        z = z.to(device=device, dtype=torch.float32).expand(b, -1)
        belief = pf_predict(belief, u, PF_DT, PF_CONTROL_NOISE, gen)
        belief = pf_update_ranges(belief, z, lm, PF_RANGE_NOISE)
        belief = resample_if_needed_fused(belief, gen)
        estimate = pf_estimate(belief)
    err = torch.linalg.norm(estimate.mean[:, :2].double() - truth[:2].to(device), dim=-1)
    return belief, estimate, err, (u, z, lm, gen)


def device_breakdown(label, fn, top=6):
    """Where one call's time goes: its host-clock time, then under
    torch.profiler the device's busy time, the span from its first to its
    last device event, the idle share of that span, and the `top` device
    consumers by self time. Returns {names: every device event's name,
    host_ms, busy_ms, span_ms, idle}."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail(f"{label}: the profiler saw no device events")
    names = [e.name for e in events]
    busy_ms = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    span_ms = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) / 1e3
    print(f"{label}: host clock {host_ms!r} ms; under the profiler device busy {busy_ms!r} ms of "
          f"a {span_ms!r} ms span ({1 - busy_ms / span_ms:.3f} idle), {len(events)} device events")
    consumers = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    for e in consumers[:top]:
        print(f"  {e.self_device_time_total / 1e3!r} ms in {e.count} x {e.key[:90]}")
    return {"names": names, "host_ms": host_ms, "busy_ms": busy_ms, "span_ms": span_ms,
            "idle": 1 - busy_ms / span_ms}


def numpy_demo_golden(steps=330, dt=0.1):
    """The reference demo semantics in plain numpy, f64
    (render_gif_ekf_localization.rs:35-76 + ekf.rs:248-278)."""

    def noise(k, scale, phase):
        return scale * np.sin(0.13 * k + phase) + 0.5 * scale * np.cos(0.07 * k + 1.3 * phase)

    q = np.diag([0.01, 0.01, np.deg2rad(1.0) ** 2, 0.01])
    r = np.eye(2)
    h = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    state = np.array([10.0, 0.0, np.pi / 2, 0.0])
    cov = np.eye(4)
    truth = state.copy()
    est = []
    for k in range(steps):
        truth[0] += 1.0 * np.cos(truth[2]) * dt
        truth[1] += 1.0 * np.sin(truth[2]) * dt
        truth[2] += 0.1 * dt
        u = np.array([1.0 + noise(k, 0.12, 0.2), 0.1 + noise(k, 0.04, 1.0)])
        z = np.array([truth[0] + noise(k, 0.6, 2.0), truth[1] + noise(k, 0.6, 2.7)])
        x_pred = np.array([
            state[0] + dt * u[0] * np.cos(state[2]),
            state[1] + dt * u[0] * np.sin(state[2]),
            state[2] + dt * u[1],
            u[0],
        ])
        f = np.eye(4)
        f[0, 2] = -dt * u[0] * np.sin(x_pred[2])
        f[1, 2] = dt * u[0] * np.cos(x_pred[2])
        f[3, 3] = 0.0
        p_pred = f @ cov @ f.T + q
        s = h @ p_pred @ h.T + r
        gain = p_pred @ h.T @ np.linalg.inv(s)
        state = x_pred + gain @ (z - h @ x_pred)
        cov = (np.eye(4) - gain @ h) @ p_pred
        est.append(state.copy())
    return np.array(est)


def spd(rng, n, dtype):
    """m·mᵀ + n·I from a numpy seed, computed in f64, cast to dtype."""
    m = rng.standard_normal((n, n))
    a = m @ m.T + n * np.eye(n)
    return a.astype(np.float32 if dtype == torch.float32 else np.float64)


def cholesky_bound(n, dtype, peaks):
    """(bound_ms, bound_by): n³/3 operations at the peak rate against the
    matrix read once and the factor written once (2·n²·itemsize bytes)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    by_ops = n**3 / 3 / peaks["flops"][dtype] * 1e3
    by_bytes = 2 * n * n * itemsize / peaks["bytes_per_s"] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_cholesky(label, a_np, device):
    """The kernel (through `cholesky_blocked`) against the f64 factor and
    against the twin on the card; returns {rel_f64, max_abs_err, ...}."""
    a = torch.from_numpy(a_np).to(device)
    got = cholesky_blocked(a)
    want = cholesky_blocked_plain(a)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == a.shape):
        fail(f"{label}: non-finite factor or shape {tuple(got.shape)}")
    upper = float(torch.triu(got, 1).abs().max())
    if upper != 0.0:
        fail(f"{label}: strict upper triangle not zero (max {upper!r})")
    ref = np.linalg.cholesky(a_np.astype(np.float64))
    scale = float(np.abs(ref).max())
    rel64 = float(np.abs(got.double().cpu().numpy() - ref).max()) / scale
    err = max_err(got, want)
    out = {"rel_f64": rel64, "max_abs_err": err, "twin_rel": err / scale}
    if a.dtype == torch.float32:
        if not (rel64 <= CHOL_REL_F32 and err / scale <= CHOL_TWIN_REL_F32):
            fail(f"{label}: rel err {rel64!r} to the f64 factor (limit {CHOL_REL_F32}) or "
                 f"{err / scale!r} to the twin (limit {CHOL_TWIN_REL_F32})")
    elif not err <= CHOL_ATOL_F64_PER_N * a.shape[0]:
        fail(f"{label}: max|kernel - twin| {err!r} > {CHOL_ATOL_F64_PER_N * a.shape[0]!r}")
    print(f"{label}: upper triangle 0; rel err to the f64 factor {rel64!r}; "
          f"max|kernel - twin| {err!r} ({err / scale!r} relative)")
    return out


def clamp_case(n=100):
    """tests/test_torch_cholesky.py::clamp_case: exact integer arithmetic
    with pivots that clamp in the last block (row 70's becomes 0 after its
    coupling to row 10 is eliminated, row 80's is 1e-40, row 90's -4)."""
    a = 2.0 * np.eye(n)
    a[10, 10] = a[70, 70] = a[10, 70] = a[70, 10] = 1.0
    a[80, 80] = 1e-40
    a[90, 90] = -4.0
    return a


def check_cholesky_clamp(device):
    """The kernel on the clamp case in f64 against the twin at rtol 1e-15,
    and the clamped values themselves."""
    a = torch.from_numpy(clamp_case()).to(device)
    got = cholesky_blocked(a).cpu().numpy()
    want = cholesky_blocked_plain(a).cpu().numpy()
    if not np.isfinite(got).all():
        fail("cholesky clamp case: non-finite factor")
    nz = want != 0
    rel = float(np.max(np.abs(got - want)[nz] / np.abs(want[nz])))
    exact_zero = bool(np.all(got[~nz] == 0.0))
    print(f"cholesky f64 clamp case n=100: max rel diff to the twin {rel!r} (rtol "
          f"{CHOL_CLAMP_RTOL}), zeros where the twin has zeros {exact_zero}; L[70,70] "
          f"{got[70, 70]!r}, L[80,80] {got[80, 80]!r}, L[90,90] {got[90, 90]!r}")
    if not (rel <= CHOL_CLAMP_RTOL and exact_zero and got[70, 70] == 0.0):
        fail("cholesky clamp case differs from the twin")
    if not np.allclose([got[80, 80], got[90, 90]], [1e-25, -4e15], rtol=CHOL_CLAMP_RTOL, atol=0):
        fail("cholesky clamp case: clamped pivots do not give 1e-25 and -4e15")
    return rel


def cholesky_phases(a):
    """One factorisation with the kernel's phase clock on (CTA 0's
    %globaltimer, ns): total µs, the first diagonal factor, and the mean µs
    per block step of each phase: L_kk staged for the panel, CTA 0's panel
    rows, the panel's barrier, CTA 0's update of the next diagonal tile,
    the diagonal factor, the step's last barrier."""
    _, stamps = cholesky_phase_stamps(a)
    torch.cuda.synchronize()
    s = stamps.cpu().numpy().astype(np.int64)
    steps = (len(s) - 3) // 6
    out = {"total_us": float(s[-1] - s[0]) / 1e3, "first_factor_us": float(s[1] - s[0]) / 1e3,
           "steps": steps}
    if steps:
        per = s[3:].reshape(steps, 6)
        prev = np.concatenate([[s[2]], per[:-1, 5]])
        spans = np.diff(np.concatenate([prev[:, None], per], 1), axis=1).mean(0) / 1e3
        for key, v in zip(("stage", "panel_rows", "panel_barrier", "update_tile", "factor",
                           "last_barrier"), spans):
            out[f"{key}_us_per_step"] = float(v)
    return out


def ptxas_report(kname):
    """{entry: {registers, smem_bytes, stack_bytes, spill_stores, spill_loads}}
    from ptxas's -v report in the source's build log."""
    report, entry = {}, None
    for line in _build.build_log(kname).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            report[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            report[entry].update(stack_bytes=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif entry and "Used" in line and "registers" in line:
            report[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[entry]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return report


def ba_problem(cameras, points, seed=SEED):
    """The BA main path's problem from numpy seeds: world-from-camera
    tangents ξ_i = [0.1·i, 0.05·sin(0.3·i), 0, 0.02·sin(0.05·i),
    0.02·cos(0.07·i), 0.01·sin(0.11·i)] ([ρ, φ]); points uniform on
    x ∈ [−1, 0.1·(C−1) + 1.1], y ∈ [−2, 2], z ∈ [5, 9]; camera i sees point
    p when |0.1·i − x_p| <= BA_WINDOW; exact f64 pixels. Initial state:
    tangents + 0.01·N(0, 1) (the BA_FIXED fixed cameras exact) and points
    + 0.05·N(0, 1). Returns (truth cameras [C, 4, 4], truth points,
    initial tangents, initial points, cam_idx, pt_idx, pixels)."""
    rng = np.random.default_rng(seed)
    i = np.arange(cameras, dtype=np.float64)
    tangents = np.stack([0.1 * i, 0.05 * np.sin(0.3 * i), 0 * i, 0.02 * np.sin(0.05 * i),
                         0.02 * np.cos(0.07 * i), 0.01 * np.sin(0.11 * i)], -1)
    cams = se3_exp(torch.from_numpy(tangents)).numpy()
    pts = np.stack([rng.uniform(-1.0, 0.1 * (cameras - 1) + 1.1, points),
                    rng.uniform(-2.0, 2.0, points), rng.uniform(5.0, 9.0, points)], -1)
    seen = np.abs(0.1 * i[:, None] - pts[None, :, 0]) <= BA_WINDOW
    cam_idx, pt_idx = np.nonzero(seen)
    pixels = ba_project(cams, pts, cam_idx, pt_idx)
    t0 = tangents + BA_CAMERA_NOISE * rng.standard_normal(tangents.shape)
    t0[:BA_FIXED] = tangents[:BA_FIXED]
    p0 = pts + BA_POINT_NOISE * rng.standard_normal(pts.shape)
    return cams, pts, t0, p0, cam_idx, pt_idx, pixels


def ba_project(cams, pts, cam_idx, pt_idx):
    """Pinhole projections in f64 numpy (bundle_adjustment.rs:21-31)."""
    fx, fy, cx, cy = BA_INTRINSICS
    inv = np.linalg.inv(cams)[cam_idx]
    pc = np.einsum("oij,oj->oi", inv[:, :3, :3], pts[pt_idx]) + inv[:, :3, 3]
    return np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)


def ba_rmse(cams, pts, cam_idx, pt_idx, pixels):
    """Reprojection RMSE in px, in f64 numpy."""
    err = ba_project(np.asarray(cams, np.float64), np.asarray(pts, np.float64), cam_idx,
                     pt_idx) - pixels
    return float(np.sqrt(np.mean(np.sum(err**2, -1))))


def ba_config(reduced_solver):
    return SolverConfig(linear_solver="schur", max_iterations=BA_ITERATIONS,
                        reduced_solver=reduced_solver)


def run_ba(problem, device, dtype, reduced_solver):
    """bundle_adjust on the problem's initial state; returns (cameras,
    points, summary, host seconds)."""
    _, _, t0, p0, cam_idx, pt_idx, pixels = problem
    start = time.perf_counter()
    cams, pts, summary = bundle_adjust(t0, p0, cam_idx, pt_idx, pixels,
                                       CameraIntrinsics(*BA_INTRINSICS), fixed_cameras=BA_FIXED,
                                       config=ba_config(reduced_solver), device=device,
                                       dtype=dtype)
    torch.cuda.synchronize()
    return cams, pts, summary, time.perf_counter() - start


def ba_iteration_phases(problem, device, damping=1e-3):
    """One LM iteration of the f32 BA, phase by phase, as `solve` runs it
    under reduced_solver="auto": linearize, the Schur products, B4, the two
    triangular solves, then back-substitution, retraction and trial cost.
    Returns ({phase: callable}, state): each phase runs on the outputs of
    the one before, which `state` holds."""
    _, _, t0, p0, cam_idx, pt_idx, pixels = problem
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    prob = build_bundle_adjustment(t(t0), t(p0), t(cam_idx, torch.int64),
                                   t(pt_idx, torch.int64), t(pixels),
                                   CameraIntrinsics(*BA_INTRINSICS), fixed_cameras=BA_FIXED)
    _, total = prob.layout()
    elim = prob.groups[-1]
    dr = total - elim.num * elim.tdim
    state = {}

    def linearize():
        state["h"], state["grad"], _, _ = nlls_solver._linearize_dense(
            prob, prob.values(), torch.float32)

    def schur():
        state["s"], state["rhs"], state["back"] = nlls_solver._schur_system(
            state["h"], state["grad"], damping, True, dr, (elim.num, elim.tdim))

    def factor():
        state["l"] = cholesky_blocked(state["s"])

    def triangular():
        y = torch.linalg.solve_triangular(state["l"], state["rhs"][:, None], upper=False)
        state["dx_r"] = torch.linalg.solve_triangular(state["l"].mT, y, upper=True)[:, 0]

    def rest():
        delta = torch.cat([state["dx_r"], state["back"](state["dx_r"])])
        trial = nlls_solver._apply_increment(prob, prob.values(), delta)
        state["cost"] = nlls_solver.problem_cost(prob, trial)

    return {"linearize": linearize, "schur products": schur, "B4 factor": factor,
            "triangular solves": triangular, "back-substitution + trial cost": rest}, state


def phase_times(phases, bursts=3):
    """Device time of each phase (CUDA events around it, phases run in
    order), the minimum over `bursts` passes after one warm-up pass."""
    best = {name: math.inf for name in phases}
    for burst in range(bursts + 1):
        for name, fn in phases.items():
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if burst:
                best[name] = min(best[name], start.elapsed_time(end))
    return best


def chain_problem_on(device, dtype, size):
    """The benchmark chain as `solve_chain_lm`'s arguments on `device`."""
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(size)
    cm, ci, lf, lt, lm, li = tridiag.classify_chain_edges(size, ef, et, meas, info)
    t = lambda a, dt=dtype: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    fixed = torch.zeros(size, dtype=torch.bool, device=device)
    fixed[0] = True
    return truth, t(initial), (t(cm), t(ci), t(lf, torch.int64), t(lt, torch.int64), t(lm),
                               t(li), fixed)


PG_LM = dict(residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3,
             gradient_tolerance=PG_TOLERANCE, step_tolerance=PG_TOLERANCE,
             cost_tolerance=PG_TOLERANCE**2)


def pose_graph_phase(card, device):
    """bench.py's four pose-graph workloads on the port, f32 on cuda (phase
    15); returns their numbers for the JSON line."""
    out = {"card": card}

    # 1. the 10k chain through chain_direct
    size = PG_CHAIN
    seconds, err, summary = pose_graph_bench.run_large_benchmark(
        size, PG_ITERATIONS, PG_TOLERANCE, device=device, runs=2)
    print(f"pose graph {size} chain f32 chain_direct on {card}: RMSE {err!r} (gate "
          f"{PG_CHAIN_RMSE}; the reference measured {PG_REFERENCE_RMSE}, README.md:728-730); "
          f"warm {seconds!r} s host clock (best of 2); {summary.iterations} LM iterations, "
          f"{seconds / summary.iterations!r} s each; {summary}")
    if not err < PG_CHAIN_RMSE:
        fail(f"10k chain RMSE {err!r} >= {PG_CHAIN_RMSE}")
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(size)
    f64 = {}
    for where in (device, "cpu"):
        start = time.perf_counter()
        poses, s64 = optimize_pose_graph_2d(initial, ef, et, meas, info, PG_ITERATIONS,
                                            PG_TOLERANCE, "chain_direct", device=where,
                                            dtype=torch.float64)
        f64[str(where)] = poses.cpu().numpy()
        print(f"pose graph {size} chain f64 on {card if where == device else 'the CPU'}: "
              f"{time.perf_counter() - start!r} s host clock (first f64 call included); "
              f"RMSE {pose_graph_bench.rmse(f64[str(where)], truth)!r}; {s64}")
    f64_diff = float(np.abs(f64[str(device)] - f64["cpu"]).max())
    print(f"pose graph {size} chain f64: cuda against the CPU max|diff| {f64_diff!r} (atol "
          f"{PG_F64_ATOL})")
    if not f64_diff <= PG_F64_ATOL:
        fail(f"10k chain f64 cuda against CPU: max|diff| {f64_diff!r} > {PG_F64_ATOL}")
    # the step reads nothing back (sync debug mode "error" raises on a read);
    # the whole solve's reads are the loop's done.all(), one an iteration
    _, init_d, args = chain_problem_on(device, torch.float32, size)
    state, step = tridiag.chain_lm_start(init_d[None], *args, **PG_LM)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("pose graph 10k chain: one LM step under torch.cuda.set_sync_debug_mode('error'): "
          "no device read")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, s_sync = tridiag.solve_chain_lm(init_d, *args, max_iterations=PG_ITERATIONS,
                                               **PG_LM)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    print(f"pose graph 10k chain: device reads in one solve_chain_lm call {reads} for "
          f"{int(s_sync.iterations)} LM iterations (the loop's done.all())")
    if reads > int(s_sync.iterations):
        fail(f"solve_chain_lm read the device {reads} times in {int(s_sync.iterations)} "
             "iterations")
    prof = device_breakdown(f"pose graph 10k chain, one LM step (f32) on {card}",
                            lambda: step(state))
    print(f"pose graph 10k chain: {len(prof['names'])} device launches per LM iteration")
    out["chain_10k"] = {"seconds": seconds, "rmse": err, "iterations": summary.iterations,
                        "termination": summary.termination, "f64_cuda_vs_cpu": f64_diff,
                        "device_reads_per_solve": reads,
                        "launches_per_iteration": len(prof["names"]),
                        "profile": {k: v for k, v in prof.items() if k != "names"}}
    del state, step, init_d, args

    # 2. the 100k chain: the auto rule takes the nested solve
    calls = tridiag.chain_nested_solve.calls
    seconds, err, summary = pose_graph_bench.run_large_benchmark(
        PG_NESTED, PG_ITERATIONS, PG_TOLERANCE, device=device)
    nested = tridiag.chain_nested_solve.calls - calls
    print(f"pose graph {PG_NESTED} chain f32 on {card}: RMSE {err!r} (gate {PG_CHAIN_RMSE}); "
          f"warm {seconds!r} s host clock; {summary.iterations} LM iterations; "
          f"chain_nested_solve calls {nested} over the warm-up and the timed solve; {summary}")
    if nested < 2 * summary.iterations:
        fail(f"the 100k chain made {nested} nested solves in 2 x {summary.iterations} iterations")
    if not err < PG_CHAIN_RMSE:
        fail(f"100k chain RMSE {err!r} >= {PG_CHAIN_RMSE}")
    _, init_d, args = chain_problem_on(device, torch.float32, PG_NESTED)
    state, step = tridiag.chain_lm_start(init_d[None], *args, **PG_LM)
    prof = device_breakdown(f"pose graph 100k chain, one nested LM step (f32) on {card}",
                            lambda: step(state))
    out["chain_100k_nested"] = {"seconds": seconds, "rmse": err,
                                "iterations": summary.iterations,
                                "nested_calls": nested,
                                "launches_per_iteration": len(prof["names"]),
                                "profile": {k: v for k, v in prof.items() if k != "names"}}
    del state, step, init_d, args

    # 3. serving: 256 distinct 200-pose graphs in lock-step
    size, batch = PG_SERVING
    seconds, worst, rate, values, summ = pose_graph_bench.run_batched_benchmark(
        size, batch, PG_ITERATIONS, PG_TOLERANCE, device=device, runs=2)
    terms = np.bincount(summ.termination_code.cpu().numpy(), minlength=5).tolist()
    print(f"pose graph serving {batch} x {size} f32 on {card}: worst RMSE {worst!r}; "
          f"{rate!r} graphs/s ({seconds!r} s warm, best of 2); iterations max "
          f"{int(summ.iterations.max())} mean {float(summ.iterations.float().mean())!r}; "
          f"terminations {terms} (codes 0-4)")
    if not worst < PG_CHAIN_RMSE:
        fail(f"serving worst RMSE {worst!r} >= {PG_CHAIN_RMSE}")
    _, init_b, args = pose_graph_bench.batched_problem(size, batch, device)
    lanes = {}
    for k in PG_LANES:
        solo, ss = tridiag.solve_chain_lm(init_b[k], *args, max_iterations=PG_ITERATIONS,
                                          **PG_LM)
        lane = (int(summ.iterations[k]), int(summ.termination_code[k]))
        diff = float((solo - values[k]).abs().max())
        lanes[k] = {"batch": lane, "solo": (int(ss.iterations), int(ss.termination_code)),
                    "max_abs_diff": diff}
        print(f"pose graph serving lane {k}: batch (iterations, termination) {lane}, solo "
              f"{lanes[k]['solo']}, poses max|diff| {diff!r} (atol {PG_LANE_ATOL_F32})")
        if lanes[k]["solo"] != lane or not diff <= PG_LANE_ATOL_F32:
            fail(f"serving lane {k} differs from its solo solve: {lanes[k]}")
    state, step = tridiag.chain_lm_start(init_b, *args, **PG_LM)
    prof = device_breakdown(f"pose graph serving, one lock-step LM step ({batch} graphs)",
                            lambda: step(state))
    out["serving"] = {"seconds": seconds, "worst_rmse": worst, "graphs_per_s": rate,
                      "terminations": terms, "lanes": lanes,
                      "launches_per_iteration": len(prof["names"]),
                      "profile": {k: v for k, v in prof.items() if k != "names"}}
    del state, step, init_b, args, values

    # 4. the 100x100 grid through banded_direct
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_grid(*PG_GRID)
    plan = banded.plan_banded(len(truth), ef, et)
    print(f"pose graph grid {PG_GRID[0]}x{PG_GRID[1]} + {PG_GRID[2]} closures: plan supernode "
          f"{plan.supernode}, {plan.num_super} supernodes, bandwidth {plan.bandwidth}, "
          f"{int(plan.in_band.sum())} edges in band, {int((~plan.in_band).sum())} demoted to the "
          f"Woodbury correction")
    seconds, err, summary = pose_graph_bench.run_grid_benchmark(
        *PG_GRID, PG_ITERATIONS, PG_TOLERANCE, device=device, runs=2)
    print(f"pose graph grid f32 banded_direct on {card}: RMSE {err!r} (gate {PG_GRID_RMSE}); "
          f"warm {seconds!r} s host clock (best of 2); {summary.iterations} LM iterations, "
          f"{seconds / summary.iterations!r} s each; {summary}")
    if not (err < PG_GRID_RMSE and summary.iterations >= PG_GRID_MIN_ITERATIONS):
        fail(f"grid: RMSE {err!r}, {summary.iterations} iterations")
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    plan, values_b, args = banded.banded_problem(
        torch.tensor(initial, dtype=torch.float32, device=device)[None], ef, et, meas, info,
        fixed, tdim=3)
    state, step = banded.banded_lm_start(values_b, *args, supernode=plan.supernode,
                                         num_super=plan.num_super, **PG_LM)
    prof = device_breakdown(f"pose graph grid, one banded LM step (f32) on {card}",
                            lambda: step(state))
    del state, step, values_b, args
    routes = {}
    for label, graph in (("grid", (truth, initial, ef, et, meas, info)),
                         ("chain 2000", pose_graph_bench.synthesize_chain(2000))):
        calls = (tridiag.solve_chain_lm.calls, banded.solve_banded_lm.calls)
        g_truth, g_init, g_ef, g_et, g_meas, g_info = graph
        poses, s_direct = optimize_pose_graph_2d(g_init, g_ef, g_et, g_meas, g_info,
                                                 PG_ITERATIONS, PG_TOLERANCE, "direct",
                                                 device=device)
        routes[label] = {"chain": tridiag.solve_chain_lm.calls - calls[0],
                         "banded": banded.solve_banded_lm.calls - calls[1],
                         "rmse": pose_graph_bench.rmse(poses.cpu().numpy(), g_truth)}
        print(f"pose graph direct on the {label}: solve_chain_lm calls {routes[label]['chain']}, "
              f"solve_banded_lm calls {routes[label]['banded']}; RMSE {routes[label]['rmse']!r}")
    if (routes["grid"]["chain"], routes["grid"]["banded"]) != (0, 1) or \
            (routes["chain 2000"]["chain"], routes["chain 2000"]["banded"]) != (1, 0):
        fail(f"direct took the wrong routes: {routes}")
    out["grid_10k"] = {"seconds": seconds, "rmse": err, "iterations": summary.iterations,
                       "plan": {"supernode": plan.supernode, "num_super": plan.num_super,
                                "bandwidth": plan.bandwidth,
                                "in_band": int(plan.in_band.sum()),
                                "woodbury": int((~plan.in_band).sum())},
                       "direct_routes": routes,
                       "launches_per_iteration": len(prof["names"]),
                       "profile": {k: v for k, v in prof.items() if k != "names"}}
    return out


def main() -> int:
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
    print(f"card: {card}")

    # 2. CUDA or nothing
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 3. full-precision float32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 4. build every kernel, one nvcc per source, all at once
    kernels = {
        "ekf_scan": ekf_scan_lanes,
        "wavefront_sweep": wavefront_relax,
        "resample": systematic_resample_gather,
        "cholesky": cholesky_blocked,
    }
    # B2's K-sweep entry and B5's entry launch the same kernels as
    # wavefront_relax and cholesky_blocked, each with its own count
    counted = (*kernels.values(), wavefront_sweeps, cholesky_blocked_large)
    start = time.perf_counter()
    per_source = _build.build(list(kernels))
    print(f"build: {time.perf_counter() - start!r} s wall; per source {per_source}")
    for kname in kernels:
        for line in _build.build_log(kname).splitlines():
            if any(word in line for word in ("entry function", "registers", "spill", "smem")):
                print(f"ptxas {kname}: {line.strip()}")

    # 5. each kernel against its twin on the card
    rng = np.random.default_rng(SEED)
    args64 = scan_inputs(rng, T, RAGGED_B, torch.float64, device)
    got = ekf_scan_lanes(*args64, DT, Q, R)
    want = ekf_scan_plain(*args64, DT, Q, R)
    torch.cuda.synchronize()
    err64 = max(check_close(f"ekf_scan f64 T={T} B={RAGGED_B} {part}", g, w, ATOL_F64)
                for part, g, w in zip(("mean", "cov"), got, want))
    del args64, got, want

    args = scan_inputs(rng, T, B, torch.float32, device)
    got = ekf_scan_lanes(*args, DT, Q, R)
    want = ekf_scan_plain(*args, DT, Q, R)
    torch.cuda.synchronize()
    err32_mean = check_close(f"ekf_scan f32 T={T} B={B} mean", got[0], want[0], ATOL_F32_MEAN)
    err32_cov = check_close(f"ekf_scan f32 T={T} B={B} cov", got[1], want[1], ATOL_F32_COV)
    del got, want

    # 6. the main path at full width, counted
    for fn in counted:
        fn.launches = 0
    mean, cov = ekf_scan_lanes(*args, DT, Q, R)
    torch.cuda.synchronize()
    launches = {kname: fn.launches for kname, fn in kernels.items()}
    print(f"EKF main path launches: {launches}")
    if launches["ekf_scan"] < 1:
        fail("kernel ekf_scan was not launched on the EKF main path")
    if mean.shape != (4, B) or cov.shape != (16, B):
        fail(f"main path shapes {tuple(mean.shape)}, {tuple(cov.shape)}")
    if not (torch.isfinite(mean).all() and torch.isfinite(cov).all()):
        fail("main path produced non-finite values")

    kernel_ms = time_ms(lambda: ekf_scan_lanes(*args, DT, Q, R), reps=20, bursts=5)
    plain_ms = time_ms(lambda: ekf_scan_plain(*args, DT, Q, R), reps=1, bursts=3)
    bound_ms, bound_by = ekf_scan_bound(T, B, torch.float32, peaks)
    updates = B * T / (kernel_ms * 1e-3)
    print(
        f"ekf_scan B={B} T={T} f32 on {card}: kernel {kernel_ms!r} ms, twin "
        f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}), "
        f"{updates!r} updates/s, {bound_ms / kernel_ms:.4f} of the bound"
    )
    del args, mean, cov

    # 7. one batched ekf_step at the driver's compile-check shape
    nb = 1024
    mean = rng.standard_normal((nb, 4)).astype(np.float32)
    z = rng.standard_normal((nb, 2)).astype(np.float32)
    u = np.stack([1.0 + 0.1 * rng.standard_normal(nb), np.full(nb, 0.1)], -1).astype(np.float32)
    results = {}
    for dev in ("cpu", device):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        belief = GaussianBelief(t(mean), torch.eye(4, device=dev).expand(nb, 4, 4))
        q = 0.01 * torch.eye(4, device=dev)
        r = torch.eye(2, device=dev)
        results[str(dev)] = ekf_step(belief, t(z), t(u), DT, q, r)
    torch.cuda.synchronize()
    # f32 on both sides; the GPU's fused multiply-adds and reduction order
    # move the last bits of values of order 1
    for part in ("mean", "cov"):
        check_close(f"ekf_step B={nb} f32 cuda vs cpu {part}",
                    getattr(results[str(device)], part).cpu(), getattr(results["cpu"], part), 1e-5)

    # 8. the 330-step demo on the card at f64 against the numpy golden
    start = time.perf_counter()
    trace = run_ekf_localization_demo(steps=330, device=device, dtype=torch.float64)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - start
    estimate = trace["estimate"].cpu().numpy()
    golden = numpy_demo_golden()
    err = float(np.abs(estimate - golden).max())
    print(f"demo 330 steps f64 on cuda: {demo_s!r} s host clock, max|diff| vs numpy golden {err!r} (atol 1e-9)")
    if not err <= 1e-9:
        fail(f"demo differs from the numpy golden by {err!r}")

    # 9. the wavefront kernel (B2) against its twins, bitwise: K-sweep
    # launches one by one, then wavefront_relax (one launch per call) to
    # convergence and under caps of 12 and 37 sweeps
    grid_rng = np.random.default_rng(SEED + 1)
    free, goals = grid_workload(grid_rng, GRID_B, GRID_W, GRID_H, device)
    b2_err = check_sweeps_bitwise(
        f"wavefront_sweep f32 B={GRID_B} {GRID_W}x{GRID_H} 8-connected", free, goals, torch.float32)
    check_sweeps_bitwise(f"wavefront_sweep f64 B=4 {GRID_W}x{GRID_H} 8-connected",
                         free[:4], goals[:4], torch.float64)
    big_free, big_goals = grid_workload(grid_rng, 2, 512, 512, device)
    if resident_fits(512, 512, torch.float32):
        fail("a 512x512 map should take the tiled variant")
    check_sweeps_bitwise("wavefront_sweep f32 B=2 512x512 tiled variant", big_free, big_goals,
                         torch.float32)
    check_sweeps_bitwise("wavefront_sweep f64 B=2 512x512 tiled variant", big_free, big_goals,
                         torch.float64)
    if (body(GRID_W, GRID_H, torch.float32), body(GRID_W, GRID_H, torch.float64)) != (
            "registers", "resident"):
        fail("the bench shape should take the register body in f32, shared memory in f64")
    for label, (rf, rg), dtype in (
            (f"wavefront_relax f32 B={GRID_B} {GRID_W}x{GRID_H} registers", (free, goals),
             torch.float32),
            (f"wavefront_relax f64 B=4 {GRID_W}x{GRID_H} resident", (free[:4], goals[:4]),
             torch.float64),
            ("wavefront_relax f32 B=2 512x512 tiled", (big_free, big_goals), torch.float32),
            ("wavefront_relax f64 B=2 512x512 tiled", (big_free, big_goals), torch.float64)):
        d0, bits, costs8 = sweep_operands(rf, rg, dtype)
        for cap in (sweep_cap(rf.shape[1] * rf.shape[2], GRID_K), 12, 37):
            check_relax_bitwise(label, d0, bits, costs8, cap)
    # the f32 shared-memory body, on a map the register body cannot take
    mid_free, mid_goals = grid_workload(grid_rng, 3, 400, 40, device)
    if body(400, 40, torch.float32) != "resident":
        fail("a 400x40 map should take the shared-memory body in f32")
    d0, bits, costs8 = sweep_operands(mid_free, mid_goals, torch.float32)
    for cap in (sweep_cap(400 * 40, GRID_K), 12, 37):
        check_relax_bitwise("wavefront_relax f32 B=3 400x40 resident", d0, bits, costs8, cap)
    del big_free, big_goals, mid_free, mid_goals, d0, bits
    # 37x29 takes the register body in f32 and shared memory in f64, 400x40
    # shared memory in both; 131x127 is just too large for one block
    for w, h in ((37, 29), (400, 40), (131, 127)):
        for ndirs in (4, 8):
            for dtype in (torch.float32, torch.float64):
                check_random_bits(f"wavefront_sweep {body(w, h, dtype)} {ndirs} directions {dtype} "
                                  f"B=3 {w}x{h} random bit plane", grid_rng, (3, w, h), dtype,
                                  ndirs, device)
    small_free, small_goals = grid_workload(grid_rng, 3, 32, 32, "cpu", p_blocked=0.25)
    check_costs_equal("wavefront_costs_fused 32x32 4-connected", device, small_free, small_goals,
                      connectivity=4)
    check_costs_equal("wavefront_costs_fused 32x32 corner cutting", device, small_free,
                      small_goals, corner_cutting=True)
    check_costs_equal("wavefront_costs_fused 32x32 unbatched", device, small_free[0],
                      small_goals[0])
    check_costs_equal("wavefront_costs_fused 32x32 f64", device, small_free, small_goals,
                      dtype=torch.float64)

    # 10. the grid main path at full width, counted: one B2 launch per
    # call and no read of the device inside it (torch's sync debug mode
    # raises on one), the field bitwise the CPU's
    want_costs = wavefront_costs_fused(free.cpu(), goals.cpu())
    grid_launches = {}
    for entry, call in (("wavefront_costs", wavefront_costs),
                        ("wavefront_costs_fused", wavefront_costs_fused)):
        for fn in counted:
            fn.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            costs = call(free, goals)
        except RuntimeError as exc:
            fail(f"{entry} waited on the device inside the call: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        grid_launches[entry] = {fn.__name__: fn.launches for fn in counted}
        print(f"grid main path ({entry}) launches: {grid_launches[entry]}; no device read "
              f"inside the call")
        if grid_launches[entry]["wavefront_relax"] != 1 or grid_launches[entry]["wavefront_sweeps"]:
            fail(f"{entry} made {grid_launches[entry]} B2 launches, not one wavefront_relax")
        if costs.shape != (GRID_B, GRID_W, GRID_H) or not bitwise_equal(costs.cpu(), want_costs):
            fail(f"{entry} on cuda differs from the CPU's field")
    print("grid main path: wavefront_costs and wavefront_costs_fused on cuda give bitwise the "
          "CPU's field")
    finite = costs[torch.isfinite(costs)]
    if not bool((costs[:, -1, -1] == 0).all()) or finite.numel() < costs.numel() // 2:
        fail("the grid main path's fields do not spread from the goals")
    d0, bits, costs8 = sweep_operands(free, goals, torch.float32)
    d, changed, sweeps_needed = d0, True, 0
    while changed:  # one sweep per launch: how many sweeps these maps need
        d, flags = wavefront_sweeps(d, bits, 1, costs8)
        changed = bool(flags.any())
        sweeps_needed += changed
    grid_cap = sweep_cap(GRID_W * GRID_H, GRID_K)
    _, map_sweeps = wavefront_relax(d0, bits, costs8, grid_cap)
    sweeps_per_map = {"max": int(map_sweeps.max()), "mean": float(map_sweeps.double().mean()),
                      "min": int(map_sweeps.min()), "sum": int(map_sweeps.sum())}
    if sweeps_per_map["max"] != sweeps_needed + 1:
        fail(f"the maps ran at most {sweeps_per_map['max']} sweeps; they need {sweeps_needed} "
             f"and one that lowers nothing")
    bench_sweeps = max(int(float(finite.max()) / 1.0), 1)  # bench.py:166-167
    cells = GRID_B * GRID_W * GRID_H
    relax_ms = time_ms(lambda: wavefront_relax(d0, bits, costs8, grid_cap), reps=10, bursts=5)
    # the same maps in f64, which take the shared-memory body
    d0_64, _, _ = sweep_operands(free, goals, torch.float64)
    relax_f64_ms = time_ms(lambda: wavefront_relax(d0_64, bits, costs8, grid_cap), reps=10,
                           bursts=3)
    relax_plain_ms = time_ms(lambda: wavefront_relax_plain(d0, bits, costs8, grid_cap), reps=1,
                             bursts=2)
    grid_kernel_ms = time_ms(lambda: wavefront_sweeps(d0, bits, GRID_K, costs8), reps=20, bursts=5)
    grid_plain_ms = time_ms(lambda: wavefront_sweeps_plain(d0, bits, GRID_K, costs8),
                            reps=2, bursts=3)
    call_s = {}
    for entry, call in (("wavefront_costs", wavefront_costs),
                        ("wavefront_costs_fused", wavefront_costs_fused)):
        best = math.inf
        for _ in range(3):
            start = time.perf_counter()
            call(free, goals)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - start)
        call_s[entry] = best
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_bound_ms, grid_bound_by = wavefront_bound(GRID_K * cells, cells, 8, peaks)
    relax_bound_ms, relax_bound_by = wavefront_bound(sweeps_per_map["sum"] * GRID_W * GRID_H,
                                                     cells, 8, peaks)
    fixpoint_bound_ms, fixpoint_bound_by = wavefront_bound(sweeps_needed * cells, cells, 8, peaks)
    # one map per SM: the bound over the SMs that GRID_B maps can occupy
    fixpoint_bound_maps_ms = fixpoint_bound_ms * sms / min(GRID_B, sms)
    relaxed = {entry: cells * bench_sweeps / s for entry, s in call_s.items()}
    print(
        f"wavefront_relax B={GRID_B} {GRID_W}x{GRID_H} f32 on {card}: kernel {relax_ms!r} ms per "
        f"call (one launch), twin {relax_plain_ms!r} ms, bound of the sweeps the maps ran "
        f"{relax_bound_ms!r} ms ({relax_bound_by}; "
        f"{8 * WAVEFRONT_OPS_PER_DIRECTION + 2 * WAVEFRONT_OPS_PER_KIND} operations a cell and "
        f"sweep at {peaks['flops'][torch.float32] / 2:.3g} instructions/s), "
        f"{relax_bound_ms / relax_ms:.4f} of the bound")
    print(
        f"wavefront_relax per sweep of the slowest map ({sweeps_per_map['max']} sweeps): f32 "
        f"register body {relax_ms / sweeps_per_map['max'] * 1e3!r} us; f64 shared-memory body "
        f"{relax_f64_ms / sweeps_per_map['max'] * 1e3!r} us ({relax_f64_ms!r} ms per call)")
    print(
        f"wavefront_sweeps K={GRID_K} (continuity): kernel {grid_kernel_ms!r} ms per launch, twin "
        f"{grid_plain_ms!r} ms, bound {grid_bound_ms!r} ms ({grid_bound_by}), "
        f"{grid_bound_ms / grid_kernel_ms:.4f} of the bound")
    print(
        f"grid main path: sweeps needed {sweeps_needed}; sweeps per map {sweeps_per_map}; whole "
        f"calls (host clock) {call_s} s; bound of the needed sweeps {fixpoint_bound_ms!r} ms "
        f"({fixpoint_bound_by}), over the {min(GRID_B, sms)} of {sms} SMs that {GRID_B} maps "
        f"occupy {fixpoint_bound_maps_ms!r} ms; cells relaxed/s as bench.py counts them "
        f"({bench_sweeps} sweeps): {relaxed}")
    del d, d0, d0_64, bits, costs, want_costs, finite

    walled = np.ones((64, 64), bool)  # demos/benchmarks.py:69-83
    walled[20:44, 20] = False
    walled[20, 20:50] = False
    for connectivity in (4, 8):
        plans = {}
        for dev in ("cpu", device):
            grid = grid_from_raster(~walled, resolution=1.0, device=dev)
            plans[str(dev)] = plan_grid(grid, (2.0, 2.0), (60.0, 60.0),
                                        connectivity=connectivity)
        (path_c, cost_c), (path_g, cost_g) = plans["cpu"], plans[str(device)]
        if not (bitwise_equal(path_g.points.cpu(), path_c.points)
                and torch.equal(path_g.mask.cpu(), path_c.mask) and float(cost_g) == float(cost_c)):
            fail(f"plan_grid {connectivity}-connected on cuda differs from the CPU")
        print(f"plan_grid 64x64 walled map {connectivity}-connected on cuda: cost {float(cost_g)!r}, "
              f"{int(path_g.mask.sum())} cells, equal to the CPU")

    # 11. the resampling kernel (B3) against its twin
    rs_rng = np.random.default_rng(SEED + 2)
    b3 = {}
    for key, (rb, rp) in (("saturated", RESAMPLE_SHAPES["saturated"]),
                          ("tiled", RESAMPLE_SHAPES["tiled"])):
        args = resample_inputs(rs_rng, rb, rp, RESAMPLE_D, torch.float32, device)
        b3[key] = check_resample(f"resample f32 B={rb} P={rp} D={RESAMPLE_D}", args, False)
    args = resample_inputs(rs_rng, RAGGED_B, 1024, RESAMPLE_D, torch.float64, device)
    b3["f64"] = check_resample(f"resample f64 B={RAGGED_B} P=1024 D={RESAMPLE_D}", args, True)
    for rp, hot in ((1024, 37), (4096, 777)):
        w = torch.full((2, rp), 1e-12, device=device)
        w[:, hot] = 1.0
        states = torch.randn(2, 3, rp, device=device)
        _, idx, neff = systematic_resample_gather(w, torch.tensor([0.25, 0.75], device=device),
                                                  states)
        if not (bool((idx == hot).all()) and bool((neff < 1.5).all())):
            fail(f"resample P={rp}: all mass on particle {hot} did not send every draw there")
    print("resample: all mass on one particle sends every draw there (P=1024, P=4096)")
    try:
        systematic_resample_gather(*resample_inputs(rs_rng, 2, 1280, 2, torch.float32, device))
    except ValueError as exc:
        print(f"resample P=1280 raises ValueError: {exc}")
    else:
        fail("resample at P=1280 did not raise ValueError")
    del args, w, states

    # 12. the particle-filter main path at full width, counted
    pf_launches = {}
    for fb, fp in PF_FLEETS:
        for fn in counted:
            fn.launches = 0
        start = time.perf_counter()
        belief, estimate, err, step_args = run_pf_fleet(fb, fp, PF_STEPS, device)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - start
        pf_launches[fp] = {kname: fn.launches for kname, fn in kernels.items()}
        print(f"PF main path B={fb} P={fp} launches: {pf_launches[fp]}")
        if pf_launches[fp]["resample"] < 1:
            fail(f"kernel resample was not launched on the PF main path (P={fp})")
        if not (torch.isfinite(belief.states).all() and torch.isfinite(estimate.mean).all()
                and torch.isfinite(estimate.cov).all()):
            fail(f"PF main path P={fp} produced non-finite values")
        median = float(err.median())
        print(f"PF main path B={fb} P={fp}: {PF_STEPS} steps in {fleet_s!r} s host clock; median "
              f"position error {median!r} (limit {PF_MEDIAN_ERROR_LIMIT}), max {float(err.max())!r}")
        if not median <= PF_MEDIAN_ERROR_LIMIT:
            fail(f"PF fleet median error {median!r} > {PF_MEDIAN_ERROR_LIMIT}")
    u, z, lm, gen = step_args
    for _ in range(3):
        belief, estimate = pf_step(belief, u, z, lm, PF_DT, gen, PF_CONTROL_NOISE, PF_RANGE_NOISE)
    torch.cuda.synchronize()
    if not (torch.isfinite(estimate.mean).all() and torch.isfinite(belief.weights).all()):
        fail("pf_step on cuda produced non-finite values")
    print(f"pf_step x3 at B={fb} P={fp} on cuda: finite")

    b3_times = {}
    for key, (rb, rp) in RESAMPLE_SHAPES.items():
        args = resample_inputs(rs_rng, rb, rp, RESAMPLE_D, torch.float32, device)
        kernel_t = time_ms(lambda: systematic_resample_gather(*args), reps=20, bursts=5)
        plain_t = time_ms(lambda: systematic_resample_gather_plain(*args), reps=3, bursts=3)
        (bound_t, bound_by_t), nbytes = resample_bound(rb, rp, RESAMPLE_D, torch.float32, peaks)
        b3_times[key] = {"ms": kernel_t, "plain_ms": plain_t, "bound_ms": bound_t,
                         "bound_by": bound_by_t, "bytes": nbytes,
                         "particles_per_s": rb * rp / (kernel_t * 1e-3)}
        note = " (moves ~10 MB, which sits in the 50 MB L2)" if key == "pinned" else ""
        print(f"resample {key} B={rb} P={rp} D={RESAMPLE_D} f32 on {card}: kernel {kernel_t!r} ms, "
              f"twin {plain_t!r} ms, bound {bound_t!r} ms ({bound_by_t}, {nbytes} bytes){note}, "
              f"{b3_times[key]['particles_per_s']!r} particles/s, "
              f"{bound_t / kernel_t:.4f} of the bound")
        del args

    # 13. the blocked Cholesky (B4/B5) against the f64 factor and its twin
    chol_rng = np.random.default_rng(SEED + 3)
    b4 = {}
    for n in CHOL_SIZES_F32:
        b4[n] = check_cholesky(f"cholesky f32 n={n}", spd(chol_rng, n, torch.float32), device)
    for n in CHOL_RAGGED_F32:
        b4[n] = check_cholesky(f"cholesky f32 n={n}", spd(chol_rng, n, torch.float32), device)
    b4_f64 = check_cholesky(f"cholesky f64 n={CHOL_SIZE_F64}",
                            spd(chol_rng, CHOL_SIZE_F64, torch.float64), device)
    clamp_rel = check_cholesky_clamp(device)
    a_np = spd(chol_rng, CHOL_SIZE_F64, torch.float32)
    a = torch.from_numpy(a_np).to(device)
    rhs = torch.from_numpy(chol_rng.standard_normal(CHOL_SIZE_F64).astype(np.float32)).to(device)
    x = cholesky_solve_blocked(a, rhs)
    solve_rel = float(torch.linalg.norm(a.double() @ x.double() - rhs.double())
                      / torch.linalg.norm(rhs.double()))
    print(f"cholesky_solve_blocked f32 n={CHOL_SIZE_F64}: |a x - b| / |b| = {solve_rel!r} "
          f"(limit {CHOL_SOLVE_REL_F32})")
    if not solve_rel <= CHOL_SOLVE_REL_F32:
        fail(f"cholesky_solve_blocked residual {solve_rel!r} > {CHOL_SOLVE_REL_F32}")

    # B5's entry, on its own path (the JAX package's main path never calls
    # it; it runs B4's kernels), at the size docs/PERF.md measured for B5
    for fn in counted:
        fn.launches = 0
    big = torch.from_numpy(spd(chol_rng, 2560, torch.float32)).to(device)
    big_l = cholesky_blocked_large(big)
    torch.cuda.synchronize()
    b5_launches = cholesky_blocked_large.launches
    print(f"cholesky_blocked_large path n=2560 launches: "
          f"{ {f.__name__: f.launches for f in counted} }")
    if b5_launches < 1 or not bool(torch.isfinite(big_l).all()):
        fail("cholesky_blocked_large did not launch its kernels or gave non-finite values")
    del big, big_l

    chol_times = {}
    for n, dtype in CHOL_TIMED:
        a = torch.from_numpy(spd(chol_rng, n, dtype)).to(device)
        key = f"{'f32' if dtype == torch.float32 else 'f64'} n={n}"
        # the kernel and the two library calls, burst by burst in turn
        kernel_t, library_t, library_ex_t = time_interleaved_ms(
            (lambda: cholesky_blocked(a), lambda: torch.linalg.cholesky(a),
             lambda: torch.linalg.cholesky_ex(a)), reps=10, bursts=10)
        plain_t = time_ms(lambda: cholesky_blocked_plain(a), reps=1, bursts=2 if n > 64 else 5)
        bound_t, bound_by_t = cholesky_bound(n, dtype, peaks)
        faster = "torch.linalg.cholesky_ex" if library_ex_t <= library_t else "torch.linalg.cholesky"
        chol_times[key] = {"ms": kernel_t, "plain_ms": plain_t,
                           "library_ms": min(library_t, library_ex_t), "library": faster,
                           "cholesky_ms": library_t, "cholesky_ex_ms": library_ex_t,
                           "bound_ms": bound_t, "bound_by": bound_by_t}
        print(f"cholesky {key} on {card}: kernel {kernel_t!r} ms, twin {plain_t!r} ms, "
              f"torch.linalg.cholesky {library_t!r} ms, torch.linalg.cholesky_ex "
              f"{library_ex_t!r} ms, bound {bound_t!r} ms ({bound_by_t}), "
              f"{bound_t / kernel_t:.4f} of the bound, {min(library_t, library_ex_t) / kernel_t:.3f}x "
              f"the faster library call")
    chol_phases = {}
    for n in CHOL_PHASED:
        a = torch.from_numpy(spd(chol_rng, n, torch.float32)).to(device)
        cholesky_phases(a)  # warm
        chol_phases[f"f32 n={n}"] = cholesky_phases(a)
        print(f"cholesky f32 n={n} phase clock (CTA 0): {chol_phases[f'f32 n={n}']}")
    del a, rhs, x

    # 14. the BA main path at full width, counted: 200 cameras x 2000 points
    # in f32 on cuda, Schur with reduced_solver="auto" (n = 1200 -> B4)
    problem = ba_problem(BA_CAMERAS, BA_POINTS)
    truth_cams, truth_pts, t0, p0, cam_idx, pt_idx, pixels = problem
    rmse0 = ba_rmse(se3_exp(torch.from_numpy(t0)).numpy(), p0, cam_idx, pt_idx, pixels)
    print(f"BA problem: {BA_CAMERAS} cameras, {BA_POINTS} points, {len(cam_idx)} observations "
          f"({len(cam_idx) / BA_POINTS:.1f} per point), retained system n = "
          f"{6 * BA_CAMERAS}, dense H {6 * BA_CAMERAS + 3 * BA_POINTS}^2; initial RMSE "
          f"{rmse0!r} px")
    for fn in counted:
        fn.launches = 0
    cams, pts, summary, ba_s = run_ba(problem, device, torch.float32, "auto")
    ba_launches = {f.__name__: f.launches for f in counted}
    print(f"BA main path launches: {ba_launches}; {summary}")
    if ba_launches["cholesky_blocked"] < max(summary.linear_iterations, 1):
        fail(f"B4 launched {ba_launches['cholesky_blocked']} times for "
             f"{summary.linear_iterations} linear solves")
    if not (torch.isfinite(cams).all() and torch.isfinite(pts).all()):
        fail("the BA main path produced non-finite values")
    rmse = ba_rmse(cams.cpu().numpy(), pts.cpu().numpy(), cam_idx, pt_idx, pixels)
    print(f"BA f32 on cuda: reprojection RMSE {rmse0!r} -> {rmse!r} px (limit "
          f"{BA_RMSE_LIMIT_F32}); first solve {ba_s!r} s host clock (first use of its kernels "
          f"included)")
    if not rmse <= BA_RMSE_LIMIT_F32:
        fail(f"BA f32 RMSE {rmse!r} > {BA_RMSE_LIMIT_F32}")
    _, _, warm, ba_warm_s = run_ba(problem, device, torch.float32, "auto")
    print(f"BA f32 on cuda, again: {warm.iterations} LM iterations in {ba_warm_s!r} s host clock "
          f"({ba_warm_s / max(warm.iterations, 1)!r} s each)")

    ba64 = {}
    for reduced in ("pallas_chol", "dense"):
        for fn in counted:
            fn.launches = 0
        c64, p64, s64, s64_s = run_ba(problem, device, torch.float64, reduced)
        ba64[reduced] = (c64.cpu().numpy(), p64.cpu().numpy(), s64)
        print(f"BA f64 on cuda reduced_solver={reduced}: {s64}; {s64_s!r} s; B4 launches "
              f"{cholesky_blocked.launches}; RMSE "
              f"{ba_rmse(ba64[reduced][0], ba64[reduced][1], cam_idx, pt_idx, pixels)!r} px")
    (ck, pk, sk), (cd, pd, sd) = ba64["pallas_chol"], ba64["dense"]
    ba64_err = max(float(np.abs(ck - cd).max()), float(np.abs(pk - pd).max()))
    if (sk.termination, sk.iterations) != (sd.termination, sd.iterations) \
            or not ba64_err <= BA_F64_ATOL:
        fail(f"BA f64: pallas_chol {sk} against dense {sd}, max|diff| {ba64_err!r}")
    print(f"BA f64: pallas_chol and dense agree (same termination and iterations, "
          f"max|diff| {ba64_err!r}, atol {BA_F64_ATOL})")

    phases, ba_state = ba_iteration_phases(problem, device)
    ba_phase_ms = phase_times(phases)
    print(f"BA one LM iteration f32 on {card}, device ms by phase: {ba_phase_ms}; "
          f"sum {sum(ba_phase_ms.values())!r} ms")

    # where the two new main paths spend their time; last, because the
    # profiler slows the small kernels timed after it
    grid_profile = {}
    for entry, call in (("wavefront_costs", wavefront_costs),
                        ("wavefront_costs_fused", wavefront_costs_fused)):
        grid_profile[entry] = device_breakdown(f"grid main path, one {entry} call",
                                               lambda: call(free, goals))
        b2_events = [n for n in grid_profile[entry]["names"] if "relax_" in n]
        grid_profile[entry]["b2_launches"] = len(b2_events)
        print(f"B2 kernel launches in one {entry} call (profiler): {len(b2_events)} {b2_events}")
        if len(b2_events) != 1:
            fail(f"one {entry} call made {len(b2_events)} B2 device launches, not 1")

    def pf_main_step():
        stepped = pf_predict(belief, u, PF_DT, PF_CONTROL_NOISE, gen)
        stepped = pf_update_ranges(stepped, z, lm, PF_RANGE_NOISE)
        pf_estimate(resample_if_needed_fused(stepped, gen))

    device_breakdown(f"PF main path, one step at B={fb} P={fp}", pf_main_step)
    del free, goals, belief, estimate, err, step_args, u, z, lm, gen
    device_breakdown("BA main path, one LM iteration (f32, n = 1200 retained)",
                     lambda: [fn() for fn in phases.values()])
    b4_events = device_breakdown("B4, one factorisation of the BA's retained system (n = 1200, f32)",
                                 lambda: cholesky_blocked(ba_state["s"]))["names"]
    print(f"B4 kernel launches per factorisation (profiler): {len(b4_events)} {b4_events}")
    if len(b4_events) != 1 or "chol_persistent" not in b4_events[0]:
        fail(f"one B4 factorisation made {len(b4_events)} device launches, not 1")
    chol_ptxas = {("float32" if "IfE" in k else "float64"): v
                  for k, v in ptxas_report("cholesky").items() if "chol_persistent" in k}
    print(f"ptxas cholesky: {chol_ptxas}")
    b2_ptxas = {f"{kind} {'f64' if 'IdE' in k else 'f32'}": v
                for k, v in ptxas_report("wavefront_sweep").items()
                for kind in ("registers", "resident", "tiled") if f"relax_{kind}" in k}
    print(f"ptxas wavefront_sweep: {b2_ptxas}")
    if b2_ptxas["registers f32"]["spill_stores"] or b2_ptxas["registers f32"]["spill_loads"]:
        fail(f"B2's register body spills: {b2_ptxas['registers f32']}")

    # 15. bench.py's four pose-graph workloads (no kernel on their path)
    print(json.dumps({"pose_graph": pose_graph_phase(card, device)}))

    # 16. the kernels line
    no_library = "none: no single PyTorch call computes it"
    resample_entries = [{
        "name": "resample",
        "route": "cuda",
        "source": "rust_robotics_tpu_torch/csrc/resample.cu",
        "replaces": replaces,
        "launches": pf_launches[rp]["resample"],
        "max_abs_err": b3[key]["max_abs_err"],
        "neff_rtol": b3[key]["neff_rtol"],
        "idx_differ_share": b3[key]["idx_differ_share"],
        "idx_max_abs_diff": b3[key]["idx_max_abs_diff"],
        "cdf_gap_crossed": b3[key]["cdf_gap_crossed"],
        "max_abs_err_f64": b3["f64"]["max_abs_err"],
        "ms": b3_times[key]["ms"],
        "plain_ms": b3_times[key]["plain_ms"],
        "bound_ms": b3_times[key]["bound_ms"],
        "bound_by": b3_times[key]["bound_by"],
        "library_ms": None,
        "library": f"{no_library} (the resampler is cumsum + searchsorted + gather)",
        "shape": {"B": RESAMPLE_SHAPES[key][0], "P": rp, "D": RESAMPLE_D, "dtype": "float32"},
        "particles_per_s": b3_times[key]["particles_per_s"],
        "card": card,
    } for key, rp, replaces in (
        ("saturated", 1024, "rust_robotics_tpu/ops/resample_pallas.py:109"),
        ("tiled", 4096, "rust_robotics_tpu/ops/resample_pallas.py:164"),
    )]
    cholesky_entries = [{
        "name": name,
        "route": "cuda",
        "source": "rust_robotics_tpu_torch/csrc/cholesky.cu",
        "replaces": replaces,
        "launches": launches_n,
        "path": path,
        "launches_per_factorisation": len(b4_events),
        "max_abs_err": b4[n]["max_abs_err"],
        "rel_err_to_f64_factor": b4[n]["rel_f64"],
        "max_abs_err_f64": b4_f64["max_abs_err"],
        "clamp_case_max_rel_diff_f64": clamp_rel,
        "ragged_rel_err_to_f64_factor": {k: b4[k]["rel_f64"] for k in CHOL_RAGGED_F32},
        "ms": chol_times[f"f32 n={n}"]["ms"],
        "plain_ms": chol_times[f"f32 n={n}"]["plain_ms"],
        "bound_ms": chol_times[f"f32 n={n}"]["bound_ms"],
        "bound_by": chol_times[f"f32 n={n}"]["bound_by"],
        "library_ms": chol_times[f"f32 n={n}"]["library_ms"],
        "library": chol_times[f"f32 n={n}"]["library"],
        "times": chol_times,
        "phases": chol_phases,
        "ptxas": chol_ptxas,
        "shape": {"n": n, "dtype": "float32"},
        "card": card,
    } for name, replaces, n, launches_n, path in (
        ("cholesky_blocked", "rust_robotics_tpu/ops/cholesky_pallas.py:110", 1200,
         ba_launches["cholesky_blocked"],
         f"bundle_adjust, {BA_CAMERAS} cameras x {BA_POINTS} points, f32, "
         f"{summary.linear_iterations} linear solves"),
        ("cholesky_blocked_large", "rust_robotics_tpu/ops/cholesky_pallas.py:200", 2560,
         b5_launches, "cholesky_blocked_large at n=2560 (the same kernel as B4)"),
    )]
    print(json.dumps({"kernels": [{
        "name": "ekf_scan",
        "route": "cuda",
        "source": "rust_robotics_tpu_torch/csrc/ekf_scan.cu",
        "replaces": "rust_robotics_tpu/ops/ekf_pallas.py:30",
        "launches": launches["ekf_scan"],
        "max_abs_err": max(err32_mean, err32_cov),
        "max_abs_err_f32": {"mean": err32_mean, "cov": err32_cov},
        "max_abs_err_f64": err64,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library": no_library,
        "shape": {"B": B, "T": T, "dtype": "float32"},
        "updates_per_s": updates,
        "card": card,
    }, {
        "name": "wavefront_sweep",
        "route": "cuda",
        "source": "rust_robotics_tpu_torch/csrc/wavefront_sweep.cu",
        "replaces": "rust_robotics_tpu/ops/wavefront_pallas.py:39",
        "launches": sum(c["wavefront_relax"] for c in grid_launches.values()),
        "launches_per_call": {e: c["wavefront_relax"] for e, c in grid_launches.items()},
        "launches_per_call_profiler": {e: p["b2_launches"] for e, p in grid_profile.items()},
        "max_abs_err": b2_err,
        "ms": relax_ms,
        "plain_ms": relax_plain_ms,
        "bound_ms": relax_bound_ms,
        "bound_by": relax_bound_by,
        "library_ms": None,
        "library": f"{no_library} (a masked min-plus stencil)",
        "shape": {"B": GRID_B, "W": GRID_W, "H": GRID_H, "cap": grid_cap, "dtype": "float32"},
        "sweeps_needed": sweeps_needed,
        "sweeps_per_map": sweeps_per_map,
        "bound_ms_needed_sweeps": fixpoint_bound_ms,
        "bound_ms_needed_sweeps_occupied_sms": fixpoint_bound_maps_ms,
        "f64_shared_memory_body_ms": relax_f64_ms,
        "us_per_sweep": {"f32_registers": relax_ms / sweeps_per_map["max"] * 1e3,
                         "f64_shared_memory": relax_f64_ms / sweeps_per_map["max"] * 1e3},
        "per_16_sweeps": {"ms": grid_kernel_ms, "plain_ms": grid_plain_ms,
                          "bound_ms": grid_bound_ms},
        "call_s": call_s,
        "cells_relaxed_per_s": relaxed,
        "profile": {e: {k: v for k, v in p.items() if k != "names"}
                    for e, p in grid_profile.items()},
        "ptxas": b2_ptxas,
        "card": card,
    }, *resample_entries, *cholesky_entries]}))

    # 17. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
