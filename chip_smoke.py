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
    factorisation, which must be one kernel launch; B3's own device time at
    bench.py's pinned shape (B=256, P=1024) from the profiler, beside the
    CUDA events around its wrapper; ptxas's registers and spills of B2's
    bodies (the register body must not spill);
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
16. the SLAM back end (no kernel on its path): (a) the anchored 10k SE(3)
    chain in f32 (RMSE < 1e-4, gradient_converged, warm time best of 2, the
    rounds and LM iterations by counter, one LM step with no device read
    and its profile, the reads of a whole solve) and the plain 1k SE(3)
    chain in f64 (RMSE < 1e-6); (b) implicit gradients in f64: the 10k
    chain (finite, g[9998] nonzero, cuda = CPU within IFT_CUDA_CPU_REL =
    1e-7 of max|g|, derived there; the f32 call timed), the 100x100 grid
    (finite, the last pose's edges nonzero) and a finite-difference pin on
    a 12-pose chain with two closures; (c)
    `solve_device` on the 1000-pose chain, dense and matfree_pcg: f64
    equal to `solve` (termination, iterations, poses within 1e-7), one
    iteration with no device read, the reads of a whole solve, f32 times;
    (d) ICP: bench_icp's workload converges; 256 pairs of 1000 points in
    lock-step all converge, three lanes equal their solo runs, pair 0
    equals the CPU's within 1e-5; (e) the solver paths (the f32 IFT on a
    10x8 grid and a 200-pose chain, `solve`'s dense, pcg and matfree_pcg,
    `solve_device` and the Schur BA) with float32 matmul precision "high"
    (TF32 allowed) within 1e-5 of "highest" (two "highest" runs differ by
    the order of CUDA's atomic adds); then one JSON line
    `{"slam_backend": {...}}`;
17. the SLAM front end and the remaining filters (no kernel on their path),
    f64 unless noted, each part timed, each one step profiled (launches,
    idle share) and run under sync debug mode "error": (a) EKF-SLAM, the
    reference sim of tests/test_slam_filters.py on cuda against the CPU
    (1e-9) and at its gates, then a fleet of 1024 filters of capacity 32
    for 100 steps past 32 landmarks (every lane within the test's gates, the
    map holding exactly the landmarks seen); (b) FastSLAM 1.0 and 2.0 with
    8192 particles x 32 landmarks for 60 steps (weights finite and
    normalised, pose and map within the test's gates), and cuda against the
    CPU with zero control noise and fed draws (1e-9); (c)
    `ekf_smooth_unicycle` at T = 4096, parallel against sequential on cuda
    (1e-7) and smoothed RMSE below filtered, the parallel filter and
    smoother timed at T = 65536; (d) SR-UKF against the UKF (1e-8) and the
    adaptive filter (its first 64 lanes against the CPU) on 65536 filters x
    200 steps, histogram filters on 1024 rasters of 80x80 (estimates within
    0.5 m); (e) robust and point-to-line ICP on 256 pairs x 1000 points in
    f32 (poses within the test's gates, three lanes equal their solo runs),
    correlative matching of 21^3 candidates on a 400x400 likelihood (the
    true pose found, cuda equal to the CPU), graph SLAM on cuda against the
    CPU; (f) `run_slam_node_loop(60)` on cuda against the CPU (the same
    reasons, poses within 1e-9); then one JSON line
    `{"slam_frontend": {...}}`;
18. the VIO path (no kernel of its own; B4 on the batch VIO's BA), on a
    EuRoC-layout sequence the script writes and loads through the port's
    loader (10 s of 3-D flight, IMU at 200 Hz with the pipeline's noise,
    201 keyframes of EuRoC's cam0, 2000 landmarks on a machine hall's
    walls, 0.5 px): (b) `run_vio_pipeline` in f32 (B4 launched once per BA
    solve, counted) and f64, cold and warm, seconds per stage, LM
    iterations, fused and dead-reckoned RMSE against truth (fused <= dead
    and under twice the port's f64 CPU run), B4 held against its twin and
    the f64 factor on the first and the last retained system (n = 1206)
    that the f32 BA gave it, one BA and one IMU-LM iteration profiled, and
    cuda = CPU in f64 on 40 keyframes; (c) `run_vio_pipeline_windowed` (67
    windows of 3, f64) pipelined, RMSE gated alike, and the sequential
    order on its first 12 windows bitwise equal to the pipelined run's; (d) `detect_corners` +
    `track_with_fb_check` on 64 pairs of 752x480 f32 images shifted by known
    sub-pixel flows (median flow error <= 0.25 px), 4 pairs against the
    CPU, `triangulate_tracks` of the 2000 landmarks over 201 views; (e) one
    batched preintegration, one `lk_track` and one stage-D fusion step
    under sync debug mode "error"; the f32 histogram update and
    `shi_tomasi_response` equal with cuDNN's TF32 flag on and off; then one
    JSON line `{"vio": {...}}`;
19. the distributed programs (no kernel on their path) on a one-rank NCCL
    mesh (one card holds one rank): (a) the DP+TP training step at
    B = 1024 x T = 200 x L = 64 in f32, three Adam steps (the loss finite
    and falling; loss and grads against the unsharded autograd; a step's
    host s, launches and idle share), f64 cuda against the CPU on 64
    trajectories, one step (1e-9); (b) the PF banks at phase 12's fleet (8192 x 1024,
    20 steps, f32) and the particle-sharded FastSLAM at phase 17's size
    (8192 x 32, f64, 60 steps, resampling at least once), each bitwise
    equal to its unsharded function; (c) `solve_sharded` on phase 16's
    1000-pose chain in f64 against `solve(matfree_pcg)` (1e-7, the same
    termination); (d) ring-halo scan odometry on 256 scans x 1000 points,
    f32, bitwise equal to `scan_odometry_serial`; (e) `pipeline_shard_map`
    of 64 microbatches, equal to the stage composition; the collectives of
    each part counted; then one JSON line `{"parallel": {...}}`;
20. one JSON line `{"kernels": [...]}`;
21. the last line, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
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
from rust_robotics_tpu_torch.demos.ekf_localization import (
    default_ekf_noise,
    run_ekf_localization_demo,
)
from rust_robotics_tpu_torch.filters import smoother
from rust_robotics_tpu_torch.filters.extra import (
    HistogramConfig,
    adaptive_step,
    histogram_estimate,
    histogram_init,
    histogram_predict,
    histogram_update_ranges,
    sr_ukf_step,
)
from rust_robotics_tpu_torch.filters.kalman import ekf_step, ukf_step
from rust_robotics_tpu_torch.filters.smoother import (
    ekf_smooth_unicycle,
    parallel_kalman_filter,
    parallel_rts_smoother,
    sequential_rts_smoother,
)
from rust_robotics_tpu_torch.filters.particle import (
    init_particles,
    pf_estimate,
    pf_predict,
    pf_step,
    pf_update_ranges,
    resample_if_needed_fused,
)
from rust_robotics_tpu_torch.core.lie import se3_exp, se3_inverse
from rust_robotics_tpu_torch.data.euroc import EurocDataset
from rust_robotics_tpu_torch.models.motion import unicycle_propagate
from rust_robotics_tpu_torch.nlls import RobustKernel, SolverConfig
from rust_robotics_tpu_torch.nlls import solver as nlls_solver
from rust_robotics_tpu_torch.nlls.solver import device_lm_start
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
from rust_robotics_tpu_torch.core import lie_np
from rust_robotics_tpu_torch.nlls.implicit import pose_graph_implicit_vjp
from rust_robotics_tpu_torch.slam.ekf_slam import ekf_slam_step, init_ekf_slam
from rust_robotics_tpu_torch.slam.fastslam import estimate as fs_estimate
from rust_robotics_tpu_torch.slam.fastslam import fastslam1_step, fastslam2_step, init_fastslam
from rust_robotics_tpu_torch.slam.icp import icp_matching
from rust_robotics_tpu_torch.slam.scan_matching import (
    correlative_scan_match,
    graph_slam_from_landmarks,
    point_to_line_icp,
    robust_icp,
)
from rust_robotics_tpu_torch.slam.slam_node import REASONS, run_slam_node_loop
from rust_robotics_tpu_torch.parallel import mesh as pmesh
from rust_robotics_tpu_torch.parallel.pipeline import (
    pipeline_schedule,
    pipeline_shard_map,
    run_sequential,
)
from rust_robotics_tpu_torch.parallel.sharded_filters import (
    fastslam_oracle_step,
    make_fastslam_sharded_step,
    make_pf_banks_step,
    pf_bank_step,
)
from rust_robotics_tpu_torch.parallel.sharded_nlls import solve_sharded
from rust_robotics_tpu_torch.parallel.sharded_scan import (
    make_sharded_scan_odometry,
    scan_odometry_serial,
    shard_scans,
)
from rust_robotics_tpu_torch import train as ttrain
from rust_robotics_tpu_torch.slam import vio, vio_pp
from rust_robotics_tpu_torch.slam import visual_frontend as vfe
from rust_robotics_tpu_torch.slam.imu import optimize_imu_trajectory, preintegrate
from rust_robotics_tpu_torch.slam.vio import run_vio_pipeline
from rust_robotics_tpu_torch.slam.vio_pp import make_stages, run_vio_pipeline_windowed
from rust_robotics_tpu_torch.slam.pose_graph import (
    anchored_measurements,
    build_pose_graph_2d,
    optimize_pose_graph_2d,
    optimize_pose_graph_3d,
    se2_edge_residual,
    se2_retract,
    se3_anchored_edge_residual,
    se3_retract,
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

# The SLAM back end (phase 16). SE(3): the anchored 10k chain in f32 and the
# plain 1k chain in f64, LM at most 25 iterations, tolerance 1e-10; the RMSE
# gates and the termination are tests/test_tridiag.py:467-486 (JAX measured
# 3.4e-5) and :308-350.
SE3_CHAIN, SE3_CHAIN_F64 = 10000, 1000
SE3_ITERATIONS, SE3_TOLERANCE = 25, 1e-10
SE3_RMSE_F32, SE3_RMSE_F64 = 1e-4, 1e-6
# Implicit gradients in f64 at the sizes tests/test_implicit.py advertises:
# the 10k chain solved for 15 iterations (:247-270), the 100x100 grid with 50
# closures (:220-245), and the finite-difference pin on the 12-pose chain
# with two closures (:81-118: eps 1e-6, rtol 5e-4, atol 1e-7).
IFT_CHAIN, IFT_GRID, IFT_ITERATIONS, IFT_TOLERANCE = 10000, (100, 100, 50), 15, 1e-12
IFT_MIN_GRAD = 1e-8
# cuda against the CPU, the 10k chain's f64 gradient, relative to its
# largest entry: the same undamped solve in another summation order, each
# off the exact one by ~kappa·eps, kappa ~ n^2 = 1e8 for a 10k chain: 1e8 ·
# 1.1e-16 = 1.1e-8 (2.3e-8 measured on the H100); 1e-7 leaves ~4x.
IFT_CUDA_CPU_REL = 1e-7
# the text of torch's one-time notice on entering sync debug mode, which
# `reads_in` does not count as a read
SYNC_DEBUG_NOTICE = "debug mode is a prototype feature"
FD_EPS, FD_RTOL, FD_ATOL = 1e-6, 5e-4, 1e-7
FD_CHECKS = ((0, 0), (5, 1), (10, 2), (11, 0), (12, 1))  # edge, component; 11, 12 are loops
# solve_device against solve on the 1000-pose benchmark chain, f64 (the
# configuration of tests/test_nlls.py:193-215 with a PCG budget of 200);
# poses within 1e-7 as there.
SD_CHAIN, SD_ATOL_F64 = 1000, 1e-7
SD_CONFIG = dict(method="lm", max_iterations=25, gradient_tolerance=1e-10, step_tolerance=1e-10,
                 cost_tolerance=1e-14, pcg_max_iterations=200, pcg_tolerance=1e-10)
# ICP: bench_icp's workload (demos/benchmarks.py:228-242: 120 points in
# [0, 10)^2, a 0.3 rad turn, shift (1, -0.5)), then a fleet of 256 pairs of
# 1000 points in [0, 10)^2, turns in +-0.1 rad, 0.1 m shifts, f32.
ICP_BENCH = (120, 0.3, (1.0, -0.5))
ICP_FLEET, ICP_POINTS, ICP_TURN, ICP_SHIFT = 256, 1000, 0.1, 0.1
ICP_LANES = (0, 97, 255)
# a lane against its solo run: the arithmetic is batch-invariant, so the two
# are equal; 1e-6 is ~8 ulps of a transform entry of ~1
ICP_LANE_ATOL = 1e-6
# one pair on cuda against the CPU, f32: the same steps, elementwise
# rounding may differ (FMA contraction), ~1e-6 at the end; 1e-5 leaves 10x
ICP_CUDA_CPU_ATOL = 1e-5


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


def kernel_device_ms(fn, name_part, reps=20):
    """A kernel's own device time under torch.profiler: `reps` calls of fn,
    the device events whose name holds `name_part`; {min_ms, mean_ms,
    launches}. Fails unless each call launched it once."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and name_part in e.name]
    if len(durs) != reps:
        fail(f"the profiler saw {len(durs)} launches of {name_part} in {reps} calls")
    return {"min_ms": min(durs) / 1e3, "mean_ms": sum(durs) / len(durs) / 1e3,
            "launches": len(durs)}


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


def reads_in(fn, sites=None):
    """fn() under torch's sync debug mode "warn": (its result, the number of
    synchronizing operations it ran, each a device read). Every warning that
    names a synchronizing operation counts, wherever it is raised, except
    torch's notice that the debug mode is a prototype: set_sync_debug_mode
    gives it once a process, on the first call with "warn" or "error", and
    it is no operation. With a dict `sites`, count every read's calling
    line there."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = [w for w in caught if "synchroniz" in str(w.message)
             and SYNC_DEBUG_NOTICE not in str(w.message)]
    for w in reads if sites is not None else ():
        site = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    return out, len(reads)


def no_read_in(label, fn):
    """fn() under sync debug mode "error", where a device read raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"{label}: no device read under torch.cuda.set_sync_debug_mode('error')")
    return out


def timed(fn):
    """(host seconds, fn()) with the device synchronised at both ends."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - start, out


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
    no_read_in("pose graph 10k chain, one LM step", lambda: step(state))
    (_, s_sync), reads = reads_in(lambda: tridiag.solve_chain_lm(
        init_d, *args, max_iterations=PG_ITERATIONS, **PG_LM))
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


def se3_part(card, device):
    """(a) The anchored 10k SE(3) chain in f32 and the plain 1k chain in f64."""
    truth_t, tm, init_t, ef, et, meas, info = pose_graph_bench.synthesize_se3_chain(SE3_CHAIN)
    kw = dict(max_iterations=SE3_ITERATIONS, tolerance=SE3_TOLERANCE,
              linear_solver="chain_direct", device=device)

    def anchored():
        poses, summary = optimize_pose_graph_3d(init_t, ef, et, meas, info, anchored=True, **kw)
        return poses.cpu().numpy(), summary

    calls, steps = tridiag.solve_chain_lm.calls, tridiag.lm_run.steps
    (cold_s, _), reads = reads_in(lambda: timed(anchored))
    rounds = tridiag.solve_chain_lm.calls - calls
    steps = tridiag.lm_run.steps - steps
    warm = [timed(anchored) for _ in range(2)]
    warm_s, (poses, summary) = min(w[0] for w in warm), warm[-1][1]
    err = pose_graph_bench.se3_position_rmse(poses, tm)
    print(f"SE(3) {SE3_CHAIN} chain f32 anchored chain_direct on {card}: RMSE {err!r} (gate "
          f"{SE3_RMSE_F32}; JAX measured 3.4e-5); warm {warm_s!r} s host clock (best of 2), "
          f"cold {cold_s!r} s; {rounds} rounds, {steps} LM iterations in all "
          f"({warm_s / steps!r} s each); last round {summary}; device reads in one solve {reads}")
    if not (err < SE3_RMSE_F32 and summary.termination == "gradient_converged"):
        fail(f"anchored SE(3) 10k chain: RMSE {err!r}, {summary.termination}")
    # one LM step of the first round: no read, and its profile
    z_inv = lie_np.se3_inverse(lie_np.se3_exp(meas))
    _, meas48 = anchored_measurements(init_t, ef, et, z_inv)
    cm, ci, lf, lt, lm, li = tridiag.classify_chain_edges(SE3_CHAIN, ef, et, meas48, info)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    fixed = torch.zeros(SE3_CHAIN, dtype=torch.bool, device=device)
    fixed[0] = True
    args = (t(cm), t(ci), t(lf, torch.int64), t(lt, torch.int64), t(lm), t(li), fixed)
    lm_kw = dict(residual_fn=se3_anchored_edge_residual, retract_fn=se3_retract, tdim=6, rdim=6,
                 gradient_tolerance=SE3_TOLERANCE, step_tolerance=SE3_TOLERANCE,
                 cost_tolerance=SE3_TOLERANCE**2, spd=False)
    zeros = torch.zeros((1, SE3_CHAIN, 6), dtype=torch.float32, device=device)
    state, step = tridiag.chain_lm_start(zeros, *args, **lm_kw)
    no_read_in("SE(3) anchored chain, one LM step", lambda: step(state))
    prof = device_breakdown(f"SE(3) {SE3_CHAIN} anchored chain, one LM step (f32) on {card}",
                            lambda: step(state))
    print(f"SE(3) anchored chain: {len(prof['names'])} device launches per LM step")
    del state, step, args, zeros

    truth64, tm64, init64, ef64, et64, meas64, info64 = \
        pose_graph_bench.synthesize_se3_chain(SE3_CHAIN_F64)
    f64_s, (poses64, s64) = timed(lambda: optimize_pose_graph_3d(
        init64, ef64, et64, meas64, info64, dtype=torch.float64, **kw))
    err64 = pose_graph_bench.se3_position_rmse(poses64, tm64)
    print(f"SE(3) {SE3_CHAIN_F64} chain f64 chain_direct on {card}: RMSE {err64!r} (gate "
          f"{SE3_RMSE_F64}); {f64_s!r} s host clock; {s64}")
    if not err64 < SE3_RMSE_F64:
        fail(f"SE(3) 1k chain f64 RMSE {err64!r} >= {SE3_RMSE_F64}")
    return {"chain_10k_anchored_f32": {
        "rmse": err, "warm_s": warm_s, "cold_s": cold_s, "rounds": rounds,
        "lm_iterations": steps, "last_round": vars(summary), "device_reads_per_solve": reads,
        "launches_per_iteration": len(prof["names"]),
        "profile": {k: v for k, v in prof.items() if k != "names"}},
        "chain_1k_f64": {"rmse": err64, "seconds": f64_s, "summary": vars(s64)}}


def implicit_part(card, device):
    """(b) IFT gradients in f64: the 10k chain (cuda against the CPU), the
    100x100 grid, and the finite-difference pin; the 10k chain in f32 timed."""
    f64 = torch.float64
    out = {}
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(IFT_CHAIN)
    solve_s, (poses, summary) = timed(lambda: optimize_pose_graph_2d(
        initial, ef, et, meas, info, IFT_ITERATIONS, IFT_TOLERANCE, "chain_direct",
        device=device, dtype=f64))
    target = truth[-1]

    def loss(p):
        return torch.sum((p[-1] - torch.as_tensor(target, dtype=p.dtype, device=p.device)) ** 2)

    def chain_ift(where, dtype=f64):
        return pose_graph_implicit_vjp(poses.to(where, dtype), ef, et, meas, info, loss,
                                       device=where, dtype=dtype)[1].cpu().numpy()

    cold_s, g = timed(lambda: chain_ift(device))
    warm_s, g = timed(lambda: chain_ift(device))
    cpu_s, g_cpu = timed(lambda: chain_ift("cpu"))
    f32_s, g32 = timed(lambda: chain_ift(device, torch.float32))
    diff = float(np.abs(g - g_cpu).max())
    scale = float(np.abs(g).max())
    last = IFT_CHAIN - 2  # the last odometry edge (9998), which moves the last pose
    print(f"IFT {IFT_CHAIN} chain f64 on {card}: solve {solve_s!r} s ({summary}); "
          f"pose_graph_implicit_vjp cold {cold_s!r} s, warm {warm_s!r} s (CPU {cpu_s!r} s); "
          f"g[{last}] {g[last].tolist()}; max|g| {scale!r}; cuda - CPU max|diff| {diff!r} (limit "
          f"{IFT_CUDA_CPU_REL} x max|g|); f32 (time only) {f32_s!r} s, "
          f"{int(np.isfinite(g32).sum())} of {g32.size} entries finite")
    if not (np.isfinite(g).all() and max(abs(g[last, 0]), abs(g[last, 1])) > IFT_MIN_GRAD
            and diff <= IFT_CUDA_CPU_REL * scale):
        fail(f"10k chain IFT: finite {bool(np.isfinite(g).all())}, g[{last}] {g[last]}, "
             f"cuda - CPU {diff!r}")
    out["chain_10k"] = {"solve_s": solve_s, "ift_cold_s": cold_s, "ift_warm_s": warm_s,
                        "ift_cpu_s": cpu_s, "ift_f32_s": f32_s, "max_abs_grad": scale,
                        "cuda_minus_cpu": diff, "g_last_odometry": g[last].tolist()}

    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_grid(*IFT_GRID)
    solve_s, (poses_g, summary) = timed(lambda: optimize_pose_graph_2d(
        initial, ef, et, meas, info, IFT_ITERATIONS, IFT_TOLERANCE, "banded_direct",
        device=device, dtype=f64))
    ift_s, (_, g) = timed(lambda: pose_graph_implicit_vjp(
        poses_g, ef, et, meas, info, lambda p: torch.sum(p[-1] ** 2), device=device))
    g = g.cpu().numpy()
    touching = float(np.abs(g[np.asarray(et) == len(truth) - 1]).max())
    print(f"IFT grid {IFT_GRID[0]}x{IFT_GRID[1]} + {IFT_GRID[2]} closures f64 on {card}: solve "
          f"{solve_s!r} s ({summary}); pose_graph_implicit_vjp {ift_s!r} s; max|g| on the edges "
          f"into the last pose {touching!r} (gate > {IFT_MIN_GRAD})")
    if not (np.isfinite(g).all() and touching > IFT_MIN_GRAD):
        fail(f"grid IFT: finite {bool(np.isfinite(g).all())}, edges into the last pose "
             f"{touching!r}")
    out["grid_10k"] = {"solve_s": solve_s, "ift_s": ift_s, "max_abs_grad_last_pose": touching}

    # the finite-difference pin: a 12-pose chain with two closures
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(12)
    ef = np.concatenate([ef, [0, 4]])
    et = np.concatenate([et, [7, 11]])
    meas = np.concatenate([meas, [pose_graph_bench.relative(truth[0], truth[7]),
                                  pose_graph_bench.relative(truth[4], truth[11])]])
    info = np.concatenate([info, [np.eye(3) * 20.0] * 2])

    def solve_fd(m):
        return optimize_pose_graph_2d(initial, ef, et, m, info, 40, IFT_TOLERANCE, "chain_direct",
                                      device=device, dtype=f64)[0]

    def loss_fd(p):
        return torch.sum(p[-1] ** 2)

    _, g = pose_graph_implicit_vjp(solve_fd(meas), ef, et, meas, info, loss_fd, device=device)
    g = g.cpu().numpy()
    pins = []
    for e, k in FD_CHECKS:
        up, down = meas.copy(), meas.copy()
        up[e, k] += FD_EPS
        down[e, k] -= FD_EPS
        fd = (float(loss_fd(solve_fd(up))) - float(loss_fd(solve_fd(down)))) / (2 * FD_EPS)
        pins.append({"edge": e, "component": k, "ift": float(g[e, k]), "fd": fd})
        if not abs(g[e, k] - fd) <= FD_ATOL + FD_RTOL * abs(fd):
            fail(f"IFT against finite differences at edge {e} component {k}: {g[e, k]!r} vs "
                 f"{fd!r}")
    print(f"IFT finite-difference pin on {card} (f64, rtol {FD_RTOL}, atol {FD_ATOL}): {pins}")
    out["fd_pin"] = pins
    return out


def solve_device_part(card, device):
    """(c) solve_device against solve on the 1000-pose chain: f64 equality,
    no read inside an iteration, the reads of a whole solve; f32 times."""
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(SD_CHAIN)

    def problem(dtype):
        t = lambda a, dt=dtype: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
        return build_pose_graph_2d(t(initial), t(ef, torch.int64), t(et, torch.int64), t(meas),
                                   t(info))

    out = {}
    for solver in ("dense", "matfree_pcg"):
        cfg = SolverConfig(linear_solver=solver, **SD_CONFIG)
        prob = problem(torch.float64)
        host, hs = nlls_solver.solve(prob, cfg)
        sites = {}
        (dev, ds), reads = reads_in(lambda: nlls_solver.solve_device(prob, cfg), sites)
        diff = float((dev.groups[0].values - host.groups[0].values).abs().max())
        # solve_device counts the iteration that meets the gradient test, as
        # the JAX while_loop does; solve breaks before counting it
        want_it = hs.iterations + (hs.termination == "gradient_converged")
        print(f"solve_device {solver} {SD_CHAIN} chain f64 on {card}: {ds}; solve {hs}; poses "
              f"max|diff| {diff!r} (atol {SD_ATOL_F64}); device reads in one solve {reads} "
              f"(done every {nlls_solver.DONE_READ_EVERY} iterations + the summary) at {sites}")
        if (ds.termination, ds.iterations) != (hs.termination, want_it) \
                or not diff <= SD_ATOL_F64:
            fail(f"solve_device {solver} against solve: {ds} vs {hs}, max|diff| {diff!r}")
        # a read every DONE_READ_EVERY iterations, one more that finds the
        # solve done, and the summary's
        if reads > ds.iterations // nlls_solver.DONE_READ_EVERY + 2:
            fail(f"solve_device {solver} read the device {reads} times in {ds.iterations} "
                 "iterations")
        state, step = nlls_solver.device_lm_start(prob, cfg)
        no_read_in(f"solve_device {solver}, one LM iteration", lambda: step(state))
        prob32 = problem(torch.float32)
        state, step = nlls_solver.device_lm_start(prob32, cfg)
        prof = device_breakdown(f"solve_device {solver} {SD_CHAIN} chain, one LM iteration (f32) "
                                f"on {card}", lambda: step(state))
        # one call each: the f64 calls above ran the same code (eager
        # PyTorch compiles nothing)
        solve_s, (_, h32) = timed(lambda: nlls_solver.solve(prob32, cfg))
        device_s, (_, s32) = timed(lambda: nlls_solver.solve_device(prob32, cfg))
        times = {"solve": solve_s, "solve_device": device_s}
        print(f"solve_device {solver} f32 on {card}: {device_s!r} s ({s32}); solve {solve_s!r} s "
              f"({h32}); {len(prof['names'])} device launches per iteration")
        out[solver] = {"f64": {"solve_device": vars(ds), "solve": vars(hs), "max_abs_diff": diff,
                               "device_reads_per_solve": reads},
                       "f32_s": times, "f32_summary": {"solve_device": vars(s32),
                                                       "solve": vars(h32)},
                       "launches_per_iteration": len(prof["names"]),
                       "profile": {k: v for k, v in prof.items() if k != "names"}}
    return out


def _rot2(th):
    c, s = np.cos(th), np.sin(th)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


def icp_part(card, device):
    """(d) ICP: bench_icp's workload, then a fleet of scan pairs in lock-step."""
    rng = np.random.default_rng(SEED + 8)
    n, turn, shift = ICP_BENCH
    pts = rng.uniform(size=(n, 2)) * 10.0
    res = icp_matching(pts, pts @ _rot2(turn).T + shift, device=device)
    print(f"ICP bench_icp workload f32 on {card}: {int(res.iterations)} iterations, converged "
          f"{bool(res.converged)}, final error mean {float(res.final_error_mean)!r}, inliers "
          f"{float(res.inlier_ratio_5cm)!r}")
    if not bool(res.converged):
        fail("ICP did not converge on bench_icp's workload")

    prev = rng.uniform(size=(ICP_FLEET, ICP_POINTS, 2)) * 10.0
    ang = rng.uniform(-ICP_TURN, ICP_TURN, ICP_FLEET)
    phi = rng.uniform(0.0, 2 * np.pi, ICP_FLEET)
    shifts = ICP_SHIFT * np.stack([np.cos(phi), np.sin(phi)], -1)
    cur = prev @ _rot2(ang).transpose(0, 2, 1) + shifts[:, None, :]
    prev_d = torch.tensor(prev, dtype=torch.float32, device=device)
    cur_d = torch.tensor(cur, dtype=torch.float32, device=device)

    def fleet():
        out = icp_matching(prev_d, cur_d, device=device)
        out.transform.cpu()
        return out

    seconds, fleet_res = pose_graph_bench._best_of(fleet, 2)
    _, reads = reads_in(fleet)
    its = fleet_res.iterations.cpu().numpy()
    print(f"ICP fleet {ICP_FLEET} pairs x {ICP_POINTS} points f32 on {card}: {seconds!r} s warm "
          f"(best of 2), {ICP_FLEET / seconds!r} pairs aligned/s; iterations min {its.min()} "
          f"mean {its.mean()!r} max {its.max()}; converged {int(fleet_res.converged.sum())} of "
          f"{ICP_FLEET}; device reads in one call {reads}")
    if not bool(fleet_res.converged.all()):
        fail(f"ICP fleet: {int((~fleet_res.converged).sum())} pairs did not converge")
    # the loop's check once an iteration and once more to stop, then the
    # transform's copy and at most one read in the final statistics
    if reads > its.max() + 3:
        fail(f"ICP fleet read the device {reads} times in {its.max()} iterations")
    lanes = {}
    for k in ICP_LANES:
        solo = icp_matching(prev_d[k], cur_d[k], device=device)
        diff = float((solo.transform - fleet_res.transform[k]).abs().max())
        lanes[k] = {"batch": int(its[k]), "solo": int(solo.iterations), "transform_diff": diff}
        if lanes[k]["batch"] != lanes[k]["solo"] or not diff <= ICP_LANE_ATOL:
            fail(f"ICP lane {k} differs from its solo run: {lanes[k]}")
    on_cpu = icp_matching(prev[0], cur[0], device="cpu", dtype=torch.float32)
    cpu_diff = float((on_cpu.transform - fleet_res.transform[0].cpu()).abs().max())
    print(f"ICP lanes {lanes} (atol {ICP_LANE_ATOL}); pair 0 cuda against the CPU: transform "
          f"max|diff| {cpu_diff!r} (atol {ICP_CUDA_CPU_ATOL}), iterations {int(its[0])} / "
          f"{int(on_cpu.iterations)}")
    if not cpu_diff <= ICP_CUDA_CPU_ATOL:
        fail(f"ICP pair 0 cuda against the CPU: {cpu_diff!r}")
    prof = device_breakdown(f"ICP fleet, one call ({ICP_FLEET} pairs) on {card}", fleet)
    return {"bench_icp": {"iterations": int(res.iterations), "converged": bool(res.converged)},
            "fleet": {"pairs": ICP_FLEET, "points": ICP_POINTS, "seconds": seconds,
                      "pairs_per_s": ICP_FLEET / seconds,
                      "iterations": {"min": int(its.min()), "mean": float(its.mean()),
                                     "max": int(its.max())},
                      "device_reads_per_call": reads, "lanes": lanes, "cuda_minus_cpu": cpu_diff,
                      "launches_per_call": len(prof["names"]),
                      "profile": {k: v for k, v in prof.items() if k != "names"}}}


# The solver paths under TF32: the f32 IFT on tests/test_torch_implicit.py's
# 10x8 grid with four closures (the banded IFT) and on a 200-pose chain with
# closures (the chain IFT), and `solve`'s dense, pcg and matfree_pcg routes,
# `solve_device`'s dense route and the Schur route of a 20-camera BA, each
# run twice with torch.set_float32_matmul_precision("highest") and once
# with "high", which lets cuBLAS take TF32. The solvers turn TF32 off
# inside, so a path whose two "highest" runs agree bitwise must give the
# same bits under "high". The banded IFT's scatter-adds (`index_add`) add
# in the order CUDA's atomics take, and its two "highest" runs differ by
# up to 3.4e-6 of the largest entry (an H100 at 700 W); it must stay
# within TF32_REL of "highest". With the guards taken out (a mutated copy,
# same card), the chain IFT moved by 6.3e-5 and the Schur BA by 6.4e-4.
TF32_GRID, TF32_CHAIN, TF32_BA = (10, 8, 4), 200, (20, 200)
TF32_REL = 2e-5


def _rel_err(a, b):
    """max|a − b| relative to max|b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-300))


def tf32_solver_part(card, device):
    """(e) The solver paths give the same result with TF32 allowed as
    without, to the noise of their atomics."""
    f32, f64 = torch.float32, torch.float64
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_grid(*TF32_GRID)
    grid_poses = optimize_pose_graph_2d(initial, ef, et, meas, info, 25, 1e-10, "banded_direct",
                                        device=device, dtype=f64)[0]
    grid = (ef, et, meas, info)
    truth, initial, cef, cet, cmeas, cinfo = pose_graph_bench.synthesize_chain(TF32_CHAIN)
    chain_poses = optimize_pose_graph_2d(initial, cef, cet, cmeas, cinfo, 25, 1e-10,
                                         "chain_direct", device=device, dtype=f64)[0]
    t = lambda a, dt=f32: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    chain_prob = build_pose_graph_2d(t(initial), t(cef, torch.int64), t(cet, torch.int64),
                                     t(cmeas), t(cinfo))
    ba = ba_problem(*TF32_BA)

    def loss(p):
        return torch.sum(p[-1] ** 2)

    def runs():
        out = {
            "ift_grid": pose_graph_implicit_vjp(grid_poses.to(f32), *grid, loss, device=device,
                                                dtype=f32)[1],
            "ift_chain": pose_graph_implicit_vjp(chain_poses.to(f32), cef, cet, cmeas, cinfo,
                                                 loss, device=device, dtype=f32)[1]}
        for solver in ("dense", "pcg", "matfree_pcg"):
            cfg = SolverConfig(linear_solver=solver, max_iterations=5, pcg_max_iterations=50)
            out[f"solve_{solver}"] = nlls_solver.solve(chain_prob, cfg)[0].groups[0].values
        out["solve_device_dense"] = nlls_solver.solve_device(
            chain_prob, SolverConfig(max_iterations=5))[0].groups[0].values
        cams, pts, _, _ = run_ba(ba, device, f32, "dense")
        out["schur"] = torch.cat([cams.reshape(-1), pts.reshape(-1)])
        return out

    saved = torch.get_float32_matmul_precision()
    results = {}
    try:
        for key, precision in (("highest", "highest"), ("again", "highest"), ("high", "high")):
            torch.set_float32_matmul_precision(precision)
            results[key] = runs()
    finally:
        torch.set_float32_matmul_precision(saved)
    want = results["highest"]
    noise = {k: _rel_err(results["again"][k], v) for k, v in want.items()}
    tf32 = {k: _rel_err(results["high"][k], v) for k, v in want.items()}
    bad = [k for k, v in want.items()
           if not (bitwise_equal(results["high"][k], v) if bitwise_equal(results["again"][k], v)
                   else tf32[k] <= TF32_REL)]
    print(f"TF32 allowed (float32 matmul precision 'high') against 'highest' on {card}, f32, "
          f"max rel diff {tf32} (0 where two 'highest' runs agree bitwise, else <= {TF32_REL}); "
          f"two 'highest' runs {noise}")
    if bad:
        fail(f"solver paths change with TF32 allowed: {bad} ({tf32})")
    return {"tf32_max_rel": tf32, "highest_twice_max_rel": noise}


def slam_backend_phase(card, device):
    """The SLAM back end on the port (phase 16; no kernel on its path): each
    part checks its gates and returns its numbers for the JSON line."""
    out = {"card": card}
    for name, part in (("se3", se3_part), ("implicit", implicit_part),
                       ("solve_device", solve_device_part), ("icp", icp_part),
                       ("tf32", tf32_solver_part)):
        start = time.perf_counter()
        out[name] = part(card, device)
        out[name]["part_s"] = time.perf_counter() - start
        print(f"SLAM back end, part {name}: {out[name]['part_s']!r} s")
    return out


# The SLAM front end and the remaining filters (phase 17), f64 unless noted.
# The world: tests/test_slam_filters.py's circle drive (u = (1, 0.1), dt 0.1,
# range noise 0.05, bearing noise 0.01, max range 20 m) past 32 landmarks on
# a jittered 8 x 4 grid, 5 m apart, so that every landmark comes within
# range and none lies within 3 m of another; the gates are that test's:
# final position error < 1.5 m, every mapped landmark within 1 m of a true
# one, the EKF map holding exactly the landmarks seen.
FE_LANDMARKS, FE_DT, FE_CONTROL = 32, 0.1, (1.0, 0.1)
FE_POSE_GATE, FE_MAP_GATE = 1.5, 1.0
FE_Q = np.diag([0.2, (5 * np.pi / 180) ** 2])  # ekf_slam.rs Q_SIM
FE_R = np.diag(np.array([0.05, 0.01]) ** 2 * 25)
FAST_CHOL = np.diag(np.array([0.3, 0.0305]) ** 0.5)  # fastslam1.rs R_SIM-ish
FAST_R = np.diag([0.1, 0.05])
# (a) the reference sim (4 landmarks, capacity 8, 200 steps), then a fleet.
# The fleet starts from a known pose (variance 1e-4: 1 cm, 0.01 rad), as a
# SLAM run's first pose defines its map's frame; with the reference sim's
# identity prior and ~20 landmarks in view at once, the first steps' updates
# are far from linear and the maps came out up to 1-3 m off (8 lanes on
# the CPU), where from a known pose they were within 0.12 m.
# Its R takes standard deviations twice the simulation's noise (0.1 m,
# 0.02 rad): the test's R (5x, 0.25 m and 0.05 rad) opens an association
# gate ~5.6 m wide at 20 m range, wider than the 5 m between the fleet's
# landmarks. 64 lanes on the CPU, worst pose / map error: 5x 0.513 /
# 0.919 m (the 1 m gate all but missed; missed on the H100 at 1024 lanes);
# 2x 0.096 / 0.181 m; 1x 23 lanes off by more than 2 m (overconfident).
# Steps cut to keep the phase near 90 s (on an NVIDIA H100 80GB HBM3 at
# 700 W: 19.9 s for 200 fleet steps, 8.4 + 11.1 s for 100 FastSLAM steps):
# the fleet 100 steps (all 32 landmarks seen), FastSLAM 60 (31 seen) and
# its CPU check 10.
EKF_SLAM_REF_STEPS, EKF_SLAM_FLEET, EKF_SLAM_CAPACITY, EKF_SLAM_STEPS = 200, 1024, 32, 100
EKF_SLAM_FLEET_POSE_VAR = 1e-4
FE_R_FLEET = np.diag(np.array([0.1, 0.02]) ** 2)
# the reference sim on cuda against the CPU, f64: the same updates, each
# dividing by innovation covariances of ~1e-2 (the CPU tests measured up to
# ~1e-11 between JAX and the port over 40 steps); 1e-9 over 200 steps
EKF_SLAM_CUDA_CPU_ATOL = 1e-9
# (b) one filter of P particles x 32 landmarks; the cuda-CPU check with zero
# control noise and fed draws at a smaller P, within 1e-9 as in (a). The
# map gate holds the posterior-mean map (weights x landmark means): the
# test's best particle carries one sample's pose error into a landmark seen
# a few times at the 20 m edge (FastSLAM 2.0 on the CPU, 3 seeds: best
# particle 0.20-0.95 m, posterior mean 0.09-0.16 m; 1.23 m for the best
# particle in a run on the H100).
FAST_P, FAST_STEPS, FAST_CHECK_P, FAST_CHECK_STEPS = 8192, 60, 1024, 10
FAST_CUDA_CPU_ATOL, FAST_WEIGHT_SUM_ATOL = 1e-9, 1e-9
# (c) ekf_smooth_unicycle at T = 4096 against the sequential RTS on cuda,
# within tests/test_smoother.py's atol; the parallel filter and smoother
# timed at T = 65536
SMOOTH_T, SMOOTH_T_TIMED, SMOOTH_ATOL = 4096, 65536, 1e-7
# (d) a fleet of unicycle filters, 200 steps; SR-UKF against the UKF at
# tests/test_filters_extra.py's 1e-8; the adaptive filter on cuda against
# the CPU on its first lanes (the same decisions; states within 1e-9);
# histogram filters on 80 x 80 rasters, tests/test_filters_extra.py's run
# (10 updates at rest, estimate within 0.5 m)
FILTER_FLEET, FILTER_STEPS, SR_UKF_ATOL, ADAPTIVE_CPU_LANES = 65536, 200, 1e-8, 64
ADAPTIVE_CUDA_CPU_ATOL = 1e-9
HIST_FLEET, HIST_ITERS, HIST_GATE = 1024, 10, 0.5
# 4 lanes on cuda against the CPU: probabilities of ~1e-4 after sums that
# differ in order, ~1e-20 apart
HIST_CUDA_CPU_ATOL = 1e-12
# (e) scan matching: pairs of two-wall scans (tests/test_scan_matching_g2o.py's
# shape, 500 points a wall, 0.01 m noise), turns in +-0.1 rad, shifts of
# 0.1 m, f32 as phase 16's ICP; lanes equal their solo runs. The current
# scans are exact images of the noisy previous ones, so point-to-line ICP
# must find the pose (gate 0.02 m/rad, tests/test_scan_matching_g2o.py's).
# Robust ICP runs with 4 % of the points moved 5 m away (that test's share):
# Huber (δ = 0.3) caps each outlier's pull at δ, which leaves a bias of
# order n_out·δ/n_in ≈ 0.0125 m per axis, more along the walls, where
# point-to-point residuals hold weakly; measured on the CPU: up to
# 0.038 m over 16 pairs (0.045 at the test's 200 points, whose gate of 0.03
# holds for its one pair): the gate is 0.06.
SM_PAIRS, SM_POINTS, SM_LANES = 256, 1000, (0, 97, 255)
SM_ROBUST_GATE, SM_P2L_GATE = 0.06, 0.02
# correlative matching: 21 x 21 x 21 candidates (0.1 m, 0.035 rad apart)
# on a 400 x 400 likelihood of 0.05 m cells; the true pose lies on the
# candidate grid, so the search must return it exactly
CSM_CELLS, CSM_RES, CSM_SIGMA, CSM_N = 400, 0.05, 0.1, 21
CSM_POSE = (0.4, -0.3, 0.105)
# graph SLAM on cuda against the CPU in f64: an LM run that ends at the
# rounding floor may take another number of steps (ROADMAP C); poses within
# tests/test_torch_scan_matching.py's 1e-8
GRAPH_CUDA_CPU_ATOL = 1e-8
# (f) the SLAM node loop, 60 steps, cuda against the CPU in f64: each step's
# ICP solves 3x3 normal equations of ~700 points, condition number below
# ~1e4, so its pose delta carries ~1e4 · 1.1e-16 ≈ 1e-12 of rounding that
# differs between the two devices' orders of summation; 60 compositions
# give ≲ 1e-10; 1e-9 leaves 10x. The decisions and reasons must be equal.
NODE_STEPS, NODE_POSE_ATOL = 60, 1e-9


def frontend_landmarks(seed=SEED):
    rng = np.random.default_rng(seed + 17)
    gx, gy = np.meshgrid(np.arange(8) * 5.0 - 12.5, np.arange(4) * 5.0 - 0.5, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1) + rng.uniform(-1.0, 1.0, (FE_LANDMARKS, 2))


def frontend_drive(steps):
    """The true poses [steps, 3] of the circle drive (after each step)."""
    truth, out = np.zeros(3), []
    u = FE_CONTROL
    for _ in range(steps):
        truth = np.array([truth[0] + u[0] * FE_DT * np.cos(truth[2]),
                          truth[1] + u[0] * FE_DT * np.sin(truth[2]),
                          (truth[2] + u[1] * FE_DT + np.pi) % (2 * np.pi) - np.pi])
        out.append(truth)
    return np.stack(out)


def frontend_observations(landmarks, truth, lanes, seed):
    """Range-bearing observations [steps, lanes, L, 3] (range, bearing, id),
    one slot per landmark in id order, and their masks [steps, lanes, L]
    (in range); the noise differs per lane."""
    rng = np.random.default_rng(seed)
    d = landmarks[None] - truth[:, None, :2]  # [T, L, 2]
    rngs = np.linalg.norm(d, axis=-1)
    bearing = (np.arctan2(d[..., 1], d[..., 0]) - truth[:, None, 2] + np.pi) % (2 * np.pi) - np.pi
    steps, n = rngs.shape
    noise = rng.standard_normal((steps, lanes, n, 2))
    obs = np.empty((steps, lanes, n, 3))
    obs[..., 0] = rngs[:, None] + 0.05 * noise[..., 0]
    obs[..., 1] = bearing[:, None] + 0.01 * noise[..., 1]
    obs[..., 2] = np.arange(n)
    return obs, np.broadcast_to((rngs <= 20.0)[:, None], (steps, lanes, n)).copy()


def reference_sim_observations(steps, seed=0):
    """tests/test_slam_filters.py's simulate(): 4 landmarks, compact slots."""
    lms = np.array([[10.0, -2.0], [15.0, 10.0], [3.0, 15.0], [-5.0, 20.0]])
    rng = np.random.default_rng(seed)
    truth = frontend_drive(steps)
    obs, mask = np.zeros((steps, 4, 2)), np.zeros((steps, 4), bool)
    for k in range(steps):
        d = lms - truth[k, :2]
        rngs = np.linalg.norm(d, axis=-1)
        bearing = (np.arctan2(d[:, 1], d[:, 0]) - truth[k, 2] + np.pi) % (2 * np.pi) - np.pi
        j = 0
        for i in range(4):
            if rngs[i] <= 20.0:
                obs[k, j] = [rngs[i] + 0.05 * rng.standard_normal(),
                             bearing[i] + 0.01 * rng.standard_normal()]
                mask[k, j] = True
                j += 1
    return lms, truth, obs, mask


def map_errors(mapped, landmarks):
    """Each mapped landmark's distance to the nearest true one."""
    return np.linalg.norm(mapped[..., :, None, :] - landmarks, axis=-1).min(-1)


def device_launches(label, fn):
    """`profile_step`'s numbers from a trace of the device alone: a call of
    ~30k launches leaves ~10^5 host events, whose processing under
    `device_breakdown` takes tens of seconds."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail(f"{label}: the profiler saw no device events")
    busy_ms = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    span_ms = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) / 1e3
    print(f"{label}: host clock {host_ms!r} ms; under the profiler device busy {busy_ms!r} ms of "
          f"a {span_ms!r} ms span ({1 - busy_ms / span_ms:.3f} idle), {len(events)} device events")
    return {"launches": len(events), "host_ms": host_ms, "busy_ms": busy_ms, "span_ms": span_ms,
            "idle": 1 - busy_ms / span_ms}


def profile_step(label, fn):
    """One call's device launches and idle share under the profiler."""
    prof = device_breakdown(label, fn)
    return {"launches": len(prof["names"]), **{k: v for k, v in prof.items() if k != "names"}}


def ekf_slam_part(card, device):
    """(a) EKF-SLAM: the reference sim on cuda against the CPU, then a fleet."""
    f64 = torch.float64
    lms, truth, obs, mask = reference_sim_observations(EKF_SLAM_REF_STEPS)
    q, r, u = (torch.tensor(a, dtype=f64) for a in (FE_Q, FE_R, FE_CONTROL))

    def run(dev):
        b = init_ekf_slam(8, device=dev)
        o, m = torch.tensor(obs, dtype=f64, device=dev), torch.tensor(mask, device=dev)
        qd, rd, ud = q.to(dev), r.to(dev), u.to(dev)
        for k in range(EKF_SLAM_REF_STEPS):
            b = ekf_slam_step(b, ud, o[k], m[k], FE_DT, qd, rd)
        return b

    on_cuda, on_cpu = run(device), run("cpu")
    diff = max(max_err(on_cuda.mean.cpu(), on_cpu.mean), max_err(on_cuda.cov.cpu(), on_cpu.cov))
    n_lm = int(on_cuda.n_lm)
    pose_err = float(np.linalg.norm(on_cuda.mean[:2].cpu().numpy() - truth[-1, :2]))
    lm_err = map_errors(on_cuda.mean[3:3 + 2 * n_lm].cpu().numpy().reshape(n_lm, 2), lms)
    print(f"EKF-SLAM reference sim ({EKF_SLAM_REF_STEPS} steps, capacity 8) on {card}: cuda "
          f"against the CPU max|diff| {diff!r} (atol {EKF_SLAM_CUDA_CPU_ATOL}); {n_lm} landmarks, "
          f"pose error {pose_err!r}, worst map error {lm_err.max()!r}")
    if not (diff <= EKF_SLAM_CUDA_CPU_ATOL and int(on_cpu.n_lm) == n_lm == 4
            and pose_err < FE_POSE_GATE and lm_err.max() < FE_MAP_GATE):
        fail("EKF-SLAM reference sim: cuda differs from the CPU or misses the test's gates")
    ref = {"steps": EKF_SLAM_REF_STEPS, "cuda_minus_cpu": diff, "landmarks": n_lm,
           "pose_error": pose_err, "map_error_max": float(lm_err.max())}

    landmarks = frontend_landmarks()
    truth = frontend_drive(EKF_SLAM_STEPS)
    obs, mask = frontend_observations(landmarks, truth, EKF_SLAM_FLEET, SEED + 170)
    seen = int(mask.any(axis=(0, 1)).sum())
    obs_d = torch.tensor(obs[..., :2], dtype=f64, device=device)
    mask_d = torch.tensor(mask, device=device)
    qd, rd, ud = q.to(device), torch.tensor(FE_R_FLEET, dtype=f64, device=device), u.to(device)

    def start():
        b = init_ekf_slam(EKF_SLAM_CAPACITY, device=device, batch_shape=(EKF_SLAM_FLEET,))
        b.cov[:, :3, :3] *= EKF_SLAM_FLEET_POSE_VAR
        return b

    def fleet():
        b = start()
        for k in range(EKF_SLAM_STEPS):
            b = ekf_slam_step(b, ud, obs_d[k], mask_d[k], FE_DT, qd, rd)
        return b

    seconds, b = timed(fleet)
    n_lm = b.n_lm.cpu().numpy()
    pose_err = np.linalg.norm(b.mean[:, :2].cpu().numpy() - truth[-1, :2], axis=-1)
    mapped = b.mean[:, 3:].cpu().numpy().reshape(EKF_SLAM_FLEET, EKF_SLAM_CAPACITY, 2)
    slots = np.arange(EKF_SLAM_CAPACITY) < n_lm[:, None]
    lm_err = np.where(slots, map_errors(mapped, landmarks), 0.0)
    print(f"EKF-SLAM fleet {EKF_SLAM_FLEET} filters x capacity {EKF_SLAM_CAPACITY} (state "
          f"{3 + 2 * EKF_SLAM_CAPACITY}), {EKF_SLAM_STEPS} steps on {card}: {seconds!r} s, "
          f"{EKF_SLAM_STEPS / seconds!r} steps/s, {EKF_SLAM_FLEET * EKF_SLAM_STEPS / seconds!r} "
          f"filter-steps/s; landmarks mapped min {n_lm.min()} max {n_lm.max()} (seen {seen}); "
          f"pose error max {pose_err.max()!r}; map error max {lm_err.max()!r}")
    if not ((n_lm == seen).all() and (pose_err < FE_POSE_GATE).all()
            and (lm_err < FE_MAP_GATE).all()):
        fail("EKF-SLAM fleet misses the test's gates")
    b0 = start()
    step = lambda: ekf_slam_step(b0, ud, obs_d[0], mask_d[0], FE_DT, qd, rd)  # noqa: E731
    no_read_in("EKF-SLAM fleet, one step", step)
    prof = profile_step(f"EKF-SLAM fleet, one step ({EKF_SLAM_FLEET} filters) on {card}", step)
    return {"reference_sim": ref,
            "fleet": {"filters": EKF_SLAM_FLEET, "capacity": EKF_SLAM_CAPACITY,
                      "steps": EKF_SLAM_STEPS, "seconds": seconds,
                      "steps_per_s": EKF_SLAM_STEPS / seconds,
                      "filter_steps_per_s": EKF_SLAM_FLEET * EKF_SLAM_STEPS / seconds,
                      "landmarks_seen": seen, "pose_error_max": float(pose_err.max()),
                      "map_error_max": float(lm_err.max()), "one_step": prof}}


def fastslam_part(card, device):
    """(b) FastSLAM 1.0 and 2.0: one filter of FAST_P particles x 32
    landmarks; then cuda against the CPU with zero control noise and fed
    draws."""
    f64 = torch.float64
    landmarks = frontend_landmarks()
    truth = frontend_drive(FAST_STEPS)
    obs, mask = frontend_observations(landmarks, truth, 1, SEED + 171)
    obs, mask = obs[:, 0], mask[:, 0]
    t = lambda a, dev=device: torch.tensor(a, dtype=f64, device=dev)  # noqa: E731
    obs_d, mask_d = t(obs), torch.tensor(mask, device=device)
    u, chol, r = t(FE_CONTROL), t(FAST_CHOL), t(FAST_R)
    out = {}
    for name, step_fn in (("fastslam1", fastslam1_step), ("fastslam2", fastslam2_step)):
        gen = torch.Generator(device=device).manual_seed(SEED)

        def run():
            p = init_fastslam(FAST_P, FE_LANDMARKS, device=device)
            for k in range(FAST_STEPS):
                p = step_fn(p, u, obs_d[k], mask_d[k], FE_DT, chol, r, generator=gen)
            return p

        seconds, p = timed(run)
        w = p.weights
        wsum = float(w.sum())
        pose, best = fs_estimate(p)
        pose_err = float(np.linalg.norm(pose[:2].cpu().numpy() - truth[-1, :2]))
        seen = mask.any(axis=0)
        best = int(best)
        # the map as the posterior mean over the particles: the gate's
        # statistic (the best particle's map is printed beside it)
        lm_mean = torch.einsum("p,pli->li", w / w.sum(), p.lm_mean).cpu().numpy()
        lm_err = np.linalg.norm(lm_mean - landmarks, axis=-1)[seen]
        best_err = np.linalg.norm(p.lm_mean[best].cpu().numpy() - landmarks, axis=-1)[seen]
        all_seen = bool(p.lm_seen.cpu().numpy()[:, seen].all())
        print(f"{name} {FAST_P} particles x {FE_LANDMARKS} landmarks, {FAST_STEPS} steps on "
              f"{card}: {seconds!r} s ({FAST_STEPS / seconds!r} steps/s); weights finite "
              f"{bool(torch.isfinite(w).all())}, sum {wsum!r}; pose error {pose_err!r}; map "
              f"error max {lm_err.max()!r} over {int(seen.sum())} seen (the best particle's "
              f"{best_err.max()!r})")
        if not (torch.isfinite(w).all() and abs(wsum - 1.0) <= FAST_WEIGHT_SUM_ATOL
                and pose_err < FE_POSE_GATE and lm_err.max() < FE_MAP_GATE and all_seen):
            fail(f"{name} misses the test's gates")
        p0 = init_fastslam(FAST_P, FE_LANDMARKS, device=device)
        p0 = step_fn(p0, u, obs_d[0], mask_d[0], FE_DT, chol, r, generator=gen)
        step = lambda: step_fn(p0, u, obs_d[1], mask_d[1], FE_DT, chol, r,  # noqa: E731
                               generator=gen)
        no_read_in(f"{name}, one step", step)
        out[name] = {"particles": FAST_P, "landmarks": FE_LANDMARKS, "steps": FAST_STEPS,
                     "seconds": seconds, "steps_per_s": FAST_STEPS / seconds,
                     "weight_sum": wsum, "pose_error": pose_err,
                     "map_error_max": float(lm_err.max()),
                     "best_particle_map_error_max": float(best_err.max()),
                     "one_step": profile_step(f"{name}, one step ({FAST_P} particles) on {card}",
                                              step)}

    # cuda against the CPU: zero control noise, the same fed draws
    rng = np.random.default_rng(SEED + 172)
    zero = np.zeros((2, 2))
    for name, step_fn, dim in (("fastslam1", fastslam1_step, 2), ("fastslam2", fastslam2_step, 3)):
        noise = rng.standard_normal((FAST_CHECK_STEPS, FAST_CHECK_P, dim))
        unif = rng.uniform(size=(FAST_CHECK_STEPS, 1))

        def run(dev):
            p = init_fastslam(FAST_CHECK_P, FE_LANDMARKS, device=dev)
            for k in range(FAST_CHECK_STEPS):
                p = step_fn(p, t(FE_CONTROL, dev), t(obs[k], dev),
                            torch.tensor(mask[k], device=dev), FE_DT, t(zero, dev),
                            t(FAST_R, dev), draws=(t(noise[k], dev), t(unif[k], dev)))
            return p

        a, b = run(device), run("cpu")
        diff = max(max_err(getattr(a, f).cpu().double(), getattr(b, f).double())
                   for f in ("poses", "weights", "lm_mean", "lm_cov", "lm_seen"))
        print(f"{name} cuda against the CPU ({FAST_CHECK_P} particles, {FAST_CHECK_STEPS} steps, "
              f"zero control noise, fed draws): max|diff| {diff!r} (atol {FAST_CUDA_CPU_ATOL})")
        if not diff <= FAST_CUDA_CPU_ATOL:
            fail(f"{name}: cuda differs from the CPU by {diff!r}")
        out[name]["cuda_minus_cpu"] = diff
    return out


def smoother_part(card, device):
    """(c) ekf_smooth_unicycle at T = SMOOTH_T, parallel against sequential
    on cuda; the parallel filter and smoother timed at T = SMOOTH_T_TIMED."""
    f64 = torch.float64
    rng = np.random.default_rng(SEED + 173)
    dt = 0.1
    us = np.stack([np.full(SMOOTH_T, 1.0), 0.2 * np.sin(0.1 * np.arange(SMOOTH_T))], -1)
    x, truth = np.zeros(4), []
    for k in range(SMOOTH_T):
        x = np.array([x[0] + dt * us[k, 0] * np.cos(x[2]), x[1] + dt * us[k, 0] * np.sin(x[2]),
                      x[2] + dt * us[k, 1], us[k, 0]])
        truth.append(x)
    truth = np.stack(truth)
    zs = truth[:, :2] + 0.3 * rng.standard_normal((SMOOTH_T, 2))
    t = lambda a: torch.tensor(a, dtype=f64, device=device)  # noqa: E731
    q, r = t(np.diag([0.05, 0.05, 0.01, 0.1]) ** 2), t(np.diag([0.3, 0.3]) ** 2)
    m0, p0 = torch.zeros(4, dtype=f64, device=device), torch.eye(4, dtype=f64, device=device)
    zs_d, us_d = t(zs), t(us)
    seconds, res = timed(lambda: ekf_smooth_unicycle(zs_d, us_d, dt, q, r, m0, p0))
    fs, qs, h, cs = smoother._ekf_affine_system(zs_d, us_d, dt, q, r, m0, p0)
    seq_s, seq = timed(lambda: sequential_rts_smoother(fs, qs, h, r, zs_d, m0, p0, cs))
    diff = max(max_err(res["smoothed_means"], seq[0]), max_err(res["smoothed_covs"], seq[1]),
               max_err(res["filtered_means"], seq[2]), max_err(res["filtered_covs"], seq[3]))
    rmse = {k: float(np.sqrt(np.mean(np.sum((res[k][:, :2].cpu().numpy() - truth[:, :2]) ** 2,
                                            -1))))
            for k in ("filtered_means", "smoothed_means")}
    print(f"ekf_smooth_unicycle T={SMOOTH_T} f64 on {card}: {seconds!r} s (EKF loop + parallel "
          f"smoother); sequential RTS {seq_s!r} s; parallel against sequential max|diff| "
          f"{diff!r} (atol {SMOOTH_ATOL}); RMSE filtered {rmse['filtered_means']!r}, smoothed "
          f"{rmse['smoothed_means']!r}")
    if not (diff <= SMOOTH_ATOL and rmse["smoothed_means"] < rmse["filtered_means"]):
        fail("the smoother: parallel differs from sequential, or smoothing does not help")

    n, m = 4, 2
    fs = np.eye(n) + 0.05 * rng.standard_normal((SMOOTH_T_TIMED, n, n))
    qs = np.broadcast_to(0.01 * np.eye(n), (SMOOTH_T_TIMED, n, n))
    hh = rng.standard_normal((m, n))
    cs = 0.1 * rng.standard_normal((SMOOTH_T_TIMED, n))
    zz = rng.standard_normal((SMOOTH_T_TIMED, m))
    args = (t(fs), t(qs), t(hh), t(0.1 * np.eye(m)), t(zz), m0, p0, t(cs))
    times = {}
    for name, fn in (("parallel_kalman_filter", parallel_kalman_filter),
                     ("parallel_rts_smoother", parallel_rts_smoother)):
        runs = [timed(lambda: fn(*args)) for _ in range(3)]
        out_fn = runs[-1][1]
        if not all(torch.isfinite(o).all() for o in out_fn):
            fail(f"{name} at T={SMOOTH_T_TIMED}: non-finite values")
        times[name] = min(s for s, _ in runs[1:])
    print(f"parallel filter and smoother at T={SMOOTH_T_TIMED} f64 on {card}: {times} s "
          f"(best of 2 warm)")
    prof = profile_step(f"parallel_rts_smoother, one call at T={SMOOTH_T_TIMED} on {card}",
                        lambda: parallel_rts_smoother(*args))
    no_read_in("parallel_rts_smoother, one call", lambda: parallel_rts_smoother(*args))
    return {"ekf_smooth_unicycle": {"T": SMOOTH_T, "seconds": seconds,
                                    "sequential_rts_s": seq_s, "parallel_minus_sequential": diff,
                                    "rmse": rmse},
            "timed": {"T": SMOOTH_T_TIMED, "seconds": times, "one_call": prof}}


def filters_part(card, device):
    """(d) SR-UKF and the adaptive filter on a fleet of unicycle filters;
    histogram filters on 80 x 80 rasters."""
    f64 = torch.float64
    gen = torch.Generator(device=device).manual_seed(SEED + 174)
    b = FILTER_FLEET
    q, r = default_ekf_noise(dtype=f64, device=device)
    qc, rc = torch.linalg.cholesky(q), torch.linalg.cholesky(r)
    mean0 = torch.tensor([10.0, 0.0, np.pi / 2, 0.0], dtype=f64, device=device).expand(b, 4)
    # per lane: a circle drive with its own speed and GPS-like fixes (0.5 m);
    # the adaptive filter's fixes are wild (30 m) in 5 % of the steps, which
    # pushes it to its CKF
    speed = 1.0 + 0.1 * torch.randn(b, dtype=f64, device=device, generator=gen)
    zs, wild_zs, us = [], [], []
    x = mean0.clone()
    for _ in range(FILTER_STEPS):
        u = torch.stack([speed, torch.full_like(speed, 0.1)], -1)
        x = unicycle_propagate(x, u, DT)
        wild = torch.rand(b, dtype=f64, device=device, generator=gen) < 0.05
        noise = torch.randn((b, 2), dtype=f64, device=device, generator=gen)
        zs.append(x[:, :2] + 0.5 * noise)
        wild_zs.append(x[:, :2] + torch.where(wild[:, None], 30.0, 0.5) * noise)
        us.append(u)
    truth = x
    eye = torch.eye(4, dtype=f64, device=device).expand(b, 4, 4)

    def sr_run():
        m, s = mean0, eye
        for k in range(FILTER_STEPS):
            m, s = sr_ukf_step(m, s, zs[k], us[k], DT, qc, rc)
        return m, s

    def ukf_run():
        bel = GaussianBelief(mean0, eye)
        for k in range(FILTER_STEPS):
            bel = ukf_step(bel, zs[k], us[k], DT, q, r)
        return bel

    def sr_against_ukf():
        """Each SR-UKF step against a UKF step from the same belief, as
        tests/test_filters_extra.py holds one step: the largest difference
        over the run."""
        m, s = mean0, eye
        worst = torch.zeros((), dtype=f64, device=device)
        for k in range(FILTER_STEPS):
            ref = ukf_step(GaussianBelief(m, s @ s.mT), zs[k], us[k], DT, q, r)
            m, s = sr_ukf_step(m, s, zs[k], us[k], DT, qc, rc)
            worst = torch.maximum(worst, torch.maximum((m - ref.mean).abs().max(),
                                                       (s @ s.mT - ref.cov).abs().max()))
        return float(worst)

    def adaptive_run(lanes=slice(None), dev=device):
        lane = lambda a: a[lanes].to(dev)  # noqa: E731
        bel = GaussianBelief(lane(mean0), lane(eye))
        use = torch.zeros(bel.mean.shape[0], dtype=torch.bool, device=dev)
        switched = torch.zeros_like(use)
        for k in range(FILTER_STEPS):
            bel, use, _ = adaptive_step(bel, use, lane(wild_zs[k]), lane(us[k]), DT, q.to(dev),
                                        r.to(dev))
            switched = switched | use
        return bel, use, switched

    sr_s, (sr_m, _) = timed(sr_run)
    ukf_s, _ = timed(ukf_run)
    sr_diff = sr_against_ukf()
    ad_s, (ad_b, ad_use, switched) = timed(adaptive_run)
    lanes = slice(0, ADAPTIVE_CPU_LANES)
    cpu_b, cpu_use, cpu_switched = adaptive_run(lanes, "cpu")
    ad_diff = max(max_err(ad_b.mean[lanes].cpu(), cpu_b.mean),
                  max_err(ad_b.cov[lanes].cpu(), cpu_b.cov))
    same_use = bool(torch.equal(switched[lanes].cpu(), cpu_switched)
                    and torch.equal(ad_use[lanes].cpu(), cpu_use))
    err = {k: float(torch.linalg.norm(v[:, :2] - truth[:, :2], dim=-1).max())
           for k, v in (("sr_ukf", sr_m), ("adaptive", ad_b.mean))}
    print(f"SR-UKF {b} filters x {FILTER_STEPS} steps f64 on {card}: {sr_s!r} s "
          f"({b * FILTER_STEPS / sr_s!r} filter-steps/s); UKF {ukf_s!r} s; each SR-UKF step "
          f"against a UKF step max|diff| {sr_diff!r} (atol {SR_UKF_ATOL}); adaptive {ad_s!r} s, "
          f"{int(switched.sum())} lanes used the CKF, the first {ADAPTIVE_CPU_LANES} lanes "
          f"against the CPU max|diff| {ad_diff!r} (atol {ADAPTIVE_CUDA_CPU_ATOL}), same switches "
          f"{same_use}; worst final position error {err}")
    if not (sr_diff <= SR_UKF_ATOL and ad_diff <= ADAPTIVE_CUDA_CPU_ATOL and same_use
            and int(switched.sum()) > 0 and all(np.isfinite(v) for v in err.values())):
        fail("SR-UKF or the adaptive filter misses its gate")
    sr_step = lambda: sr_ukf_step(mean0, eye, zs[0], us[0], DT, qc, rc)  # noqa: E731
    use0 = torch.zeros(b, dtype=torch.bool, device=device)
    bel0 = GaussianBelief(mean0, eye)
    ad_step = lambda: adaptive_step(bel0, use0, wild_zs[0], us[0], DT, q, r)  # noqa: E731
    no_read_in("sr_ukf_step", sr_step)
    no_read_in("adaptive_step", ad_step)
    out = {"fleet": b, "steps": FILTER_STEPS,
           "sr_ukf": {"seconds": sr_s, "filter_steps_per_s": b * FILTER_STEPS / sr_s,
                      "ukf_seconds": ukf_s, "minus_ukf": sr_diff,
                      "one_step": profile_step(f"sr_ukf_step, {b} filters on {card}", sr_step)},
           "adaptive": {"seconds": ad_s, "filter_steps_per_s": b * FILTER_STEPS / ad_s,
                        "lanes_switched": int(switched.sum()), "cuda_minus_cpu": ad_diff,
                        "one_step": profile_step(f"adaptive_step, {b} filters on {card}",
                                                 ad_step)},
           "final_position_error_max": err}

    cfg = HistogramConfig()
    lms = torch.tensor([[5.0, 5.0], [-5.0, 5.0], [0.0, -5.0]], dtype=f64, device=device)
    hist_truth = 8.0 * torch.rand((HIST_FLEET, 2), dtype=f64, device=device, generator=gen) - 4.0
    ranges = [torch.linalg.norm(lms - hist_truth[:, None], dim=-1)
              + 0.1 * torch.randn((HIST_FLEET, 3), dtype=f64, device=device, generator=gen)
              for _ in range(HIST_ITERS)]
    still = torch.zeros((HIST_FLEET, 2), dtype=f64, device=device)

    def hist_run(lanes=slice(None), dev=device):
        bel = histogram_init(cfg, f64, device=dev, batch_shape=(hist_truth[lanes].shape[0],))
        for z in ranges:
            bel = histogram_update_ranges(bel, z[lanes].to(dev), lms.to(dev), cfg)
            bel = histogram_predict(bel, still[lanes].to(dev), cfg)
        return bel

    hist_run()  # warm-up: cuDNN picks its convolution on the first call
    hist_s, bel = timed(hist_run)
    est = histogram_estimate(bel, cfg)
    hist_err = torch.linalg.norm(est - hist_truth, dim=-1)
    cpu_bel = hist_run(slice(0, 4), "cpu")
    hist_diff = max_err(bel[:4].cpu(), cpu_bel)
    print(f"histogram filter {HIST_FLEET} rasters of {cfg.width}x{cfg.height} f64, {HIST_ITERS} "
          f"update+predict on {card}: {hist_s!r} s ({hist_s / HIST_ITERS * 1e3!r} ms per "
          f"update+predict); worst estimate error {float(hist_err.max())!r} (gate {HIST_GATE}); "
          f"4 lanes against the CPU max|diff| {hist_diff!r}")
    if not (float(hist_err.max()) < HIST_GATE and hist_diff <= HIST_CUDA_CPU_ATOL):
        fail("the histogram filter misses its gate")
    hist_step = lambda: histogram_predict(histogram_update_ranges(  # noqa: E731
        bel, ranges[0], lms, cfg), still, cfg)
    no_read_in("histogram update+predict", hist_step)
    out["histogram"] = {"rasters": HIST_FLEET, "cells": cfg.width * cfg.height,
                        "iterations": HIST_ITERS, "seconds": hist_s,
                        "estimate_error_max": float(hist_err.max()), "cuda_minus_cpu": hist_diff,
                        "one_step": profile_step(f"histogram update+predict, {HIST_FLEET} "
                                                 f"rasters on {card}", hist_step)}
    return out


def two_wall_scans(rng, pairs, points, outliers=False):
    """prev [pairs, points, 2]: two noisy walls meeting at the origin; cur:
    prev seen from a pose of a turn in +-0.1 rad and a 0.1 m shift, so that
    the pose maps cur onto prev; the poses [pairs, 3]."""
    t = np.linspace(0.0, 6.0, points // 2)
    walls = np.concatenate([np.stack([t, 0 * t], -1), np.stack([0 * t, t], -1)])
    prev = walls + 0.01 * rng.standard_normal((pairs, points, 2))
    th = rng.uniform(-0.1, 0.1, pairs)
    phi = rng.uniform(0.0, 2 * np.pi, pairs)
    poses = np.stack([0.1 * np.cos(phi), 0.1 * np.sin(phi), th], -1)
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    cur = np.einsum("bpi,bij->bpj", prev - poses[:, None, :2], rot)  # Rᵀ(p − t), as rows
    if outliers:
        cur[:, ::25] += 5.0
    return prev, cur, poses


def scan_matching_part(card, device):
    """(e) robust and point-to-line ICP on a fleet of scan pairs in
    lock-step; correlative matching; graph SLAM on cuda."""
    rng = np.random.default_rng(SEED + 175)
    out = {}
    for name, fn, gate, outliers in (
            ("robust_icp", lambda a, b: robust_icp(a, b, huber_delta=0.3), SM_ROBUST_GATE, True),
            ("point_to_line_icp", point_to_line_icp, SM_P2L_GATE, False)):
        prev, cur, poses = two_wall_scans(rng, SM_PAIRS, SM_POINTS, outliers)
        prev_d = torch.tensor(prev, dtype=torch.float32, device=device)
        cur_d = torch.tensor(cur, dtype=torch.float32, device=device)
        runs = [timed(lambda: fn(prev_d, cur_d)) for _ in range(2)]
        seconds, (pose, dist) = min(s for s, _ in runs), runs[-1][1]
        err = np.abs(pose.cpu().numpy() - poses).max(0)
        lanes = {}
        for k in SM_LANES:
            solo = fn(prev_d[k], cur_d[k])
            lanes[k] = float((solo[0] - pose[k]).abs().max())
        print(f"{name} {SM_PAIRS} pairs x {SM_POINTS} points f32 on {card}: {seconds!r} s warm "
              f"(best of 2), {SM_PAIRS / seconds!r} pairs/s; worst pose error (x, y, yaw) "
              f"{err.tolist()} (gate {gate}); lanes against solo runs max|diff| {lanes}")
        if not ((err < gate).all() and all(d == 0.0 for d in lanes.values())):
            fail(f"{name}: a pose misses the gate, or a lane differs from its solo run")
        no_read_in(f"{name}, one call", lambda: fn(prev_d, cur_d))
        out[name] = {"pairs": SM_PAIRS, "points": SM_POINTS, "seconds": seconds,
                     "pairs_per_s": SM_PAIRS / seconds, "pose_error_max": err.tolist(),
                     "lanes_minus_solo": lanes,
                     "one_call": profile_step(f"{name}, one call ({SM_PAIRS} pairs) on {card}",
                                              lambda: fn(prev_d, cur_d))}

    # correlative matching on a Gaussian likelihood of one scan's points
    prev, _, _ = two_wall_scans(rng, 1, SM_POINTS)
    pts = prev[0]
    f64 = torch.float64
    min_xy = -5.0
    cells = min_xy + CSM_RES * (np.arange(CSM_CELLS) + 0.5)
    pts_d = torch.tensor(pts, dtype=f64, device=device)
    grid = torch.tensor(np.stack(np.meshgrid(cells, cells, indexing="ij"), -1), dtype=f64,
                        device=device).reshape(-1, 2)
    d2 = torch.cdist(grid, pts_d).min(-1).values ** 2
    lik = torch.exp(-0.5 * d2 / CSM_SIGMA**2).reshape(CSM_CELLS, CSM_CELLS)
    pose = np.array(CSM_POSE)
    c, s = np.cos(pose[2]), np.sin(pose[2])
    scan = (pts - pose[:2]) @ np.array([[c, -s], [s, c]])
    kw = dict(search_xy=1.0, search_theta=0.35, n_xy=CSM_N, n_theta=CSM_N)
    scan_d = torch.tensor(scan, dtype=f64, device=device)
    runs = [timed(lambda: correlative_scan_match(scan_d, lik, min_xy, min_xy, CSM_RES, **kw))
            for _ in range(3)]
    csm_s, (best, score, scores) = min(s for s, _ in runs[1:]), runs[-1][1]
    cpu = correlative_scan_match(scan_d.cpu(), lik.cpu(), min_xy, min_xy, CSM_RES, **kw)
    csm_err = np.abs(best.cpu().numpy() - pose).max()
    scores_diff = max_err(scores.cpu(), cpu[2])
    print(f"correlative_scan_match {CSM_N}^3 candidates x {SM_POINTS} points on a "
          f"{CSM_CELLS}x{CSM_CELLS} likelihood f64 on {card}: {csm_s!r} s warm; best "
          f"{best.tolist()} "
          f"(true {list(CSM_POSE)}, max|diff| {csm_err!r}); scores cuda against the CPU "
          f"max|diff| {scores_diff!r}, the same best {torch.equal(best.cpu(), cpu[0])}")
    if not (csm_err < 1e-9 and torch.equal(best.cpu(), cpu[0]) and scores_diff <= 1e-9):
        fail("correlative_scan_match: the true pose was not found, or cuda differs from the CPU")
    no_read_in("correlative_scan_match, one call",
               lambda: correlative_scan_match(scan_d, lik, min_xy, min_xy, CSM_RES, **kw))
    out["correlative_scan_match"] = {
        "candidates": CSM_N**3, "points": SM_POINTS, "cells": CSM_CELLS**2, "seconds": csm_s,
        "pose_error": csm_err, "scores_cuda_minus_cpu": scores_diff,
        "one_call": profile_step(f"correlative_scan_match, one call on {card}",
                                 lambda: correlative_scan_match(scan_d, lik, min_xy, min_xy,
                                                                CSM_RES, **kw))}

    # graph SLAM: tests/test_scan_matching_g2o.py's 15 poses seeing 3 landmarks
    n = 15
    truth = np.stack([np.linspace(0, 7, n), 0.5 * np.sin(np.linspace(0, 3, n)), 0.2 * np.ones(n)],
                     -1)
    lms = np.array([[3.0, 4.0], [6.0, -2.0], [1.0, -3.0]])
    d = lms[None] - truth[:, None, :2]
    obs = np.stack([np.linalg.norm(d, axis=-1),
                    np.arctan2(d[..., 1], d[..., 0]) - truth[:, None, 2]], -1)
    noisy = truth.copy()
    noisy[1:, :2] += 0.2 * rng.standard_normal((n - 1, 2))
    mask = np.ones((n, 3), bool)
    g_s, (g_poses, g_sum) = timed(lambda: graph_slam_from_landmarks(noisy, obs, mask,
                                                                    device=device, dtype=f64))
    c_poses, c_sum = graph_slam_from_landmarks(noisy, obs, mask, device="cpu", dtype=f64)
    g_diff = max_err(g_poses.cpu(), c_poses)
    before = np.abs(noisy[:, :2] - truth[:, :2]).mean()
    after = np.abs(g_poses.cpu().numpy()[:, :2] - truth[:, :2]).mean()
    print(f"graph_slam_from_landmarks {n} poses f64 on {card}: {g_s!r} s; {g_sum}; cuda against "
          f"the CPU max|diff| {g_diff!r} (atol {GRAPH_CUDA_CPU_ATOL}); mean error {before!r} -> "
          f"{after!r}")
    if not (g_diff <= GRAPH_CUDA_CPU_ATOL and after < before):
        fail("graph_slam_from_landmarks: cuda differs from the CPU, or no improvement")
    out["graph_slam"] = {"poses": n, "seconds": g_s, "summary": vars(g_sum),
                         "cuda_minus_cpu": g_diff, "mean_error": [before, after]}
    return out


def slam_node_part(card, device):
    """(f) run_slam_node_loop on cuda against the CPU."""
    seconds, on_cuda = timed(lambda: run_slam_node_loop(steps=NODE_STEPS, device=device))
    cpu_s, on_cpu = timed(lambda: run_slam_node_loop(steps=NODE_STEPS, device="cpu"))
    gd, cd = on_cuda["diagnostics"], on_cpu["diagnostics"]
    same = all(torch.equal(getattr(gd, f).cpu(), getattr(cd, f))
               for f in ("reason_xy", "reason_yaw", "submap_points"))
    alpha_diff = max(max_err(gd.alpha_xy.cpu(), cd.alpha_xy), max_err(gd.alpha_yaw.cpu(),
                                                                      cd.alpha_yaw))
    pose_diff = max(max_err(on_cuda[k].cpu(), on_cpu[k]) for k in ("truth", "raw_odom",
                                                                   "corrected"))
    reasons = sorted({REASONS[int(x)] for x in gd.reason_xy.cpu()})
    final = {"pose_error": float(gd.pose_error[-1]), "odom_error": float(gd.odom_error[-1])}
    print(f"run_slam_node_loop({NODE_STEPS}) f64 on {card}: {seconds!r} s "
          f"({NODE_STEPS / seconds!r} steps/s; the CPU {cpu_s!r} s); reasons and submap counts "
          f"equal to the CPU's {same}; alphas max|diff| {alpha_diff!r}, poses max|diff| "
          f"{pose_diff!r} (atol "
          f"{NODE_POSE_ATOL}); reasons {reasons}; final {final}")
    if not (same and alpha_diff <= NODE_POSE_ATOL and pose_diff <= NODE_POSE_ATOL
            and final["pose_error"] < final["odom_error"]):
        fail("run_slam_node_loop: cuda differs from the CPU, or the gate does not help")
    prof = profile_step(f"run_slam_node_loop, one step on {card}",
                        lambda: run_slam_node_loop(steps=1, device=device))
    return {"steps": NODE_STEPS, "seconds": seconds, "steps_per_s": NODE_STEPS / seconds,
            "cpu_seconds": cpu_s, "alphas_cuda_minus_cpu": alpha_diff,
            "poses_cuda_minus_cpu": pose_diff, "reasons": reasons, "final": final,
            "one_step": prof}


def slam_frontend_phase(card, device):
    """The SLAM front end and the remaining filters (phase 17; no kernel on
    its path): each part checks its gates and returns its numbers."""
    out = {"card": card}
    for name, part in (("ekf_slam", ekf_slam_part), ("fastslam", fastslam_part),
                       ("smoother", smoother_part), ("filters", filters_part),
                       ("scan_matching", scan_matching_part), ("slam_node", slam_node_part)):
        start = time.perf_counter()
        out[name] = part(card, device)
        out[name]["part_s"] = time.perf_counter() - start
        print(f"SLAM front end, part {name}: {out[name]['part_s']!r} s")
    return out



# ---------------------------------------------------------------------------
# Phase 18: the VIO path (no kernel of its own; B4 in the batch VIO's BA)
# ---------------------------------------------------------------------------

# A 10 s stretch of a EuRoC flight (EuRoC MAV, Burri et al. 2016: IMU at
# 200 Hz, cam0 at 20 Hz, 752x480): 2001 IMU samples, 201 keyframes, cam0's
# intrinsics and T_BS from EuRoC's cam0/sensor.yaml, noise at the pipeline's
# accel_sigma 0.02 and gyro_sigma 0.002, 2000 landmarks on the walls of a
# 14 x 10 x 5 m machine-hall box, 0.5 px pixel noise.
VIO_SECONDS, VIO_IMU_HZ, VIO_CAM_HZ = 10.0, 200, 20
VIO_LANDMARKS, VIO_PIXEL_SIGMA = 2000, 0.5
VIO_ACCEL_SIGMA, VIO_GYRO_SIGMA = 0.02, 0.002
VIO_INTRINSICS = (458.654, 457.296, 367.215, 248.375)
VIO_RESOLUTION = (752, 480)
VIO_T_BS = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
VIO_HALL = (7.0, 5.0, 5.0)  # half-length x, half-width y, height z (m)
VIO_MIN_VISIBLE = 30  # landmarks every keyframe must see
VIO_CUT = 40  # keyframes of the cuda-against-CPU run
VIO_WINDOW_FRAMES = 3
# The windowed runs take f64. In f32, stage D's LM sits on its rounding
# floor and runs 13-18 of its 20 iterations (step_converged) where f64 stops
# after 5 by the gradient test (the port's runs on the CPU); at ~2,600
# launches an LM iteration, the first f32 run on the H100 took 1.51 s a
# window, 101 s a run of 67 windows (measured on one H100).
VIO_WINDOWED_DTYPE = torch.float64
# windows that the sequential order runs, to be held bitwise against the
# pipelined run's first windows (a window depends on no later one): the
# whole flight in both orders took 56.4 and 56.6 s, 121 s of the part
# (measured on one H100)
VIO_WINDOWED_PREFIX = 12
FRONT_PAIRS, FRONT_CORNERS, FRONT_MAX_SHIFT = 64, 200, 3.0
FRONT_CPU_PAIRS = 4
# tests/test_visual_frontend.py:62-75: the median flow of the valid points
# within 0.25 px of the true shift; JAX's test asks >15 of 30 corners to
# pass the forward-backward check, half of them, as here of 200
FRONT_MEDIAN_ATOL, FRONT_MIN_OK = 0.25, FRONT_CORNERS // 2


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([np.stack([o, z, z], -1), np.stack([z, c, -s], -1),
                     np.stack([z, s, c], -1)], -2)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                     np.stack([-s, z, c], -1)], -2)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                     np.stack([z, z, o], -1)], -2)


# body x up, body y along -y, body z (cam0's optical axis) along +x at zero
# yaw: EuRoC's MAV carries its IMU with x up and cam0 looking ahead
VIO_R0 = np.array([[0.0, 0.0, 1.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]])


def vio_flight(t):
    """The smooth 3-D flight at times t [N]: (positions, velocities,
    accelerations [N, 3], world-from-body rotations [N, 3, 3], body rates
    [N, 3]). Yaw turns through ~320 degrees, so that every wall is seen;
    pitch and roll sway; position sways on all three axes."""
    ax, wx = np.array([1.5, 1.2, 0.4]), np.array([0.5, 0.7, 0.9])
    ph = np.array([0.0, 0.3, 0.0])
    arg = wx * t[:, None] + ph
    pos = np.array([0.0, 0.0, 1.6]) + ax * np.sin(arg)
    vel = ax * wx * np.cos(arg)
    acc = -ax * wx**2 * np.sin(arg)
    yaw, dyaw = 0.55 * t + 0.3 * np.sin(0.7 * t), 0.55 + 0.21 * np.cos(0.7 * t)
    pitch, dpitch = 0.12 * np.sin(0.8 * t + 0.2), 0.096 * np.cos(0.8 * t + 0.2)
    roll, droll = 0.1 * np.sin(0.6 * t + 0.5), 0.06 * np.cos(0.6 * t + 0.5)
    rot = _rot_z(yaw) @ _rot_y(pitch) @ _rot_x(roll) @ VIO_R0
    # body rates of Rz(yaw) Ry(pitch) Rx(roll), then into the body frame of R0
    rates_e = np.stack([
        droll - dyaw * np.sin(pitch),
        dpitch * np.cos(roll) + dyaw * np.cos(pitch) * np.sin(roll),
        -dpitch * np.sin(roll) + dyaw * np.cos(pitch) * np.cos(roll)], -1)
    return pos, vel, acc, rot, rates_e @ VIO_R0


def _rot_to_quat(r):
    """(w, x, y, z) of rotations [N, 3, 3] (Shepperd's method)."""
    out = np.zeros((len(r), 4))
    for i, m in enumerate(r):
        tr = np.trace(m)
        k = int(np.argmax([tr, m[0, 0], m[1, 1], m[2, 2]]))
        if k == 0:
            s = 2.0 * np.sqrt(1.0 + tr)
            q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                 (m[1, 0] - m[0, 1]) / s]
        else:
            i1, i2, i3 = k - 1, k % 3, (k + 1) % 3
            s = 2.0 * np.sqrt(1.0 + m[i1, i1] - m[i2, i2] - m[i3, i3])
            q = [0.0] * 4
            q[0] = (m[i3, i2] - m[i2, i3]) / s
            q[1 + i1] = 0.25 * s
            q[1 + i2] = (m[i2, i1] + m[i1, i2]) / s
            q[1 + i3] = (m[i3, i1] + m[i1, i3]) / s
        out[i] = q
    return out


def _hall_landmarks(rng, n):
    """n points uniform over the four walls of the hall, by wall area."""
    hx, hy, hz = VIO_HALL
    walls = np.array([2 * hy * hz, 2 * hy * hz, 2 * hx * hz, 2 * hx * hz])
    which = rng.choice(4, size=n, p=walls / walls.sum())
    u, z = rng.uniform(-1.0, 1.0, n), rng.uniform(0.0, hz, n)
    x = np.where(which == 0, hx, np.where(which == 1, -hx, u * hx))
    y = np.where(which == 2, hy, np.where(which == 3, -hy, u * hy))
    return np.stack([x, y, z], -1)


def _project(world_from_cam, points):
    """Pixels [C, L, 2] and depths [C, L] of points [L, 3] in cameras [C, 4, 4]."""
    inv = np.linalg.inv(world_from_cam)
    pc = np.einsum("cij,lj->cli", inv[:, :3, :3], points) + inv[:, None, :3, 3]
    fx, fy, cx, cy = VIO_INTRINSICS
    z = pc[..., 2]
    safe = np.where(z > 1e-9, z, 1.0)
    return np.stack([fx * pc[..., 0] / safe + cx, fy * pc[..., 1] / safe + cy], -1), z


def write_vio_sequence(root, seed=SEED, seconds=VIO_SECONDS):
    """Write the EuRoC layout of the flight under root/mav0 (imu0, cam0,
    ground truth at 200 Hz, the rust_robotics feature-track sidecar) and
    return the truth: keyframe positions [K, 3], world-from-camera poses
    [K, 4, 4], landmarks [L, 3], visibility [L, K] and the noisy pixels
    [L, K, 2]. With `seconds` below VIO_SECONDS it writes the first
    `seconds` of the same flight, draws included (a cut of keyframes)."""
    import os

    rng = np.random.default_rng(seed)
    n_all = int(VIO_SECONDS * VIO_IMU_HZ) + 1
    t = np.arange(n_all) / VIO_IMU_HZ
    pos, vel, acc, rot, rates = vio_flight(t)
    gravity = np.array([0.0, 0.0, -9.81])
    accel = np.einsum("nji,nj->ni", rot, acc - gravity)
    accel = accel + VIO_ACCEL_SIGMA * rng.standard_normal(accel.shape)
    gyro = rates + VIO_GYRO_SIGMA * rng.standard_normal(rates.shape)
    ts = 1_000_000_000 + np.round(t * 1e9).astype(np.int64)
    cam_idx = np.arange(0, n_all, VIO_IMU_HZ // VIO_CAM_HZ)
    body = np.tile(np.eye(4), (len(cam_idx), 1, 1))
    body[:, :3, :3], body[:, :3, 3] = rot[cam_idx], pos[cam_idx]
    cams = body @ VIO_T_BS
    landmarks = _hall_landmarks(rng, VIO_LANDMARKS)
    pix, depth = _project(cams, landmarks)
    w, h = VIO_RESOLUTION
    seen = (depth > 0.3) & (pix[..., 0] >= 0) & (pix[..., 0] < w) & (pix[..., 1] >= 0) \
        & (pix[..., 1] < h)
    pix = pix + VIO_PIXEL_SIGMA * rng.standard_normal(pix.shape)
    n = int(seconds * VIO_IMU_HZ) + 1
    k = int(np.sum(cam_idx < n))
    t, pos, vel, rot, accel, gyro, ts = (x[:n] for x in (t, pos, vel, rot, accel, gyro, ts))
    cam_idx, cams, pix, seen = cam_idx[:k], cams[:k], pix[:k], seen[:k]

    mav0 = os.path.join(root, "mav0")
    for sub in ("imu0", "cam0", "state_groundtruth_estimate0", "rust_robotics"):
        os.makedirs(os.path.join(mav0, sub), exist_ok=True)
    rows = np.concatenate([ts[:, None].astype(np.float64), gyro, accel], -1)
    np.savetxt(os.path.join(mav0, "imu0", "data.csv"), rows, delimiter=",",
               fmt=["%d"] + ["%.17g"] * 6, header="timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z")
    with open(os.path.join(mav0, "imu0", "sensor.yaml"), "w") as f:
        f.write("sensor_type: imu\nT_BS:\n  cols: 4\n  rows: 4\n"
                "  data: [1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]\nrate_hz: 200\n")
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.writelines(f"{ts[i]},{ts[i]}.png\n" for i in cam_idx)
    with open(os.path.join(mav0, "cam0", "sensor.yaml"), "w") as f:
        f.write("sensor_type: camera\ncomment: VI-Sensor cam0 (MT9M034)\nT_BS:\n  cols: 4\n"
                "  rows: 4\n  data: [" + ", ".join(repr(float(v)) for v in VIO_T_BS.ravel())
                + "]\nrate_hz: 20\nresolution: [752, 480]\ncamera_model: pinhole\n"
                "intrinsics: [" + ", ".join(repr(v) for v in VIO_INTRINSICS) + "]\n")
    quat = _rot_to_quat(rot)
    gt = np.concatenate([ts[:, None].astype(np.float64), pos, quat, vel, np.zeros((n, 6))], -1)
    np.savetxt(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), gt,
               delimiter=",", fmt=["%d"] + ["%.17g"] * 16,
               header="timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,"
                      "b_w_x,b_w_y,b_w_z,b_a_x,b_a_y,b_a_z")
    np.savetxt(os.path.join(mav0, "rust_robotics", "landmarks.csv"),
               np.concatenate([np.arange(VIO_LANDMARKS)[:, None], landmarks], -1),
               delimiter=",", fmt=["%d"] + ["%.17g"] * 3, header="landmark_id,x,y,z")
    kf, lm = np.nonzero(seen)  # keyframe-major, as a tracker emits them
    obs = np.stack([ts[cam_idx][kf].astype(np.float64), lm, pix[kf, lm, 0], pix[kf, lm, 1]], -1)
    np.savetxt(os.path.join(mav0, "rust_robotics", "observations.csv"), obs, delimiter=",",
               fmt=["%d", "%d", "%.17g", "%.17g"], header="timestamp_ns,landmark_id,u,v")
    return {"positions": pos[cam_idx], "cams": cams, "landmarks": landmarks,
            "seen": seen.T, "pixels": pix.transpose(1, 0, 2), "observations": len(kf),
            "visible_min": int(seen.sum(1).min())}


def vio_rmse(poses, positions):
    """Translation RMSE of poses [K, 4, 4] (tensor or array) against
    positions [K', 3], on the first K."""
    if isinstance(poses, torch.Tensor):
        poses = poses.double().cpu().numpy()
    d = poses[:, :3, 3] - positions[:len(poses)]
    return float(np.sqrt(np.mean(np.sum(d**2, axis=-1))))


# Gates set from the port's own f64 run on the CPU of this sequence
# (`vio_cpu_reference()`, run on the CPU): fused RMSE 0.015868 m
# (dead-reckoned 0.08674) for the batch pipeline at 201 keyframes, 0.049982 m
# (dead-reckoned 0.08674) for the windowed one; triangulation of the
# landmarks seen 3+ times, median 0.014915 m, 95th percentile 0.14158 m. Each
# limit is twice that: f32 on the card may lose some (the port's f32 CPU
# runs: fused 0.013384-0.018041 m over three); a broken stage loses far more.
VIO_FUSED_RMSE_LIMIT = 2 * 0.015868205467337436
VIO_WINDOWED_RMSE_LIMIT = 2 * 0.04998211456850511
TRI_MEDIAN_LIMIT, TRI_P95_LIMIT = 2 * 0.014914909488638746, 2 * 0.14157684770975054
# cuda against the CPU in f64 on VIO_CUT keyframes: the same f64 solves with
# sums in another order. The BA stops by a step below 1e-10 and may stop an
# iteration apart (26 and 27 on the H100), near the optimum, where the last
# steps still move weakly observed points: 2.7e-7 m measured over poses,
# states and points (measured on one H100); 1e-6 is a thousandth of the
# 0.5 px noise's effect on a point (~1e-3 m), so a wrong step cannot hide
VIO_CUDA_CPU_ATOL = 1e-6
# front end cuda against the CPU, f32: the corners come from elementwise
# arithmetic (bitwise); LK's 49-term window sums add in another order,
# ~1e-6 px after 10 iterations on 3 levels; 1e-3 px leaves ~1000x
FRONT_CUDA_CPU_ATOL = 1e-3


def _vio_stage_profiles(card, device, ds, tracks, res, dtype):
    """One BA iteration and one IMU-LM iteration of the batch pipeline's
    stages 2 and 3, on its own inputs, under the profiler."""
    cam_ts = ds.cam.timestamps
    t_bs = torch.as_tensor(ds.cam.t_bs, device=device).to(dtype)
    cams0 = vio.nav_to_se3(res.dead_reckoned) @ t_bs
    cam_idx = np.searchsorted(cam_ts, tracks.obs_timestamps)
    intr = CameraIntrinsics(*[float(v) for v in ds.cam.intrinsics])
    prob = build_bundle_adjustment(
        cams0, torch.as_tensor(tracks.landmarks, device=device).to(dtype),
        torch.as_tensor(cam_idx, device=device), torch.as_tensor(tracks.obs_landmark_ids,
                                                                 device=device),
        torch.as_tensor(tracks.obs_pixels, device=device).to(dtype), intr, fixed_cameras=2,
        robust=RobustKernel("huber", 2.0))
    one_ba = SolverConfig(linear_solver="schur", max_iterations=1)
    ba = profile_step(f"VIO BA, one LM iteration ({len(cam_ts)} cameras, {dtype}) on {card}",
                      lambda: nlls_solver.solve(prob, one_ba))
    nav0, bias0 = vio.initial_state(ds, device, dtype)
    lanes = [torch.as_tensor(x, device=device).to(dtype) for x in vio.interval_lanes(ds, cam_ts)]
    pres = preintegrate(*lanes, bias0, VIO_ACCEL_SIGMA, VIO_GYRO_SIGMA)
    kw = vio.imu_refine_kwargs(res.dead_reckoned, bias0, res.ba_cameras @ se3_inverse(t_bs),
                               cam_ts)
    k = len(cam_ts)
    imu = profile_step(
        f"VIO IMU refinement, one LM iteration ({k} nav states, {dtype}) on {card}",
        lambda: optimize_imu_trajectory(res.dead_reckoned, bias0.expand(k, 6).clone(), pres,
                                        config=SolverConfig(max_iterations=1), **kw))
    return {"ba_iteration": ba, "imu_iteration": imu}


@contextlib.contextmanager
def retained_systems():
    """Yields a list that gets a copy of each retained system the Schur LM
    hands to B4 (`cholesky_solve_blocked`) while the context is open."""
    entry, kept = nlls_solver.cholesky_solve_blocked, []

    def keep(s, rhs):
        kept.append(s.clone())
        return entry(s, rhs)

    nlls_solver.cholesky_solve_blocked = keep
    try:
        yield kept
    finally:
        nlls_solver.cholesky_solve_blocked = entry


def vio_batch_part(card, device, ds, tracks, truth, counted):
    """(b) run_vio_pipeline on cuda in f32 (B4 on its BA path) and f64, cold
    and warm; B4 against its twin on the f32 BA's own retained systems; cuda
    against the CPU in f64 on the first VIO_CUT keyframes."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        key = "f32" if dtype == torch.float32 else "f64"
        for run in ("cold", "warm"):
            for fn in counted:
                fn.launches = 0
            with retained_systems() as systems:
                seconds, res = timed(lambda: run_vio_pipeline(ds, tracks, device=device,
                                                              dtype=dtype))
            launches = {fn.__name__: fn.launches for fn in counted}
            s = res.summaries
            fused = vio_rmse(res.fused_poses, truth["positions"])
            dead = vio_rmse(vio.nav_to_se3(res.dead_reckoned), truth["positions"])
            ba_rmse_m = vio_rmse(res.ba_cameras @ se3_inverse(
                torch.as_tensor(VIO_T_BS, device=device).to(dtype)), truth["positions"])
            rec = {"seconds": seconds, "stage_seconds": s["seconds"],
                   "iterations": {st: s[st].iterations for st in ("ba", "imu", "fusion")},
                   "terminations": {st: s[st].termination for st in ("ba", "imu", "fusion")},
                   "launches": launches, "fused_rmse": fused, "dead_reckoned_rmse": dead,
                   "ba_rmse": ba_rmse_m}
            out[f"{key}_{run}"] = rec
            print(f"run_vio_pipeline {len(truth['positions'])} keyframes {key} {run} on {card}: "
                  f"{seconds!r} s; stages {s['seconds']}; LM iterations {rec['iterations']} "
                  f"{rec['terminations']}; launches {launches}; RMSE fused {fused!r} m, "
                  f"dead-reckoned {dead!r} m, BA cameras {ba_rmse_m!r} m")
            if key == "f32" and not (launches["cholesky_blocked"] == s["ba"].linear_iterations
                                     == len(systems)):
                fail(f"VIO f32: B4 launched {launches['cholesky_blocked']} times for "
                     f"{s['ba'].linear_iterations} BA solves ({len(systems)} systems handed)")
            if key == "f32" and run == "cold":
                # the kernel on the path's own systems: the first (at the
                # start point) and the last (nearest the optimum)
                rec["b4_on_path"] = {
                    which: check_cholesky(
                        f"cholesky f32 n={a.shape[0]}, the VIO BA's {which} retained system "
                        f"of {len(systems)}", a.cpu().numpy(), device)
                    for which, a in (("first", systems[0]), ("last", systems[-1]))}
            if not (fused <= dead and fused <= VIO_FUSED_RMSE_LIMIT):
                fail(f"VIO {key}: fused RMSE {fused!r} against dead-reckoned {dead!r} "
                     f"(limit {VIO_FUSED_RMSE_LIMIT})")
        out[f"{key}_profile"] = _vio_stage_profiles(card, device, ds, tracks, res, dtype)

    cpu_s, on_cpu = timed(lambda: run_vio_pipeline(ds, tracks, max_keyframes=VIO_CUT,
                                                   device="cpu", dtype=torch.float64))
    cut_s, on_cuda = timed(lambda: run_vio_pipeline(ds, tracks, max_keyframes=VIO_CUT,
                                                    device=device, dtype=torch.float64))
    diff = max(max_err(getattr(on_cuda, n).cpu(), getattr(on_cpu, n))
               for n in ("fused_poses", "ba_cameras", "nav_states", "ba_points"))
    print(f"run_vio_pipeline {VIO_CUT} keyframes f64: cuda {cut_s!r} s, the CPU {cpu_s!r} s; "
          f"max|diff| {diff!r} (atol {VIO_CUDA_CPU_ATOL}); iterations cuda "
          f"{[on_cuda.summaries[s].iterations for s in ('ba', 'imu', 'fusion')]}, CPU "
          f"{[on_cpu.summaries[s].iterations for s in ('ba', 'imu', 'fusion')]}")
    if not diff <= VIO_CUDA_CPU_ATOL:
        fail(f"run_vio_pipeline f64 on cuda differs from the CPU by {diff!r}")
    out["cut"] = {"keyframes": VIO_CUT, "cuda_minus_cpu": diff, "cuda_s": cut_s, "cpu_s": cpu_s}
    return out


def vio_windowed_part(card, device, ds, tracks, truth):
    """(c) run_vio_pipeline_windowed pipelined over the whole flight in f64
    (see VIO_WINDOWED_DTYPE), timed and gated; the sequential order on the
    first VIO_WINDOWED_PREFIX windows, bitwise against the pipelined run's."""
    f = VIO_WINDOWED_DTYPE
    pipe_s, pipe = timed(lambda: run_vio_pipeline_windowed(
        ds, tracks, window_frames=VIO_WINDOW_FRAMES, pipelined=True, device=device, dtype=f))
    stages, windows, _, _ = make_stages(ds, tracks, VIO_WINDOW_FRAMES, device=device, dtype=f)
    seq_s, seq = timed(lambda: run_sequential(stages, windows[:VIO_WINDOWED_PREFIX]))
    rows = sum(o["fused"].shape[0] for o in seq)
    same = all(bitwise_equal(getattr(pipe, attr)[:rows], torch.cat([o[n] for o in seq]))
               for n, attr in (("fused", "fused_poses"), ("dead_reckoned", "dead_reckoned"),
                               ("refined_body", "refined_body")))
    fused = vio_rmse(pipe.fused_poses, truth["positions"])
    dead = vio_rmse(pipe.dead_reckoned, truth["positions"])
    n_w = pipe.num_windows
    prof = device_launches(f"windowed VIO, one window through the four stages, {f}, on {card}",
                           lambda: run_sequential(stages, windows[:1]))
    print(f"run_vio_pipeline_windowed {n_w} windows of {VIO_WINDOW_FRAMES} {f} on {card}: "
          f"pipelined {pipe_s!r} s ({pipe_s / n_w!r} s a window); sequential on the first "
          f"{VIO_WINDOWED_PREFIX} windows {seq_s!r} s ({seq_s / VIO_WINDOWED_PREFIX!r} s a "
          f"window), bitwise equal to the pipelined run's {same}; RMSE fused {fused!r} m, "
          f"dead-reckoned {dead!r} m (limit {VIO_WINDOWED_RMSE_LIMIT})")
    if not (same and pipe.schedule == pipeline_schedule(n_w, 4)):
        fail("windowed VIO: pipelined differs from sequential, or the schedule is not GPipe's")
    if not (fused <= dead and fused <= VIO_WINDOWED_RMSE_LIMIT):
        fail(f"windowed VIO: fused RMSE {fused!r} against dead-reckoned {dead!r}")
    return {"windows": n_w, "pipelined_s": pipe_s, "s_per_window": pipe_s / n_w,
            "sequential_windows": VIO_WINDOWED_PREFIX, "sequential_s": seq_s,
            "bitwise_equal": same, "fused_rmse": fused, "dead_reckoned_rmse": dead,
            "one_window": prof}


def front_end_images(rng, device, pairs=FRONT_PAIRS):
    """Pairs of 752x480 textured float32 images (uniform noise under a 5x5
    box blur, tests/test_visual_frontend.py:17) and the second of each
    shifted by a known sub-pixel flow [pairs, 2] (bilinear resampling)."""
    w, h = VIO_RESOLUTION
    noise = torch.from_numpy(rng.uniform(size=(pairs, h, w)).astype(np.float32)).to(device)
    img0 = vfe._conv2(noise, np.ones((5, 5)) / 25.0)
    flow = rng.uniform(-FRONT_MAX_SHIFT, FRONT_MAX_SHIFT, size=(pairs, 2))
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    f = torch.from_numpy(flow.astype(np.float32)).to(device)
    coords = torch.stack([xx - f[:, None, None, 0], yy - f[:, None, None, 1]], dim=-1)
    return img0, vfe._bilinear(img0, coords), flow


def track_pairs(img0, img1):
    pts, _ = vfe.detect_corners(img0, max_features=FRONT_CORNERS, border=16)
    fwd, ok, err = vfe.track_with_fb_check(img0, img1, pts, window=7, levels=3, iterations=10)
    return pts, fwd, ok, err


def vio_front_end_part(card, device, truth):
    """(d) detect_corners + track_with_fb_check on FRONT_PAIRS pairs;
    triangulate_tracks of the sequence's landmarks; cuda against the CPU."""
    rng = np.random.default_rng(SEED + 18)
    img0, img1, flow = front_end_images(rng, device)
    seconds, (pts, fwd, ok, err) = timed(lambda: track_pairs(img0, img1))
    seconds, (pts, fwd, ok, err) = timed(lambda: track_pairs(img0, img1))
    est = (fwd - pts).double().cpu().numpy()
    okn = ok.cpu().numpy()
    medians = np.array([np.median(np.abs(est[i][okn[i]] - flow[i]), axis=0).max()
                        if okn[i].any() else np.inf for i in range(len(flow))])
    counts = okn.sum(1)
    prof = profile_step(f"front end, {FRONT_PAIRS} pairs detect + track on {card}",
                        lambda: track_pairs(img0, img1))
    print(f"front end {FRONT_PAIRS} pairs 752x480 f32 on {card}: {seconds!r} s "
          f"({FRONT_PAIRS / seconds!r} pairs/s); forward-backward ok per pair min "
          f"{int(counts.min())} of {FRONT_CORNERS}; worst median |flow error| {medians.max()!r} px "
          f"(limit {FRONT_MEDIAN_ATOL})")
    if not (medians.max() <= FRONT_MEDIAN_ATOL and counts.min() >= FRONT_MIN_OK):
        fail("front end: a pair's flow error or its tracked count misses the gate")

    n = FRONT_CPU_PAIRS
    on_cpu = track_pairs(img0[:n].cpu(), img1[:n].cpu())
    corners_equal = bitwise_equal(pts[:n].cpu(), on_cpu[0])
    pt_diff = max_err(fwd[:n].cpu(), on_cpu[1])
    masks_equal = torch.equal(ok[:n].cpu(), on_cpu[2])
    print(f"front end {n} pairs cuda against the CPU: corners bitwise {corners_equal}; tracked "
          f"points max|diff| {pt_diff!r} px (atol {FRONT_CUDA_CPU_ATOL}); masks equal "
          f"{masks_equal}")
    if not (corners_equal and pt_diff <= FRONT_CUDA_CPU_ATOL and masks_equal):
        fail("front end: cuda differs from the CPU")

    cams = torch.as_tensor(truth["cams"], device=device).to(torch.float32)
    seen = torch.as_tensor(truth["seen"], device=device)
    pixels = torch.as_tensor(truth["pixels"], device=device).to(torch.float32)
    tri_s, xyz = timed(lambda: vfe.triangulate_tracks(cams, pixels, seen, VIO_INTRINSICS))
    views = truth["seen"].sum(1)
    errs = np.linalg.norm(xyz.double().cpu().numpy() - truth["landmarks"], axis=-1)[views >= 3]
    tri = {"landmarks": int((views >= 3).sum()), "median_m": float(np.median(errs)),
           "p95_m": float(np.percentile(errs, 95)), "seconds": tri_s}
    print(f"triangulate_tracks {VIO_LANDMARKS} landmarks x {len(truth['cams'])} views f32 on "
          f"{card}: {tri_s!r} s; landmarks seen 3+ times {tri['landmarks']}: error median "
          f"{tri['median_m']!r} m, 95th percentile {tri['p95_m']!r} m (limits "
          f"{TRI_MEDIAN_LIMIT}, {TRI_P95_LIMIT})")
    if not (tri["median_m"] <= TRI_MEDIAN_LIMIT and tri["p95_m"] <= TRI_P95_LIMIT):
        fail("triangulate_tracks: the landmark error misses the gate")
    return {"pairs": FRONT_PAIRS, "seconds": seconds, "pairs_per_s": FRONT_PAIRS / seconds,
            "min_ok": int(counts.min()), "worst_median_flow_error": float(medians.max()),
            "cuda_minus_cpu_px": pt_diff, "profile": prof, "triangulation": tri}


def vio_no_read_part(device, ds, tracks):
    """(e) one batched preintegration, one lk_track call and one stage-D
    fusion step, each under sync debug mode "error"."""
    nav0, bias0 = vio.initial_state(ds, device, torch.float32)
    lanes = [torch.as_tensor(x, device=device).to(torch.float32)
             for x in vio.interval_lanes(ds, ds.cam.timestamps)]
    no_read_in(f"preintegrate, {lanes[0].shape[0]} intervals as lanes",
               lambda: preintegrate(*lanes, bias0, VIO_ACCEL_SIGMA, VIO_GYRO_SIGMA))
    rng = np.random.default_rng(SEED + 19)
    img0, img1, _ = front_end_images(rng, device, pairs=8)
    pts = vfe.detect_corners(img0, max_features=FRONT_CORNERS, border=16)[0]
    no_read_in("lk_track, 8 pairs x 200 points", lambda: vfe.lk_track(img0, img1, pts))
    stages, windows, _, _ = make_stages(ds, tracks, VIO_WINDOW_FRAMES, device=device)
    win = windows[0]
    for st in stages[:3]:
        win = st.fn(st.init_carry, win)[1] if st.chain else st.fn(win)

    def fusion_step():
        state, step = device_lm_start(*vio_pp.fuse_problem(None, win))
        return step(state)

    no_read_in("windowed VIO stage D, one fusion LM step", fusion_step)
    return True


def tf32_part(device):
    """Satellite: the f32 convolutions give the same result with cuDNN's
    TF32 flag at PyTorch's default (True) as with it off."""
    rng = np.random.default_rng(SEED + 20)
    cfg = HistogramConfig()
    belief = histogram_init(cfg, device=device, batch_shape=(16,))
    lm = torch.tensor([[10.0, 0.0], [10.0, 10.0], [0.0, 15.0]], device=device)
    z = torch.from_numpy(rng.uniform(5.0, 15.0, size=(16, 3)).astype(np.float32)).to(device)
    du = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(16, 2)).astype(np.float32)).to(device)
    img = front_end_images(rng, device, pairs=2)[0]

    def run():
        hist = histogram_update_ranges(histogram_predict(belief, du, cfg), z, lm, cfg)
        return hist, vfe.shi_tomasi_response(img)

    off = run()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        on = run()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    same = all(bitwise_equal(a, b) for a, b in zip(on, off))
    print(f"f32 histogram update and shi_tomasi_response with cudnn.allow_tf32 True equal to "
          f"False: {same}")
    if not same:
        fail("an f32 convolution changes with cudnn.allow_tf32")
    return same


def vio_phase(card, device, counted=(cholesky_blocked, cholesky_blocked_large)):
    """The VIO path (phase 18; B4 on the batch VIO's BA): each part checks
    its gates and returns its numbers."""
    import tempfile

    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="vio_seq_") as root:
        start = time.perf_counter()
        truth = write_vio_sequence(root)
        ds = EurocDataset.load(root)
        tracks = ds.load_feature_tracks()
        out["sequence"] = {"imu_samples": len(ds.imu.timestamps),
                           "keyframes": len(ds.cam.timestamps),
                           "landmarks": len(tracks.landmarks),
                           "observations": len(tracks.obs_pixels),
                           "visible_min": truth["visible_min"],
                           "seconds": time.perf_counter() - start}
        print(f"VIO sequence: {out['sequence']}")
        if truth["visible_min"] < VIO_MIN_VISIBLE:
            fail(f"a keyframe sees {truth['visible_min']} landmarks (< {VIO_MIN_VISIBLE})")
        for name, part in (
                ("batch", lambda: vio_batch_part(card, device, ds, tracks, truth, counted)),
                ("windowed", lambda: vio_windowed_part(card, device, ds, tracks, truth)),
                ("front_end", lambda: vio_front_end_part(card, device, truth)),
                ("no_read", lambda: vio_no_read_part(device, ds, tracks)),
                ("tf32", lambda: tf32_part(device))):
            start = time.perf_counter()
            result = part()
            out[name] = result if isinstance(result, dict) else {"ok": result}
            out[name]["part_s"] = time.perf_counter() - start
            print(f"VIO path, part {name}: {out[name]['part_s']!r} s")
    return out


# aten ops that launch nothing (views, allocations, host scalars)
# The distributed programs (phase 19): the port's parallel/ and train.py on
# a one-rank NCCL mesh. NCCL refuses two ranks on one card, so one H100
# holds one rank: the all-reduces, all-gathers and broadcasts still run
# through NCCL (counted by `parallel.mesh.COLLECTIVES`), and a ring shift on
# a one-rank axis is the local copy JAX's ppermute makes there. Each part
# runs at full width and is held against the port's unsharded function on
# the card.
# (a) the training step at the width of `__graft_entry__.py::entry` (B = 1024
# trajectories), T = 200 steps, L = 64 landmarks, f32, three Adam steps at
# make_training_step's default rate; f64 cuda against the CPU on the first
# 64 trajectories, one step (loss and updated parameters), within
# PAR_TRAIN_CUDA_CPU_REL of each value (2.6e-16 on an H100): the same
# ~1000 sums of a 200-step rollout in another rounding (FMA contraction),
# each ~1e-16 relative, ~1e-13 at most, 1e-9 as the part's stated limit;
# against the unsharded loss on the card within PAR_TRAIN_REL (f32): the
# same operations in the same order, so any reordering costs a few ulps.
PAR_TRAIN = dict(batch=1024, steps=200, num_landmarks=64)
PAR_TRAIN_STEPS, PAR_TRAIN_CUT = 3, 64
PAR_TRAIN_REL, PAR_TRAIN_CUDA_CPU_REL = 1e-6, 1e-9
# (b) phase 12's fleet (B = 8192 banks x P = 1024, f32, 20 steps) and
# phase 17's FastSLAM (8192 particles x 32 landmarks, f64, 60 steps)
PAR_PF_BANKS, PAR_PF_P, PAR_PF_STEPS = 8192, 1024, 20
# (c) phase 16's 1000-pose chain, f64, SD_CONFIG, solve_sharded against
# solve(linear_solver="matfree_pcg") within SD_ATOL_F64
# (d) 256 scans x 1000 points, f32 (phase 17's ICP size), 20 ICP
# iterations (make_sharded_scan_odometry's default): a cloud uniform in
# [-5, 5]^2 seen from a drive of 0.05 m and 0.03 rad a scan; each pair's
# relative pose within PAR_SCAN_POSE_ATOL of the truth (noise-free scans:
# f32 rounding of coordinates ~5 leaves ~1e-6)
PAR_SCANS, PAR_SCAN_POINTS, PAR_SCAN_ITERS, PAR_SCAN_POSE_ATOL = 256, 1000, 20, 1e-4
# (e) 64 microbatches of 4096 through the pipeline
PAR_PIPE_W, PAR_PIPE_WIDTH = 64, 4096


def _collectives_reset():
    for k in pmesh.COLLECTIVES:
        pmesh.COLLECTIVES[k] = 0


def train_reference(params, controls, meas, ranges, landmarks, init_mean, dt=0.1, weight=0.01):
    """The unsharded loss and grads: Σ nll / B + w·Σ lm / B by autograd on
    the whole batch, no mesh."""
    b = init_mean.shape[0]
    leaves = [p.detach().requires_grad_(True) for p in params.tensors()]
    nll, xy = ttrain.ekf_innovation_nll(ttrain.SysIdParams(*leaves), controls, meas, init_mean, dt)
    nll_sum = torch.sum(nll)
    lm_sum = torch.sum(ttrain.landmark_range_sq_error(xy, landmarks, ranges))
    grads = torch.autograd.grad(nll_sum / b + weight * lm_sum / b, leaves)
    loss = nll_sum.detach() / b + weight * lm_sum.detach() / b
    return loss, ttrain.SysIdParams(*grads)


def par_train_part(card, device, mesh):
    f32, f64 = torch.float32, torch.float64
    out = {"shape": PAR_TRAIN, "dtype": "float32"}
    batch = ttrain.synthesize_batch(SEED, dtype=f32, device=device, **PAR_TRAIN)
    local = ttrain.shard_training_batch(mesh, *batch)
    init_fn, step_fn = ttrain.make_training_step(mesh)
    params, state = init_fn(f32)
    loss, grads = ttrain.make_loss_and_grad(mesh)(params, *local)
    want, want_grads = train_reference(params, *batch)
    errs = [_rel_err(loss, want)] + [_rel_err(g, w) for g, w in zip(grads.tensors(),
                                                                    want_grads.tensors())]
    losses, step_s = [], []
    for _ in range(PAR_TRAIN_STEPS):
        seconds, (params, state, step_loss) = timed(lambda: step_fn(params, state, *local))
        step_s.append(seconds)
        losses.append(float(step_loss))
    print(f"training step B={PAR_TRAIN['batch']} T={PAR_TRAIN['steps']} "
          f"L={PAR_TRAIN['num_landmarks']} f32 on {card}, (1, 1) NCCL mesh: losses {losses}; "
          f"host s a step {step_s}; loss and grads against the unsharded autograd, max rel "
          f"{max(errs)!r} (limit {PAR_TRAIN_REL})")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and max(errs) <= PAR_TRAIN_REL):
        fail(f"training step: losses {losses}, against the unsharded loss {errs}")
    out.update(losses=losses, step_s=step_s, rel_err_unsharded=max(errs))
    out["one_step"] = device_launches(f"one training step on {card}",
                                      lambda: step_fn(params, state, *local))

    # f64: cuda (sharded) against the CPU (unsharded) on the first trajectories
    controls, meas, ranges, landmarks, init_mean = ttrain.synthesize_batch(
        SEED, dtype=f64, device="cpu", **PAR_TRAIN)
    cut = (controls[:PAR_TRAIN_CUT], meas[:PAR_TRAIN_CUT], ranges[:PAR_TRAIN_CUT], landmarks,
           init_mean[:PAR_TRAIN_CUT])
    init_fn, step_fn = ttrain.make_training_step(mesh)
    p_gpu, s_gpu = init_fn(f64)
    p_cpu = ttrain.init_params(f64, device="cpu")
    s_cpu = ttrain.adam_init(p_cpu)
    local = ttrain.shard_training_batch(mesh, *(a.to(device) for a in cut))
    p_gpu, s_gpu, l_gpu = step_fn(p_gpu, s_gpu, *local)
    l_cpu, g_cpu = train_reference(p_cpu, *cut)
    p_cpu, s_cpu = ttrain.adam_update(p_cpu, g_cpu, s_cpu, 1e-2)
    rel = [_rel_err(l_gpu.cpu(), l_cpu)] + [_rel_err(a.cpu(), b) for a, b in
                                            zip(p_gpu.tensors(), p_cpu.tensors())]
    print(f"training step f64, B={PAR_TRAIN_CUT}: cuda (sharded) against the CPU (unsharded), "
          f"one Adam step, max rel {max(rel)!r} (limit {PAR_TRAIN_CUDA_CPU_REL})")
    if not max(rel) <= PAR_TRAIN_CUDA_CPU_REL:
        fail(f"training step f64: cuda differs from the CPU by {max(rel)!r}")
    out["f64_cuda_minus_cpu_rel"] = max(rel)
    return out


def par_filters_part(card, device, mesh):
    out = {}
    # PF banks: phase 12's fleet
    f32 = torch.float32
    gen = torch.Generator(device=device).manual_seed(SEED + 190)
    lm = torch.tensor(PF_LANDMARKS, dtype=f32, device=device)
    belief0 = init_particles(gen, torch.zeros(PAR_PF_BANKS, 4, device=device), PF_SPREAD, PAR_PF_P)
    u = torch.tensor(PF_U, dtype=f32, device=device).expand(PAR_PF_BANKS, 2)
    truth = torch.zeros(4, dtype=torch.float64)
    zs = []
    for k in range(PAR_PF_STEPS):
        truth = unicycle_propagate(truth, torch.tensor(PF_U, dtype=torch.float64), PF_DT)
        z = torch.linalg.norm(torch.tensor(PF_LANDMARKS, dtype=torch.float64) - truth[:2], dim=-1) \
            + 0.05 * torch.sin(torch.arange(4.0, dtype=torch.float64) + 0.3 * k)
        zs.append(z.to(device=device, dtype=f32).expand(PAR_PF_BANKS, -1))
    step = make_pf_banks_step(mesh, PF_DT, PF_CONTROL_NOISE, PF_RANGE_NOISE, axis_name="data")

    def run(sharded):
        g = torch.Generator(device=device).manual_seed(SEED + 191)
        b = belief0
        for z in zs:
            if sharded:
                b, est = step(b, u, z, lm, generator=g)
            else:
                b, est = pf_bank_step(b, u, z, lm, PF_DT, PF_CONTROL_NOISE, PF_RANGE_NOISE,
                                      generator=g)
        return b, est

    _collectives_reset()
    sharded_s, (b_s, e_s) = timed(lambda: run(True))
    plain_s, (b_p, e_p) = timed(lambda: run(False))
    same = all(bitwise_equal(a, b) for a, b in ((b_s.states, b_p.states),
                                                (b_s.weights, b_p.weights),
                                                (e_s.mean, e_p.mean), (e_s.cov, e_p.cov)))
    err = float(torch.linalg.norm(e_s.mean[:, :2].double() - truth[:2].to(device), dim=-1).median())
    print(f"PF banks B={PAR_PF_BANKS} P={PAR_PF_P} f32, {PAR_PF_STEPS} steps on {card}: sharded "
          f"{sharded_s!r} s, unsharded {plain_s!r} s; bitwise equal {same}; median position "
          f"error {err!r} (limit {PF_MEDIAN_ERROR_LIMIT})")
    if not (same and err <= PF_MEDIAN_ERROR_LIMIT):
        fail(f"PF banks: bitwise {same}, median error {err!r}")
    out["pf_banks"] = {"banks": PAR_PF_BANKS, "particles": PAR_PF_P, "steps": PAR_PF_STEPS,
                       "sharded_s": sharded_s, "unsharded_s": plain_s,
                       "median_position_error": err, "collectives": dict(pmesh.COLLECTIVES)}
    del b_s, b_p, belief0

    # one FastSLAM filter, the particle axis sharded: phase 17's
    f64 = torch.float64
    landmarks = frontend_landmarks()
    truth = frontend_drive(FAST_STEPS)
    obs, mask = frontend_observations(landmarks, truth, 1, SEED + 192)
    t = lambda a: torch.tensor(a, dtype=f64, device=device)  # noqa: E731
    obs_d, mask_d = t(obs[:, 0]), torch.tensor(mask[:, 0], device=device)
    u, chol, r = t(FE_CONTROL), t(FAST_CHOL), t(FAST_R)
    fs_step = make_fastslam_sharded_step(mesh, FE_DT, chol, r, axis_name="data")

    def run_fs(sharded):
        g = torch.Generator(device=device).manual_seed(SEED + 193)
        p = init_fastslam(FAST_P, FE_LANDMARKS, device=device)
        resampled = 0
        for k in range(FAST_STEPS):
            if sharded:
                p = fs_step(p, u, obs_d[k], mask_d[k], generator=g)
            else:
                p = fastslam_oracle_step(p, u, obs_d[k], mask_d[k], FE_DT, chol, r, generator=g)
            resampled += bool((p.weights == 1.0 / FAST_P).all())
        return p, resampled

    _collectives_reset()
    sharded_s, (p_s, resampled) = timed(lambda: run_fs(True))
    collectives = dict(pmesh.COLLECTIVES)
    plain_s, (p_p, _) = timed(lambda: run_fs(False))
    fields = ("poses", "weights", "lm_mean", "lm_cov", "lm_seen")
    same = {f: bitwise_equal(getattr(p_s, f), getattr(p_p, f)) if f != "lm_seen"
            else torch.equal(p_s.lm_seen, p_p.lm_seen) for f in fields}
    print(f"sharded FastSLAM {FAST_P} particles x {FE_LANDMARKS} landmarks f64, {FAST_STEPS} "
          f"steps on {card}: sharded {sharded_s!r} s, oracle {plain_s!r} s; bitwise equal "
          f"{same}; resampled on {resampled} steps; collectives {collectives}")
    if not (all(same.values()) and resampled >= 1):
        fail(f"sharded FastSLAM: bitwise {same}, resampled {resampled}")
    out["fastslam"] = {"particles": FAST_P, "landmarks": FE_LANDMARKS, "steps": FAST_STEPS,
                       "sharded_s": sharded_s, "oracle_s": plain_s, "resampled_steps": resampled,
                       "collectives": collectives}
    return out


def par_nlls_part(card, device, mesh):
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(SD_CHAIN)
    t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    prob = build_pose_graph_2d(t(initial), t(ef, torch.int64), t(et, torch.int64), t(meas),
                               t(info))
    cfg = SolverConfig(linear_solver="matfree_pcg", **SD_CONFIG)
    _collectives_reset()
    sharded_s, (solved, summary) = timed(lambda: solve_sharded(prob, cfg, mesh, ("model",)))
    collectives = dict(pmesh.COLLECTIVES)
    plain_s, (want, want_summary) = timed(lambda: nlls_solver.solve(prob, cfg))
    diff = float((solved.groups[0].values - want.groups[0].values).abs().max())
    print(f"solve_sharded {SD_CHAIN} chain f64 on {card}: {summary} in {sharded_s!r} s; solve "
          f"matfree_pcg {want_summary} in {plain_s!r} s; poses max|diff| {diff!r} (atol "
          f"{SD_ATOL_F64}); collectives {collectives}")
    if not (diff <= SD_ATOL_F64 and summary.termination == want_summary.termination):
        fail(f"solve_sharded against solve: {summary} vs {want_summary}, max|diff| {diff!r}")
    return {"poses": SD_CHAIN, "sharded_s": sharded_s, "solve_s": plain_s, "max_abs_diff": diff,
            "summary": vars(summary), "solve_summary": vars(want_summary),
            "collectives": collectives}


def scan_sequence(scans, points, device, seed=SEED + 194):
    """A cloud uniform in [-5, 5]^2 seen from the drive x = 0.05 t, y =
    0.02 sin(0.3 t), yaw = 0.03 t (tests/test_sharded_scan.py's motion):
    scans [T, M, 2] f32 and each pair's true relative pose [T - 1, 3]."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-5.0, 5.0, (points, 2))
    k = np.arange(scans, dtype=np.float64)
    pose = np.stack([0.05 * k, 0.02 * np.sin(0.3 * k), 0.03 * k], -1)
    rot_t = np.transpose(_rot2(pose[:, 2]), (0, 2, 1))  # R(-yaw)
    local = np.einsum("tij,tmj->tmi", rot_t, world[None] - pose[:, None, :2])
    rel_xy = np.einsum("tij,tj->ti", rot_t[:-1], pose[1:, :2] - pose[:-1, :2])
    rel = np.concatenate([rel_xy, np.diff(pose[:, 2])[:, None]], -1)
    return torch.tensor(local, dtype=torch.float32, device=device), rel


def par_scan_part(card, device, mesh):
    scans, rel_truth = scan_sequence(PAR_SCANS, PAR_SCAN_POINTS, device)
    run = make_sharded_scan_odometry(mesh, axis="data", iterations=PAR_SCAN_ITERS)
    _collectives_reset()
    sharded_s, (rel, absolute) = timed(lambda: run(shard_scans(mesh, scans, "data")))
    collectives = dict(pmesh.COLLECTIVES)
    serial_s, (rel_s, abs_s) = timed(lambda: scan_odometry_serial(scans, PAR_SCAN_ITERS))
    same = bitwise_equal(rel, rel_s) and bitwise_equal(absolute, abs_s)
    pose_err = float(np.abs(rel.cpu().double().numpy() - rel_truth).max())
    print(f"scan odometry {PAR_SCANS} scans x {PAR_SCAN_POINTS} points f32 on {card}: sharded "
          f"{sharded_s!r} s, serial {serial_s!r} s; bitwise equal {same}; pair poses max|err| "
          f"to the truth {pose_err!r} (atol {PAR_SCAN_POSE_ATOL}); collectives {collectives}")
    if not (same and pose_err <= PAR_SCAN_POSE_ATOL):
        fail(f"scan odometry: bitwise {same}, pose error {pose_err!r}")
    return {"scans": PAR_SCANS, "points": PAR_SCAN_POINTS, "sharded_s": sharded_s,
            "serial_s": serial_s, "pair_pose_max_err": pose_err, "collectives": collectives}


def par_pipeline_part(card, device, mesh):
    xs = torch.linspace(-2.0, 2.0, PAR_PIPE_W * PAR_PIPE_WIDTH, device=device).reshape(
        PAR_PIPE_W, PAR_PIPE_WIDTH)

    def stage(k, x):
        return torch.tanh(x * (k + 1.5)) + k

    _collectives_reset()
    seconds, ys = timed(lambda: pipeline_shard_map(stage, xs, mesh, "pipe"))
    collectives = dict(pmesh.COLLECTIVES)
    want = xs
    for k in range(pmesh.axis_size(mesh, "pipe")):
        want = stage(k, want)
    same = bitwise_equal(ys, want)
    print(f"pipeline_shard_map {PAR_PIPE_W} microbatches x {PAR_PIPE_WIDTH} f32 on {card}: "
          f"{seconds!r} s; equal to the stage composition {same}; collectives {collectives}")
    if not same:
        fail("pipeline_shard_map differs from the stage composition")
    return {"microbatches": PAR_PIPE_W, "width": PAR_PIPE_WIDTH, "seconds": seconds,
            "collectives": collectives}


def parallel_phase(card, device):
    """The distributed programs on one NCCL rank (phase 19)."""
    pmesh.init_process_group(0, 1, device_type="cuda")
    out = {"card": card, "backend": torch.distributed.get_backend()}
    try:
        meshes = {"train": pmesh.make_mesh(device_type="cuda"),
                  "data": pmesh.make_mesh(axis_names=("data",), device_type="cuda"),
                  "model": pmesh.make_mesh(axis_names=("model",), device_type="cuda"),
                  "pipe": pmesh.make_mesh(axis_names=("pipe",), device_type="cuda")}
        for name, part, mesh in (("train", par_train_part, "train"),
                                 ("filters", par_filters_part, "data"),
                                 ("solve_sharded", par_nlls_part, "model"),
                                 ("scan_odometry", par_scan_part, "data"),
                                 ("pipeline", par_pipeline_part, "pipe")):
            start = time.perf_counter()
            out[name] = part(card, device, meshes[mesh])
            out[name]["part_s"] = time.perf_counter() - start
            print(f"distributed programs, part {name}: {out[name]['part_s']!r} s")
    finally:
        torch.distributed.destroy_process_group()
    return out


_VIEW_OPS = {"empty", "empty_strided", "as_strided", "view", "_reshape_alias", "resize_",
             "detach", "lift_fresh", "alias", "_unsafe_view", "expand", "slice", "select", "t",
             "transpose", "permute", "unsqueeze", "squeeze", "item", "_local_scalar_dense",
             "set_", "unbind", "split", "result_type", "is_nonzero", "numpy_T", "diagonal",
             "narrow", "chunk", "reshape", "broadcast_to", "expand_as", "view_as",
             "_has_compatible_shallow_copy_type", "conj", "resolve_conj", "resolve_neg",
             "_to_copy"}


def cpu_op_count(fn):
    """The aten ops of fn() that would launch work, under the CPU profiler:
    leaf ops outside _VIEW_OPS (an upper bound on a device's launches)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.name[6:] not in _VIEW_OPS
               and not any(c.name.startswith("aten::") for c in e.cpu_children))


def _cpu_sequence(root, seconds):
    truth = write_vio_sequence(root, seconds=seconds)
    ds = EurocDataset.load(root)
    return truth, ds, ds.load_feature_tracks()


def vio_cpu_reference(seconds=VIO_SECONDS):
    """The port's own run on the CPU of phase 18's flight (its first
    `seconds`), which sets the phase's fused-RMSE and triangulation bounds:
    the batch pipeline in f64 and f32 (a solve that raises on a non-finite
    step is recorded), the windowed pipeline in f64, stage D's LM
    iterations in the first 12 windows in f64 and f32, triangulation in
    f64. Needs no card:
    `python3 -c 'import chip_smoke as cs; cs.vio_cpu_reference()'`."""
    import tempfile

    cpu = torch.device("cpu")
    out = {}
    with tempfile.TemporaryDirectory(prefix="vio_seq_") as root:
        truth, ds, tracks = _cpu_sequence(root, seconds)
        for dtype in (torch.float64, torch.float32):
            start = time.perf_counter()
            try:
                res = run_vio_pipeline(ds, tracks, device=cpu, dtype=dtype)
            except FloatingPointError as exc:  # the host LM's non-finite step
                out[f"batch {dtype}"] = {"raised": f"FloatingPointError: {exc}"}
            else:
                out[f"batch {dtype}"] = {
                    "seconds": time.perf_counter() - start,
                    "fused_rmse": vio_rmse(res.fused_poses, truth["positions"]),
                    "dead_reckoned_rmse": vio_rmse(vio.nav_to_se3(res.dead_reckoned),
                                                   truth["positions"]),
                    "summaries": {s: vars(res.summaries[s]) for s in ("ba", "imu", "fusion")}}
            print(f"CPU batch {dtype}: {out[f'batch {dtype}']}", flush=True)
        start = time.perf_counter()
        win = run_vio_pipeline_windowed(ds, tracks, window_frames=VIO_WINDOW_FRAMES,
                                        pipelined=False, device=cpu, dtype=torch.float64)
        out["windowed"] = {"seconds": time.perf_counter() - start,
                           "fused_rmse": vio_rmse(win.fused_poses, truth["positions"]),
                           "dead_reckoned_rmse": vio_rmse(win.dead_reckoned, truth["positions"])}
        print(f"CPU f64 windowed: {out['windowed']}", flush=True)
        for dtype in (torch.float64, torch.float32):
            stages, windows, nav, _ = make_stages(ds, tracks, VIO_WINDOW_FRAMES, device=cpu,
                                                  dtype=dtype)
            pose, iterations = None, []
            for w in windows[:12]:
                w = stages[0].fn(w)
                nav, w = stages[1].fn(nav, w)
                w = stages[2].fn(w)
                iterations.append(nlls_solver.solve_device(*vio_pp.fuse_problem(pose, w))[1]
                                  .iterations)
                pose, _ = stages[3].fn(pose, w)
            out[f"stage D iterations {dtype}"] = iterations
            print(f"CPU stage D LM iterations, first 12 windows, {dtype}: {iterations}",
                  flush=True)
        xyz = vfe.triangulate_tracks(torch.as_tensor(truth["cams"]), torch.as_tensor(
            truth["pixels"]), torch.as_tensor(truth["seen"]), VIO_INTRINSICS).numpy()
        views = truth["seen"].sum(1)
        errs = np.linalg.norm(xyz - truth["landmarks"], axis=-1)[views >= 3]
        out["triangulation"] = {"median_m": float(np.median(errs)),
                                "p95_m": float(np.percentile(errs, 95))}
        print(f"CPU f64 triangulation: {out['triangulation']}", flush=True)
    return out


def scatter_determinism(repeats=5):
    """ROADMAP C8's op on the CPU (no card): `repeats` CPU
    `index_put_(accumulate=True)` scatters of the same 200k values into
    2000 slots, and as many `nlls.solver.scatter_add_`; the distinct
    results of each (1: the same bits every time)."""
    gen = torch.Generator().manual_seed(8)
    idx = torch.randint(0, 2000, (200_000,), generator=gen)
    vals = torch.randn(200_000, generator=gen)
    distinct = {
        "index_put_": len({torch.zeros(2000).index_put_((idx,), vals, accumulate=True)
                           .numpy().tobytes() for _ in range(repeats)}),
        "scatter_add_": len({nlls_solver.scatter_add_(torch.zeros(2000), (idx,), vals)
                             .numpy().tobytes() for _ in range(repeats)})}
    print(f"{repeats} repeats on {torch.get_num_threads()} threads, distinct results: {distinct}")
    return distinct


def vio_cpu_repeats(runs=4, seconds=3.0):
    """ROADMAP C8's symptom on the CPU (no card): `runs` f32 runs of the
    batch VIO pipeline on phase 18's flight cut to `seconds`, each with its
    BA summary and a hash of its fused poses, or the error it raised (one
    hash: the same bits every run).
    `python3 -c 'import chip_smoke as cs; cs.vio_cpu_repeats()'`."""
    import hashlib
    import tempfile

    out = []
    with tempfile.TemporaryDirectory(prefix="vio_seq_") as root:
        _, ds, tracks = _cpu_sequence(root, seconds)
        for _ in range(runs):
            try:
                res = run_vio_pipeline(ds, tracks, device=torch.device("cpu"),
                                       dtype=torch.float32)
            except FloatingPointError as exc:
                run = {"raised": f"FloatingPointError: {exc}"}
            else:
                run = {"ba": vars(res.summaries["ba"]), "fused_poses_md5": hashlib.md5(
                    res.fused_poses.numpy().tobytes()).hexdigest()}
            print(f"CPU f32 batch VIO, {seconds} s, {torch.get_num_threads()} threads: {run}",
                  flush=True)
            out.append(run)
    return out


def tf32_guard_mutation_check():
    """Phase 16's TF32 part (`tf32_solver_part`) on a copy of this checkout
    whose solvers lack their `full_fp32_matmul` guards (the decorators of
    `nlls/implicit.py` and `nlls/solver.py` taken out): the check must fail
    there, or it holds nothing. Needs a card:
    `python3 -c 'import chip_smoke as cs; cs.tf32_guard_mutation_check()'`.
    Returns (the copy's exit code, its TF32 line)."""
    import pathlib
    import shutil
    import tempfile

    here = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="tf32_mutant_") as tmp:
        copy = pathlib.Path(tmp) / "checkout"
        shutil.copytree(here, copy, ignore=shutil.ignore_patterns(".git", "_build", "__pycache__"))
        for name in ("implicit.py", "solver.py"):
            path = copy / "rust_robotics_tpu_torch" / "nlls" / name
            path.write_text(re.sub(r"^\s*@full_fp32_matmul\(\)\n", "", path.read_text(),
                                   flags=re.M))
        code = ("import torch, chip_smoke as cs; torch.backends.cuda.matmul.allow_tf32 = False; "
                "cs.tf32_solver_part(torch.cuda.get_device_name(0), torch.device('cuda', 0))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True,
                              text=True, timeout=600)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TF32 allowed")), "")
    print(f"TF32 check without the guards: exit {proc.returncode} (must fail); {line}")
    return proc.returncode, line


def vio_cpu_op_counts():
    """Phase 18's prediction: the CPU profiler's op counts (f32, the whole
    flight) of one BA iteration, one IMU-LM iteration, the batched
    preintegration, one window, the front end on FRONT_PAIRS small pairs
    (the count does not depend on the image size) and one batch pipeline.
    `python3 -c 'import chip_smoke as cs; cs.vio_cpu_op_counts()'`."""
    import tempfile

    cpu, f32 = torch.device("cpu"), torch.float32
    with tempfile.TemporaryDirectory(prefix="vio_seq_") as root:
        _, ds, tracks = _cpu_sequence(root, VIO_SECONDS)
        res = run_vio_pipeline(ds, tracks, device=cpu, dtype=f32)
        t_bs = torch.as_tensor(ds.cam.t_bs).to(f32)
        prob = build_bundle_adjustment(
            vio.nav_to_se3(res.dead_reckoned) @ t_bs, torch.as_tensor(tracks.landmarks).to(f32),
            torch.as_tensor(np.searchsorted(ds.cam.timestamps, tracks.obs_timestamps)),
            torch.as_tensor(tracks.obs_landmark_ids), torch.as_tensor(tracks.obs_pixels).to(f32),
            CameraIntrinsics(*[float(v) for v in ds.cam.intrinsics]), fixed_cameras=2,
            robust=RobustKernel("huber", 2.0))
        _, bias0 = vio.initial_state(ds, cpu, f32)
        lanes = [torch.as_tensor(x).to(f32) for x in vio.interval_lanes(ds, ds.cam.timestamps)]
        pres = preintegrate(*lanes, bias0, VIO_ACCEL_SIGMA, VIO_GYRO_SIGMA)
        k = len(ds.cam.timestamps)
        kw = vio.imu_refine_kwargs(res.dead_reckoned, bias0, res.ba_cameras @ se3_inverse(t_bs),
                                   ds.cam.timestamps)
        stages, windows, _, _ = make_stages(ds, tracks, VIO_WINDOW_FRAMES, device=cpu)
        imgs = torch.rand(2, FRONT_PAIRS, 96, 128, generator=torch.Generator().manual_seed(SEED))
        counts = {
            "ba_iteration": cpu_op_count(lambda: nlls_solver.solve(
                prob, SolverConfig(linear_solver="schur", max_iterations=1))),
            "imu_iteration": cpu_op_count(lambda: optimize_imu_trajectory(
                res.dead_reckoned, bias0.expand(k, 6).clone(), pres,
                config=SolverConfig(max_iterations=1), **kw)),
            "preintegrate": cpu_op_count(lambda: preintegrate(*lanes, bias0, VIO_ACCEL_SIGMA,
                                                              VIO_GYRO_SIGMA)),
            "one_window_f32": cpu_op_count(lambda: run_sequential(stages, windows[:1])),
            "front_end": cpu_op_count(lambda: track_pairs(imgs[0], imgs[1])),
            "batch_pipeline_f32": cpu_op_count(lambda: run_vio_pipeline(ds, tracks, device=cpu,
                                                                        dtype=f32)),
        }
    print(f"CPU profiler op counts (f32): {counts}")
    return counts


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
    # B3 at bench.py's pinned shape: the kernel's own device time, beside
    # time_interleaved_ms's events around the wrapper (host time included)
    pb, pp = RESAMPLE_SHAPES["pinned"]
    pinned_args = resample_inputs(np.random.default_rng(SEED + 2), pb, pp, RESAMPLE_D,
                                  torch.float32, device)
    b3_pinned_profiler = kernel_device_ms(lambda: systematic_resample_gather(*pinned_args),
                                          "resample_kernel")
    print(f"resample pinned B={pb} P={pp} D={RESAMPLE_D} f32 on {card}: the kernel's own device "
          f"time (profiler) min {b3_pinned_profiler['min_ms']!r} ms, mean "
          f"{b3_pinned_profiler['mean_ms']!r} ms over {b3_pinned_profiler['launches']} launches; "
          f"CUDA events around the wrapper {b3_times['pinned']['ms']!r} ms; bound "
          f"{b3_times['pinned']['bound_ms']!r} ms")
    del pinned_args
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

    # 16. the SLAM back end: SE(3), implicit gradients, solve_device, ICP
    # (no kernel on their path)
    print(json.dumps({"slam_backend": slam_backend_phase(card, device)}))

    # 17. the SLAM front end and the remaining filters: EKF-SLAM, FastSLAM,
    # the smoother, SR-UKF / adaptive / histogram, scan matching, the SLAM
    # node (no kernel on their path)
    print(json.dumps({"slam_frontend": slam_frontend_phase(card, device)}))

    # 18. the VIO path: batch VIO (B4 on its BA), windowed VIO, the front
    # end, no read in a step, the f32 convolutions under cuDNN's TF32 flag
    vio_out = vio_phase(card, device, counted)
    print(json.dumps({"vio": vio_out}))

    # 19. the distributed programs on one NCCL rank (no kernel on their path)
    print(json.dumps({"parallel": parallel_phase(card, device)}))

    # 20. the kernels line
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
        **({"pinned": {"shape": {"B": RESAMPLE_SHAPES["pinned"][0], "P": 1024},
                       "events_ms": b3_times["pinned"]["ms"],
                       "profiler_kernel_ms": b3_pinned_profiler,
                       "bound_ms": b3_times["pinned"]["bound_ms"]}} if rp == 1024 else {}),
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
        **({"launches_vio": vio_out["batch"]["f32_cold"]["launches"]["cholesky_blocked"],
            "path_vio": f"run_vio_pipeline f32, {vio_out['sequence']['keyframes']} keyframes: "
                        f"the BA's {vio_out['batch']['f32_cold']['iterations']['ba']} linear "
                        f"solves",
            "vio_systems": vio_out["batch"]["f32_cold"]["b4_on_path"]}
           if name == "cholesky_blocked" else {}),
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

    # 21. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
