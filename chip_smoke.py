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
    particle, and the P=1280 ValueError; then each branch of its launch
    plan (rows not 16-byte aligned at P=1001 f32, P=1000 f64, f64 rows
    too large for a block at D=8 P=4096, CDFs flat across runs of
    zero-weight particles, B=1) and ptxas's registers, shared memory and
    spills of its six instances (a spill fails);
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
    bench.py's pinned shape (B=256, P=1024) from the profiler, with its
    inputs warm in L2 and cold (a 64 MB buffer zeroed between calls), beside
    the CUDA events around its wrapper; ptxas's registers and spills of B2's
    bodies (the register body must not spill);
15. bench.py's four pose-graph workloads (bench.py:113-117; no kernel on
    their path), f32 on cuda, LM at most 25 iterations, tolerance 1e-8: the
    10k chain through `chain_direct` (RMSE < 5e-3, one warm time,
    iterations, its first 3 LM steps in f64 on cuda and on the CPU within
    PG_F64_ATOL, one LM step under sync debug mode "error", the device
    reads of a whole solve counted under "warn", one step's profile and
    launches); the 100k chain (the auto rule's nested solve, by counter;
    RMSE < 5e-3); 256 distinct 200-pose graphs in lock-step (worst RMSE,
    graphs/s, three lanes equal to their solo solves); the 100x100 grid
    with 50 closures through `banded_direct` (the plan, 5 LM iterations
    once, RMSE < 2.2e-3, one step's profile) and `direct`'s routes on the
    grid and a 2000-pose chain, by counter (2 LM iterations); then one JSON line
    `{"pose_graph": {...}}`;
16. the SLAM back end (no kernel on its path): (a) the anchored 10k SE(3)
    chain in f32 (RMSE < 1e-4, gradient_converged, one warm time, the
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
    solve, counted) and f64, once each (cold), seconds per stage, LM
    iterations, fused and dead-reckoned RMSE against truth (fused <= dead
    and under twice the port's f64 CPU run), B4 held against its twin and
    the f64 factor on the first and the last retained system (n = 1206)
    that the f32 BA gave it, one BA and one IMU-LM iteration profiled, and
    cuda = CPU in f64 on 40 keyframes; (c) `run_vio_pipeline_windowed` (the
    flight's first 34 of 67 windows of 3, f64) pipelined, RMSE gated alike,
    and the sequential order on its first 4 windows bitwise equal to the
    pipelined run's; (d) `detect_corners` +
    `track_with_fb_check` on 64 pairs of 752x480 f32 images shifted by known
    sub-pixel flows (median flow error <= 0.25 px), 4 pairs against the
    CPU, `triangulate_tracks` of the 2000 landmarks over 201 views; (e) one
    batched preintegration, one `lk_track` and one stage-D fusion step
    under sync debug mode "error", and the CUDA graph of stage D's LM step
    (`solve_device`'s replay) bitwise the eager step on two windows, one
    capture for both; the f32 histogram update and
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
20. the SPIKE programs (no kernel on their path) on a one-rank NCCL mesh, at
    the dryrun's full width, each part timed and its collectives counted by
    kind: (a) program 6, the SPIKE-partitioned chain LM on the 10k chain
    with its closures in f32 (the dryrun's LM settings and gates: RMSE
    against the oracle's, poses within 2e-3 of `solve_chain_lm`; warm s
    against `solve_chain_lm`'s; one LM step under sync debug mode "error"
    and its launches and idle share), and the f64 1000-pose chain within
    1e-8 of `solve_chain_lm`; (b) program 7, `solve_general_graph_sharded`
    on the dryrun's 9x8 grid in f64 (within 1e-9 of `solve_general_graph`)
    and on the 100x100 grid in f32, both solves cut to 2 LM iterations
    (within 5e-4; s an iteration each); (c) program 8, the sharded IFT of
    (a)'s solution re-solved in f64 against `chain_implicit_vjp` (loss rel
    1e-12, gradients 1e-7 of max|g|), the f32 call timed; then one JSON
    line `{"parallel_spike": {...}}`;
21. the navigation stack (no kernel on its path), each part run under sync
    debug mode "warn" (its device reads), on the host clock and under the
    profiler (launches, idle share), with the six kernel entries' counts
    reset before it and required to stay 0: (a) a DWA fleet of 1024 robots
    x 451 samples x 32 states x 64 obstacles in f32 for 10 steps
    (robot-steps/s, one step's device time, no read in a step), 8 lanes
    bitwise their solo runs, a 16-robot f64 fleet within 1e-9 of the CPU,
    the two headless demos (navigation loop, mission recovery) in f64
    equal to the CPU's and in f32 (s and reads a step); (b) mapping:
    `lidar_to_grid` of a 1081-beam 270° scan at 256 samples into
    1000 x 1000 cells (two calls bitwise; f64 cuda = CPU), `compute_sdf`
    at 1024² f32 (bitwise the CPU's at 256²; the f64 UDF = scipy's EDT),
    NDT of 10^6 points into 500² cells scored on 10^5, k-means 262,144 x 32,
    DBSCAN 8192, normals 8192, FPS 10^5 -> 1024, a GP of 2048 x 65,536
    and split-and-merge on 1081 points, each held to the CPU in f64 at a
    reduced size; (c) grid search in f64: JPS on 512² (= `wavefront_costs`
    within 1e-9), `repair_costs` after a 5 x 5 edit on 64 maps of 256²,
    ARA*, IDA* and the beam on 128², the 26-connected 3-D wavefront and
    path on 64³, `shortcut_path` on a 128-vertex path, each held to the
    CPU within 1e-12 with equal counts at a reduced size; then one JSON
    line `{"navigation": {...}}`;
22. planning II (B2 on the fields, coverage and frontier parts), each part
    run under sync debug mode "warn", on the host clock and (where its
    launches are few) under the profiler, a launch-heavy loop profiled on
    one short call, the kernel entries counted: B2's `wavefront_relax`
    exactly once per counted `wavefront_costs` call in (c), (d) and (f),
    every other entry 0 times, and B2 0 times elsewhere: (a) the A*
    variants on the reference's 50x50 maze in every mode and the MovingAI
    parser on a generated 512² octile map and 1000 scenarios (host); (b)
    `VisibilityPlanner` on a 256² room map with 64 queries and the Theta*
    wavefront on 128², f32; (c) `flow_field` on bench.py's 64 maps of
    128² (bitwise the CPU's in f32, and on 8 maps in f64) and
    `potential_field` on 1024²; (d) `frontier_navigate` on a 128² world
    with walls and gaps (it must reach the goal); (e) terrain risk from a
    1024² elevation and `sweep_risk_weights` over 16 weights on 256²; (f)
    `wavefront_cpp` on 128², Spiral-STC and the spiral on 64²; (g) PRM with
    1000 samples among 64 obstacles and the Voronoi road map on 512²; (h)
    `time_expanded_costs` on T=256 x 256², and prioritized MAPF, CP-SIPP
    and STL-CBS with 8 agents on 64², T=128; each held to the CPU in f64 at
    a reduced size (fields within 1e-12, paths and counts exactly, B2's
    fields bitwise in f32 and f64); then one JSON line
    `{"planning_ii": {...}}`;
23. the control layer, f32 at users' widths, each part run once under sync
    debug mode "warn" on the host clock and a short call of it under the
    profiler, the kernel entries counted: B2's `wavefront_relax` once per
    counted `wavefront_costs` call (the value-guided MPPI's grid), every
    other entry never: (a) pure pursuit, Stanley, rear-wheel feedback (1024
    vehicles x 200 steps) and LQR steer (x 100 steps, a DARE per vehicle) on
    bench_meta_control's 401-point path, the three nonlinear laws over 1024
    lanes, the CBF filter (1024 robots x 75 steps), ADMM formation,
    consensus and horizon consensus; (b) `mpc_control` for 1024 vehicles,
    iLQR and DDP on 256 pendulums (8 iterations), `lqr_regulator`, C/GMRES
    (5 of its test's 1200 steps, f64), `plan_landing` (f64); (c)
    `rrt_star_arm_plan` (7 joints, 192 nodes), 3-D IK on 1024 targets; (d)
    bench_mppi's loop, one plan of 1024 robots x 1024 samples x H 30 among
    16 obstacles,
    bench_mppi_value (B2) value-guided against vanilla, person following
    and racing, `simulate_gate_race` at its defaults, `simulate_push` as
    bench_pusher_slider and the two-contact couple; each part's gate (the
    JAX test's of the same function), lanes bitwise their solo runs in f32,
    f64 cuda = CPU at a reduced size (1e-9, discrete outputs exactly);
    (e) the solver paths bitwise with TF32 allowed; then one JSON line
    `{"control": {...}}`;
24. the kinematic planners, f32 at the widths of the JAX package's benches
    and tests, each part once under sync debug mode "warn" on the host
    clock and a short call of it under the profiler, no kernel entry
    launching: (a) bench_frenet's cycle, `calc_spline_course` on its 5
    waypoints, Dubins and Reeds-Shepp on 1024 pose pairs, η³ path and
    trajectory samples; (b) bench_rrt_star's seed-0 runs (RRT and RRT*, 300
    nodes; phase 27 runs all four) and a forest of 1024 RRT* trees of 300 nodes
    (lanes bitwise their solo runs); (c) informed RRT*, RRT-connect,
    bidirectional RRT (300 nodes), FMT* and RRG at 256 samples, BIT* (4 x
    96), the Sobol RRT, `shortcut_path`; (d) the Dubins RRT/RRT* and the
    Reeds-Shepp RRT* on 16 trees of 64 of the tests' 96 nodes,
    closed-loop RRT* (300 of 600 steps), LQR-RRT* at 200 nodes; (e) the
    elastic band, DMP, PSO with 64 particles, `lqr_plan`, Bug2 and tangent
    Bug (host); (f) `hybrid_astar_costs` on 128² x 16 headings, the
    lattice lookup table, the clothoid, CHOMP, bipedal; each part's gate the
    JAX test's of the
    same function, f64 cuda = CPU at a reduced size (1e-9, discrete
    outputs exactly); (g) the solver paths bitwise with TF32 allowed; then
    one JSON line `{"kinematic_planning": {...}}`;
25. the rigid-body and BranchOut planners, the aerial, meta and arena
    controllers, the compaction serving runner, the experiment suites,
    utils/ and viz/, f32 at users' widths unless said, each part once under
    sync debug mode "warn" on the host clock and under the profiler (a
    short call, named, where the part makes ~70k launches or more), no
    kernel entry launching: (a) the meta controller (pure pursuit, the LQR
    speed-steer fallback) on 1024 vehicles x 200 steps on
    bench_meta_control's path, `run_controller_arena()` at 300 of its 600
    steps (phase 27 runs its bench's 500),
    the quintic flight and the minimum-snap solve (f64) on the JAX tests'
    waypoints; (b) the rigid-body lattice and RRT (600 nodes) at
    `RigidBodyConfig()` on the JAX test's scene, BranchOut's plans,
    metrics and 40-step closed loops on its three scenes; (c) bench.py's
    serving row: `run_batched_compaction_benchmark()` (256 x 200, rounds of
    6, at most 8, tolerance 1e-6) beside the lock-step
    `run_batched_benchmark` at the same shape; (d) the experiment suites
    at their defaults but for depth (UKF/CKF 10 families x 32 x 60 of 120
    steps, path tracking 3 x 3 x 3 x 500, drone 3 seeds, point-cloud
    sampling's six problems; the UKF/CKF suite in f64); (e) the
    roofline of the run's EKF and resampling rates, one trace, a
    checkpoint round trip on cuda, `assert_deterministic` on two planners,
    frames drawn; each part's gate the JAX test's of the same function,
    lanes bitwise their solo runs, f64 cuda = CPU at a reduced size (1e-9,
    discrete outputs exactly); then one JSON line `{"breadth": {...}}`;
26. the headless demo family, the playground, dataflow, the speed
    comparison and the embedded demo, each part once under sync debug
    mode "warn" on the host clock (the longest a short call under the
    profiler), B2 once per `wavefront_costs` call on the card and no other
    kernel entry launching: (a) the 23 headless demos in f64 at their
    sizes, each through tests/test_headless_family.py's gate, the FAST
    twelve f64 cuda = CPU (1e-9, discrete outputs exactly), the ten with
    steps cuda = CPU over 3 steps on shared draws; (b) the playground's five
    tabs into a temporary directory, the grid tab equal to
    docs/playground/data.json's, the arena's speed lanes bitwise their solo
    rollouts; (c) dataflow's 5 planner ticks (cuda = CPU) and 50 EKF ticks;
    (d) `run_speed_comparison()` at its defaults (20 runs, batch 32), its
    rows printed with the card; (e) the embedded demo's PASS line; then one
    JSON line `{"family": {...}}`;
27. the tools, each part once under sync debug mode "warn" on the host
    clock (a short call of the longest under the profiler), B2 once per
    `wavefront_costs` call and no other kernel entry launching: (a) the
    pinned registry in f64, the benches outside tests/test_bench_gate.py's
    SLOW set first, then the SLOW ones while SL_BENCH_BUDGET_S lasts:
    every deterministic bench's CSV equal to docs/assets/ through
    `compare_csv` (1e-6), every drawing bench on its own draws equal to
    its CPU run (run in two other processes meanwhile; 1e-9, integers and
    words exactly, the rounding-bound three 1e-2); (b) the 25 renders into
    a temporary directory, GIFs through the native writer, each file passing
    tests/test_render_family.py's check (the EuRoC one skips without the
    reference's fixture); (c) `build_gallery` on two renders; (d) the
    native parsers against the pure-Python ones and the native GIF stream
    against PIL's decoding; (e) `run_scaling_report((1,))` and
    `run_chain_weak_scaling((1,))` on one NCCL rank, printed with the card;
    then one JSON line `{"tools": {...}}`;
28. the SPIKE-chunked chain (no kernel on its path), each part once under
    sync debug mode "warn" on the host clock: (a) bench.py's chain at
    300,000 poses (2,999 closures) in f32 through
    `optimize_pose_graph_2d(chain_direct)`, where the auto rule takes 4
    chunks of 75,000 rows, to its end (RMSE < 5e-3; the Woodbury edge chunks
    and reads an iteration; one step profiled); (b) the same chain in f64,
    2 LM steps on the chunked ladder and on the plain one (equal counts,
    poses within 1e-5; each route's warm s a step); (c) `solve_chain_lm
    (chunks=8)` on the 500-pose chain, 25 iterations, f64 cuda against the
    CPU (1e-9); (d) phase 16's anchored 10k SE(3) chain with chunks=4 (RMSE
    < 1e-4, within 2e-4 of the unchunked run); (e) the chain LM's CUDA graph
    bitwise its eager step on the plain, nested, chunked, LU and lock-step
    routes; then one JSON line `{"spike_chunked": {...}}`;
29. one JSON line `{"kernels": [...]}`;
30. the last line, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from scipy import ndimage
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
from rust_robotics_tpu_torch.demos import dataflow as dflow
from rust_robotics_tpu_torch.demos import embedded_demo as embedded
from rust_robotics_tpu_torch.demos import headless_family as hfam
from rust_robotics_tpu_torch.demos import playground as pground
from rust_robotics_tpu_torch.demos import pose_graph_bench
from rust_robotics_tpu_torch.demos import speed_comparison as speed
from rust_robotics_tpu_torch.demos import benchmarks as bmk
from rust_robotics_tpu_torch.demos import gallery
from rust_robotics_tpu_torch.demos import render as rnd
from rust_robotics_tpu_torch.demos import scaling_report as scaling
from rust_robotics_tpu_torch.planning import wavefront as pwavefront
from rust_robotics_tpu_torch.nlls import banded, tridiag
from rust_robotics_tpu_torch.planning.grid import grid_from_raster
from rust_robotics_tpu_torch.planning.wavefront import (
    SQRT2,
    _incoming_masks,
    _motions,
    extract_path,
    goal_raster,
    plan_grid,
    wavefront_costs,
)
from rust_robotics_tpu_torch.slam.bundle_adjustment import (
    CameraIntrinsics,
    build_bundle_adjustment,
    bundle_adjust,
)
from rust_robotics_tpu_torch.core import lie_np
from rust_robotics_tpu_torch.nlls.implicit import chain_implicit_vjp, pose_graph_implicit_vjp
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
from rust_robotics_tpu_torch.core.types import GridSpec2D
from rust_robotics_tpu_torch.demos.headless import (
    headless_mission_recovery,
    headless_navigation_loop,
)
from rust_robotics_tpu_torch.mapping.cluster import (
    dbscan,
    estimate_normals,
    farthest_point_sample,
    kmeans,
)
from rust_robotics_tpu_torch.mapping.distance import compute_sdf, compute_udf
from rust_robotics_tpu_torch.mapping.gp import gp_regression
from rust_robotics_tpu_torch.mapping.lines import split_and_merge
from rust_robotics_tpu_torch.mapping.ndt import ndt_grid, ndt_score
from rust_robotics_tpu_torch.mapping.occupancy import lidar_to_grid
from rust_robotics_tpu_torch.planning.dwa import DWAConfig, dwa_step
from rust_robotics_tpu_torch.planning.grid3d import plan_grid_3d
from rust_robotics_tpu_torch.planning.incremental import (
    ara_star_plan,
    beam_search_costs,
    ida_star_costs,
    octile_heuristic,
    relax_with_stats,
    repair_costs,
)
from rust_robotics_tpu_torch.planning.jps import jps_plan
from rust_robotics_tpu_torch.data import moving_ai as pmai
from rust_robotics_tpu_torch.planning import a_star_variants as pav
from rust_robotics_tpu_torch.planning import any_angle as pany
from rust_robotics_tpu_torch.planning import conformal as pconformal
from rust_robotics_tpu_torch.planning import coverage as pcoverage
from rust_robotics_tpu_torch.planning import fields as pfields
from rust_robotics_tpu_torch.planning import frontier as pfrontier
from rust_robotics_tpu_torch.planning import risk_graph as prisk
from rust_robotics_tpu_torch.planning import roadmap as proad
from rust_robotics_tpu_torch.planning import stl as pstl
from rust_robotics_tpu_torch.planning import temporal as ptemporal
from rust_robotics_tpu_torch.planning.smoothing import shortcut_path
from rust_robotics_tpu_torch.planning import bipedal as pbipedal
from rust_robotics_tpu_torch.planning import branchout as pbo
from rust_robotics_tpu_torch.planning import rigid_body as prb
from rust_robotics_tpu_torch.experiments import drone_quality as edq
from rust_robotics_tpu_torch.experiments import path_tracking as ept
from rust_robotics_tpu_torch.experiments import point_cloud_sampling as epcs
from rust_robotics_tpu_torch.experiments import ukf_ckf_accuracy as eukf
from rust_robotics_tpu_torch.utils import bench_gate as ugate
from rust_robotics_tpu_torch.utils import checkpoint as ckpt
from rust_robotics_tpu_torch.utils import profiling as uprof
from rust_robotics_tpu_torch.utils import roofline as uroof
from rust_robotics_tpu_torch.utils.roofline import (
    EKF_OPS_PER_STEP,
    RESAMPLE_OPS_PER_PARTICLE,
    WAVEFRONT_OPS_PER_DIRECTION,
    WAVEFRONT_OPS_PER_KIND,
    card_peaks,
)
from rust_robotics_tpu_torch.viz import raster as vraster
from rust_robotics_tpu_torch.planning import chomp as pchomp
from rust_robotics_tpu_torch.planning import curves as pcurves
from rust_robotics_tpu_torch.planning import eta3 as peta3
from rust_robotics_tpu_torch.planning import frenet as pfrenet
from rust_robotics_tpu_torch.planning import hybrid_astar as phybrid
from rust_robotics_tpu_torch.planning import lattice as plattice
from rust_robotics_tpu_torch.planning import reactive as preactive
from rust_robotics_tpu_torch.planning import reeds_shepp as preeds
from rust_robotics_tpu_torch.planning import rrt as prrt
from rust_robotics_tpu_torch.planning import rrt_kinematic as pkin
from rust_robotics_tpu_torch.planning import rrt_variants as pvar
from rust_robotics_tpu_torch.control import admm as cadmm
from rust_robotics_tpu_torch.control import aerial as caerial
from rust_robotics_tpu_torch.control import arena as carena
from rust_robotics_tpu_torch.control import meta as cmeta
from rust_robotics_tpu_torch.control import arm as carm
from rust_robotics_tpu_torch.control import cbf
from rust_robotics_tpu_torch.control import cgmres as ccg
from rust_robotics_tpu_torch.control import mpc as cmpc
from rust_robotics_tpu_torch.control import mppi as cmppi
from rust_robotics_tpu_torch.control import mppi_value as cvalue
from rust_robotics_tpu_torch.control import mppi_variants as cvar
from rust_robotics_tpu_torch.control import nonlinear as cnl
from rust_robotics_tpu_torch.control import pusher_slider as cpush
from rust_robotics_tpu_torch.control import racing as crace
from rust_robotics_tpu_torch.control import rocket as crocket
from rust_robotics_tpu_torch.control import trackers as ctrack
from rust_robotics_tpu_torch.control import trajopt as ctraj
from rust_robotics_tpu_torch.control._small import masked_fixpoint
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
from rust_robotics_tpu_torch.parallel.sharded_banded import solve_general_graph_sharded
from rust_robotics_tpu_torch.parallel.sharded_tridiag import (
    _DENSE_INTERFACE_MAX,
    make_sharded_chain_ift,
    make_sharded_chain_solver,
    sharded_chain_lm_start,
)
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
    _auto_chunks,
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

# The card's data-sheet peaks (`CARDS`, `card_peaks`) and the kernels'
# least work counts (EKF_OPS_PER_STEP, WAVEFRONT_OPS_*,
# RESAMPLE_OPS_PER_PARTICLE) are utils/roofline.py's.

# bench.py:154-159: B=64 maps of 128x128, 20 % blocked, goal at the far corner
GRID_B, GRID_W, GRID_H = 64, 128, 128
GRID_K = 16  # sweeps per launch of wavefront_costs_fused (wavefront_pallas.py:95)

# bench.py:182-221: resampling at D=4, pinned (B=256), saturated (B=8192)
# and tiled (B=2048, P=4096)
RESAMPLE_SHAPES = {"pinned": (256, 1024), "saturated": (8192, 1024), "tiled": (2048, 4096)}
RESAMPLE_D = 4
RESAMPLE_IDX_OFF_LIMIT = 1e-3  # share of draws whose index may differ (f32)
# how far from its position a CDF boundary that a differing index crosses
# may lie: the two f32 prefix sums of up to 4096 terms differ by their
# summation order, a few units of 2^-24 times sqrt(P)
RESAMPLE_CDF_ATOL = 1e-5
# B3's branches (ops/resample.py::_launch_plan) beyond the shapes above:
# (branch, B, P, D, dtype, f64 indices exact, zero-weight runs). Rows that
# are not 16-byte aligned (cp.async staging); P=1000 in f64, indices exact
# (the twin divides by P through `_numeric.true_div`, as the kernel does);
# f64 rows too large for a block (states gathered
# from global memory); CDFs flat across runs of zero-weight particles, which
# the walking search crosses; one row.
RESAMPLE_BRANCHES = (
    ("copied", 512, 1001, RESAMPLE_D, torch.float32, False, False),
    ("staged", 512, 1000, RESAMPLE_D, torch.float64, True, False),
    ("direct", 128, 4096, 8, torch.float64, True, False),
    ("staged", 2048, 1024, RESAMPLE_D, torch.float32, False, True),
    ("staged", 512, 1024, RESAMPLE_D, torch.float64, True, True),
    ("staged", 1, 1024, RESAMPLE_D, torch.float32, False, False),
)
RESAMPLE_ZERO_RUNS = (4, 16, 300)  # zero-weight runs a row; their least and largest length
RESAMPLE_FLUSH_BYTES = 64 << 20  # zeroed between cold calls: more than the 50 MB L2

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
# The check runs PG_F64_ITERATIONS of the solve's 11 steps (the CPU solve,
# ~10 s, was cut to make room for phase 28; PERF.md §4).
PG_F64_ATOL, PG_F64_ITERATIONS = 1e-6, 3
# the grid's timed solve: PG_GRID_ITERATIONS LM iterations, once (cold). Its
# warm-up solve and 20 of its 25 iterations (~39 s) were cut to make room for
# phase 28 (PERF.md §4); phase 20 reaches RMSE 1.7e-4 in 3.
PG_GRID_ITERATIONS = 5
PG_ROUTE_ITERATIONS = 2  # LM iterations of `direct`'s route check (its counters are the gate)
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
# poses within 1e-7 as there. The f32 times are taken on the dense route
# only: matfree_pcg's two f32 solves (~18 s) were cut to make room for
# phase 25 (PERF.md §4).
SD_CHAIN, SD_ATOL_F64 = 1000, 1e-7
SD_TIMED = ("dense",)
SD_CONFIG = dict(method="lm", max_iterations=25, gradient_tolerance=1e-10, step_tolerance=1e-10,
                 cost_tolerance=1e-14, pcg_max_iterations=200, pcg_tolerance=1e-10)
# matfree_pcg's LM (~18k launches an iteration) stops at the iteration cap:
# 10 iterations, not 25, to make room for phase 26 in phases 16 and 19, and 5
# in phase 16's check to make room for phase 28 (PERF.md §4)
SD_MATFREE = dict(SD_CONFIG, max_iterations=10)
SD_MATFREE_CHECK = dict(SD_MATFREE, max_iterations=5)
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
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
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


def resample_inputs(rng, b, p, d, dtype, device, zero_runs=False):
    """bench.py:190-196 from a numpy seed: weights uniform + 1e-6, one
    uniform per row, normal states [B, D, P]; with `zero_runs`, each row's
    weights then set to 0 over RESAMPLE_ZERO_RUNS' runs."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    w = rng.uniform(size=(b, p)).astype(npdt) + npdt(1e-6)
    u = rng.uniform(size=(b,)).astype(npdt)
    s = rng.standard_normal((b, d, p), dtype=npdt)
    if zero_runs:
        count, shortest, longest = RESAMPLE_ZERO_RUNS
        for row in w:
            for n in rng.integers(shortest, longest + 1, size=count):
                start = rng.integers(0, p - n + 1)
                row[start:start + n] = 0
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


def resample_branch_checks(device):
    """B3 on each branch of its launch plan (RESAMPLE_BRANCHES): the plan
    must pick the branch named, and `check_resample`'s gates hold. Returns
    {label: check_resample's result and the plan}."""
    from rust_robotics_tpu_torch.ops.resample import COPIED, DIRECT, STAGED, _launch_plan

    modes = {"staged": STAGED, "copied": COPIED, "direct": DIRECT}
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for branch, b, p, d, dtype, exact, flat in RESAMPLE_BRANCHES:
        args = resample_inputs(rng, b, p, d, dtype, device, zero_runs=flat)
        plan = _launch_plan(p, d, dtype, not (args[0].data_ptr() | args[2].data_ptr()) & 15)
        label = (f"resample {branch}{' flat CDF' if flat else ''} "
                 f"{'f32' if dtype == torch.float32 else 'f64'} B={b} P={p} D={d}")
        if plan.mode != modes[branch]:
            fail(f"{label}: the launch plan took another branch: {plan}")
        out[label] = {**check_resample(label, args, exact), "plan": plan._asdict()}
    return out


def resample_ptxas():
    """ptxas's registers, shared memory and spills of B3's six instances
    (f32 and f64 x staged, copied, direct); fails on a spill."""
    branches = {"0": "staged", "1": "copied", "2": "direct"}
    report = {}
    for entry, res in ptxas_report("resample").items():
        found = re.search(r"resample_kernelI([fd])Li(\d)E", entry)
        if found:
            report[f"{'f32' if found[1] == 'f' else 'f64'} {branches[found[2]]}"] = res
    print(f"ptxas resample: {report}")
    if len(report) != 6:
        fail(f"ptxas reported {len(report)} of B3's six instances")
    spilled = {k: v for k, v in report.items() if v.get("spill_stores") or v.get("spill_loads")}
    if spilled:
        fail(f"B3's kernel spills: {spilled}")
    return report


def resample_cold_ms(args, flush):
    """B3's own device time (`kernel_device_ms`) with its inputs out of L2:
    `flush` is zeroed before each call; only the kernel's events count."""
    def cold():
        flush.zero_()
        systematic_resample_gather(*args)

    return kernel_device_ms(cold, "resample_kernel")


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


# Idle host time kept inside each trace's window on both sides of the traced
# call, and the traces taken at most while one holds no device event: the
# profiler keeps only device events that fall inside its window on the host's
# clock, and it has returned traces of a short call with none of them.
TRACE_MARGIN_S = 0.02
TRACE_ATTEMPTS = 3


DeviceEvent = collections.namedtuple("DeviceEvent", "name time_range")
Span = collections.namedtuple("Span", "start end")  # µs


def device_events(prof):
    """A finished trace's device activities (name, time_range in µs), read
    from the profiler's raw results: `prof.events()` builds an event object
    for every activity, ~0.1 ms each, minutes for a trace of 10⁶ launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [DeviceEvent(e.name(), Span(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def device_trace(label, fn, cpu=True, enough=bool):
    """fn() once under torch.profiler (host and device activities, or the
    device's alone with cpu=False), TRACE_MARGIN_S of idle time on each side
    of it inside the window. Traces again, up to TRACE_ATTEMPTS in all,
    while enough(device events) is false, and fails if it stays false.
    Returns (profile, device events)."""
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(TRACE_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        events = device_events(prof)
        if enough(events):
            if attempt > 1:
                print(f"{label}: the trace of attempt {attempt} is whole")
            return prof, events
        print(f"{label}: trace {attempt} of {TRACE_ATTEMPTS} holds {len(events)} device events",
              file=sys.stderr)
    fail(f"{label}: the profiler saw no device events" if not events else
         f"{label}: the profiler saw {len(events)} device events, too few, in "
         f"{TRACE_ATTEMPTS} traces")


def device_breakdown(label, fn, top=6, full=True):
    """Where one call's time goes: its host-clock time, then under
    torch.profiler the device's busy time, the span from its first to its
    last device event, the idle share of that span, and the `top` device
    consumers by self time. Returns {names: every device event's name,
    host_ms, busy_ms, span_ms, idle}. full=False, for a call of tens of
    thousands of launches: one untimed call, then one traced call of the
    device's activities alone, with no host-clock call (host_ms None) and
    no consumers, which cost seconds there."""
    host_ms = None
    fn()
    torch.cuda.synchronize()
    if full:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3
    prof, events = device_trace(label, fn, cpu=full)
    names = [e.name for e in events]
    busy_ms = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    span_ms = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) / 1e3
    print(f"{label}: host clock {host_ms!r} ms; under the profiler device busy {busy_ms!r} ms of "
          f"a {span_ms!r} ms span ({1 - busy_ms / span_ms:.3f} idle), {len(events)} device events")
    consumers = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                       reverse=True) if full else []
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

    def calls():
        for _ in range(reps):
            fn()

    _, events = device_trace(name_part, calls,
                             enough=lambda ev: sum(name_part in e.name for e in ev) >= reps)
    durs = [e.time_range.end - e.time_range.start for e in events if name_part in e.name]
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
        size, PG_ITERATIONS, PG_TOLERANCE, device=device, runs=1)
    print(f"pose graph {size} chain f32 chain_direct on {card}: RMSE {err!r} (gate "
          f"{PG_CHAIN_RMSE}; the reference measured {PG_REFERENCE_RMSE}, README.md:728-730); "
          f"warm {seconds!r} s host clock; {summary.iterations} LM iterations, "
          f"{seconds / summary.iterations!r} s each; {summary}")
    if not err < PG_CHAIN_RMSE:
        fail(f"10k chain RMSE {err!r} >= {PG_CHAIN_RMSE}")
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(size)
    f64 = {}
    for where in (device, "cpu"):
        start = time.perf_counter()
        poses, s64 = optimize_pose_graph_2d(initial, ef, et, meas, info, PG_F64_ITERATIONS,
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
        size, batch, PG_ITERATIONS, PG_TOLERANCE, device=device, runs=1)
    terms = np.bincount(summ.termination_code.cpu().numpy(), minlength=5).tolist()
    print(f"pose graph serving {batch} x {size} f32 on {card}: worst RMSE {worst!r}; "
          f"{rate!r} graphs/s ({seconds!r} s warm); iterations max "
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
    # one cold timed solve of PG_GRID_ITERATIONS (its repeats were cut to make
    # room for phases 26 and 28; PERF.md §4)
    seconds, (poses, summary) = timed(lambda: optimize_pose_graph_2d(
        initial, ef, et, meas, info, PG_GRID_ITERATIONS, PG_TOLERANCE, "banded_direct",
        device=device))
    err = pose_graph_bench.rmse(poses.cpu().numpy(), truth)
    print(f"pose graph grid f32 banded_direct on {card}: RMSE {err!r} (gate {PG_GRID_RMSE}); "
          f"cold {seconds!r} s host clock; {summary.iterations} LM iterations, "
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
    # the device alone: the host clock and consumers of its ~33k launches,
    # a few s, were cut to make room for phase 28 (PERF.md §4)
    prof = device_breakdown(f"pose graph grid, one banded LM step (f32) on {card}",
                            lambda: step(state), full=False)
    del state, step, values_b, args
    routes = {}
    for label, graph in (("grid", (truth, initial, ef, et, meas, info)),
                         ("chain 2000", pose_graph_bench.synthesize_chain(2000))):
        calls = (tridiag.solve_chain_lm.calls, banded.solve_banded_lm.calls)
        g_truth, g_init, g_ef, g_et, g_meas, g_info = graph
        # the route is taken before the first iteration: PG_ROUTE_ITERATIONS
        # of them (the grid's full solve, ~15 s again, was cut; PERF.md §4)
        poses, s_direct = optimize_pose_graph_2d(g_init, g_ef, g_et, g_meas, g_info,
                                                 PG_ROUTE_ITERATIONS, PG_TOLERANCE, "direct",
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


# phase 16's anchored 10k poses, the unchunked reference of phase 28's (d)
SE3_ANCHORED = {}


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
    # one warm solve: the second, a repeat for its time (~7 s), was cut to
    # make room for phase 26 (PERF.md §4)
    warm_s, (poses, summary) = timed(anchored)
    SE3_ANCHORED["poses"] = poses
    err = pose_graph_bench.se3_position_rmse(poses, tm)
    print(f"SE(3) {SE3_CHAIN} chain f32 anchored chain_direct on {card}: RMSE {err!r} (gate "
          f"{SE3_RMSE_F32}; JAX measured 3.4e-5); warm {warm_s!r} s host clock, "
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
    no read inside an iteration, the reads of a whole solve; f32 times on
    the routes of SD_TIMED."""
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(SD_CHAIN)

    def problem(dtype):
        t = lambda a, dt=dtype: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
        return build_pose_graph_2d(t(initial), t(ef, torch.int64), t(et, torch.int64), t(meas),
                                   t(info))

    out = {}
    for solver in ("dense", "matfree_pcg"):
        cfg = SolverConfig(linear_solver=solver,
                           **(SD_MATFREE_CHECK if solver == "matfree_pcg" else SD_CONFIG))
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
        # matfree_pcg's ~18k launches profiled on the device alone (phase 28's room)
        prof = device_breakdown(f"solve_device {solver} {SD_CHAIN} chain, one LM iteration (f32) "
                                f"on {card}", lambda: step(state), full=solver == "dense")
        out[solver] = {"f64": {"solve_device": vars(ds), "solve": vars(hs), "max_abs_diff": diff,
                               "device_reads_per_solve": reads},
                       "launches_per_iteration": len(prof["names"]),
                       "profile": {k: v for k, v in prof.items() if k != "names"}}
        print(f"solve_device {solver}: {len(prof['names'])} device launches per iteration")
        if solver not in SD_TIMED:
            continue
        # one call each: the f64 calls above ran the same code (eager
        # PyTorch compiles nothing)
        solve_s, (_, h32) = timed(lambda: nlls_solver.solve(prob32, cfg))
        device_s, (_, s32) = timed(lambda: nlls_solver.solve_device(prob32, cfg))
        print(f"solve_device {solver} f32 on {card}: {device_s!r} s ({s32}); solve {solve_s!r} s "
              f"({h32})")
        out[solver]["f32_s"] = {"solve": solve_s, "solve_device": device_s}
        out[solver]["f32_summary"] = {"solve_device": vars(s32), "solve": vars(h32)}
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
    _, events = device_trace(label, fn, cpu=False)
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
# (measured on one H100); 12 windows (~13 s) until they were cut to 4 to
# make room for phase 26 (PERF.md §4)
VIO_WINDOWED_PREFIX = 4
# windows of the pipelined run: the flight's first 34 of 67 (~1 s each,
# dispatch-bound), cut to make room for phase 26 (PERF.md §4). The port's f64
# run on the CPU gives fused 0.01618 m against dead-reckoned 0.01939 m
# there (fused 0.01392 / 0.01615 at 30 windows, but 0.01255 / 0.01198 at 24:
# fewer windows would fail fused <= dead-reckoned)
VIO_WINDOWED_WINDOWS = 34
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
    """(b) run_vio_pipeline on cuda in f32 (B4 on its BA path) and f64, each
    once (cold); B4 against its twin on the f32 BA's own retained systems; cuda
    against the CPU in f64 on the first VIO_CUT keyframes."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        key = "f32" if dtype == torch.float32 else "f64"
        # the warm runs (~7 s each, repeats for their time) were cut to make
        # room for phases 25 (f64) and 26 (f32) (PERF.md §4)
        for run in ("cold",):
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
    """(c) run_vio_pipeline_windowed pipelined over the flight's first
    VIO_WINDOWED_WINDOWS windows in f64 (see VIO_WINDOWED_DTYPE), timed and
    gated; the sequential order on the first VIO_WINDOWED_PREFIX windows,
    bitwise against the pipelined run's."""
    f = VIO_WINDOWED_DTYPE
    pipe_s, pipe = timed(lambda: run_vio_pipeline_windowed(
        ds, tracks, window_frames=VIO_WINDOW_FRAMES, pipelined=True, device=device, dtype=f,
        max_windows=VIO_WINDOWED_WINDOWS))
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
    stage_d_graph_check(stages, windows)
    return True


def stage_d_graph_check(stages, windows):
    """`solve_device`'s CUDA graph of an LM step (nlls/solver.py::
    _graphed_step) against the eager step on the first two windows' stage-D
    problems: every field of the state after each iteration bitwise equal,
    over 8 iterations on the first window and 4 on the second, which
    replays the first one's graph (one capture for both)."""
    graphs = []
    for j, win in enumerate(windows[:2]):
        for st in stages[:3]:
            win = st.fn(st.init_carry, win)[1] if st.chain else st.fn(win)
        problem, config = vio_pp.fuse_problem(None, win)
        first, eager_step = device_lm_start(problem, config)
        graph_step = nlls_solver._graphed_step(problem, config, first)
        graphs.append(graph_step.graph)
        eager, graphed = first, first
        for k in range(2 * nlls_solver.DONE_READ_EVERY if j == 0 else
                       nlls_solver.DONE_READ_EVERY):
            eager, graphed = eager_step(eager), graph_step(graphed)
            fields = [*eager.values, *eager[1:]], [*graphed.values, *graphed[1:]]
            if not all(bitwise_equal(a, b) for a, b in zip(*fields)):
                fail(f"stage D window {j}: the graphed LM step differs from the eager one at "
                     f"iteration {k}")
    print(f"stage D: the graphed LM step bitwise equal to the eager step over "
          f"{2 * nlls_solver.DONE_READ_EVERY} + {nlls_solver.DONE_READ_EVERY} iterations on 2 "
          f"windows, the second replaying the first one's graph: {graphs[1] is graphs[0]}")
    if graphs[1] is not graphs[0]:
        fail("stage D: a second graph captured for a problem of the same structure")


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
    cfg = SolverConfig(linear_solver="matfree_pcg", **SD_MATFREE)
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


# The SPIKE programs (phase 20): the dryrun's programs 6-8
# (`__graft_entry__.py::dryrun_multichip`) on a one-rank NCCL mesh, at their
# full width. One card holds one rank, so the interface system is the
# rank's own 2t = 6 unknowns (dense) for the chain and 2·s·t for the fat
# blocks (block-Thomas), and a rank with no neighbour computes no spike.
# (a) program 6: the 10k chain with its 99 closures, f32, the dryrun's LM
# settings (__graft_entry__.py:231-233), held at the dryrun's gates: RMSE <
# 3·max(oracle RMSE, 1e-4) and poses within 2e-3 of `solve_chain_lm` on the
# card; then the f64 1000-pose chain within SPIKE_F64_ATOL of
# `solve_chain_lm` with the same termination (the two differ by the
# capacitance factor, LU against Cholesky, and their summation order:
# ~1e-14 on the CPU).
SPIKE_CHAIN, SPIKE_CHAIN_F64 = 10000, 1000
SPIKE_LM = dict(max_iterations=8, gradient_tolerance=1e-8, step_tolerance=1e-8,
                cost_tolerance=1e-16)
SPIKE_POSE_ATOL, SPIKE_F64_ATOL = 2e-3, 1e-8
# (b) program 7: the dryrun's 9x8 grid with 4 closures, f64, its LM settings,
# within SPIKE_GRID_SMALL_ATOL of `solve_general_graph`; bench.py's 100x100
# grid with 50 closures (PG_GRID), f32, both solves cut to
# SPIKE_GRID_ITERATIONS LM iterations (3 until phase 28 needed room; PERF.md
# §4), poses within the dryrun's atol 5e-4.
SPIKE_GRID_SMALL, SPIKE_GRID_SMALL_KW = (9, 8, 4), dict(max_iterations=12, tolerance=1e-9)
SPIKE_GRID_SMALL_ATOL, SPIKE_GRID_ITERATIONS, SPIKE_GRID_ATOL = 1e-9, 2, 5e-4
# (c) program 8: the sharded IFT of (a)'s solution, re-solved in f64, against
# `chain_implicit_vjp` on the card: the loss within rel 1e-12, the gradients
# within IFT_CUDA_CPU_REL of max|g| (phase 16's limit for two orders of the
# same undamped solve, κ ~ 1e8), the last odometry edge's gradient above
# IFT_MIN_GRAD; the f32 call timed and held to finiteness only (C1: JAX's
# f32 sharded IFT at this size has no accurate digits).
SPIKE_IFT_LOSS_REL = 1e-12
SE2 = dict(residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3)


def spike_chain_part(card, device, mesh):
    """(a) program 6. Returns (its numbers, the f32 solution)."""
    truth, values0, args = chain_problem_on(device, torch.float32, SPIKE_CHAIN)
    solve = make_sharded_chain_solver(mesh, "data", **SE2, **SPIKE_LM)
    oracle = [timed(lambda: tridiag.solve_chain_lm(values0, *args, **SE2, **SPIKE_LM))
              for _ in range(2)]
    oracle_s, (ref, ref_summary) = min(o[0] for o in oracle), oracle[-1][1]
    _collectives_reset()
    steps = tridiag.lm_run.steps
    cold_s, _ = timed(lambda: solve(values0, *args))
    iterations = tridiag.lm_run.steps - steps
    collectives = dict(pmesh.COLLECTIVES)
    warm = [timed(lambda: solve(values0, *args)) for _ in range(2)]
    warm_s, (values, summary) = min(w[0] for w in warm), warm[-1][1]
    err = pose_graph_bench.rmse(values.cpu().numpy(), truth)
    err_or = pose_graph_bench.rmse(ref.cpu().numpy(), truth)
    diff = float((values - ref).abs().max())
    per_iteration = {k: v / iterations for k, v in collectives.items()}
    print(f"SPIKE {SPIKE_CHAIN} chain f32 on {card}, {pmesh.axis_size(mesh, 'data')}-rank "
          f"{torch.distributed.get_backend()} mesh: RMSE {err!r} (gate "
          f"< 3 x max({err_or!r}, 1e-4)); poses max|diff| to solve_chain_lm {diff!r} (atol "
          f"{SPIKE_POSE_ATOL}); warm {warm_s!r} s (best of 2), cold {cold_s!r} s; "
          f"solve_chain_lm {oracle_s!r} s; {iterations} iterations, {summary}; oracle "
          f"{ref_summary}; collectives a solve {collectives}, an iteration {per_iteration}")
    if not (math.isfinite(err) and err < 3 * max(err_or, 1e-4) and diff <= SPIKE_POSE_ATOL):
        fail(f"SPIKE 10k chain: RMSE {err!r} (oracle {err_or!r}), max|diff| {diff!r}")
    state, step = sharded_chain_lm_start(
        mesh, "data", values0, *args, **SE2,
        **{k: v for k, v in SPIKE_LM.items() if k != "max_iterations"})
    no_read_in("SPIKE chain, one LM step", lambda: step(state))
    one_step = device_launches(f"SPIKE {SPIKE_CHAIN} chain, one LM step (f32) on {card}",
                               lambda: step(state))
    del state, step

    _, v64, args64 = chain_problem_on(device, torch.float64, SPIKE_CHAIN_F64)
    f64_s, (values64, s64) = timed(lambda: solve(v64, *args64))
    ref64, r64 = tridiag.solve_chain_lm(v64, *args64, **SE2, **SPIKE_LM)
    diff64 = float((values64 - ref64).abs().max())
    print(f"SPIKE {SPIKE_CHAIN_F64} chain f64 on {card}: {s64} in {f64_s!r} s; solve_chain_lm "
          f"{r64}; poses max|diff| {diff64!r} (atol {SPIKE_F64_ATOL})")
    if not (diff64 <= SPIKE_F64_ATOL and int(s64.termination_code) == int(r64.termination_code)):
        fail(f"SPIKE f64 chain against solve_chain_lm: {s64} vs {r64}, max|diff| {diff64!r}")
    return {"poses": SPIKE_CHAIN, "rmse": err, "oracle_rmse": err_or, "max_abs_diff": diff,
            "warm_s": warm_s, "cold_s": cold_s, "solve_chain_lm_s": oracle_s,
            "iterations": iterations, "summary": {k: float(v) for k, v in summary._asdict().items()},
            "collectives_per_solve": collectives, "collectives_per_iteration": per_iteration,
            "one_step": one_step,
            "f64_1000": {"seconds": f64_s, "max_abs_diff": diff64,
                         "summary": {k: float(v) for k, v in s64._asdict().items()},
                         "oracle": {k: float(v) for k, v in r64._asdict().items()}}}, values


def spike_grid_part(card, device, mesh):
    """(b) program 7: the dryrun's 9x8 grid in f64, the 100x100 grid in f32."""
    out = {}
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_grid(*SPIKE_GRID_SMALL)
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    init64 = torch.tensor(initial, dtype=torch.float64, device=device)
    small_s, (got, summary, plan) = timed(lambda: solve_general_graph_sharded(
        init64, ef, et, meas, info, fixed, mesh, "data", **SE2, **SPIKE_GRID_SMALL_KW))
    want, want_summary, _ = banded.solve_general_graph(init64, ef, et, meas, info, fixed, **SE2,
                                                       **SPIKE_GRID_SMALL_KW)
    diff = float((got - want).abs().max())
    same = all(int(a) == int(b) for a, b in ((summary.iterations, want_summary.iterations),
                                             (summary.termination_code,
                                              want_summary.termination_code)))
    print(f"SPIKE grid {SPIKE_GRID_SMALL} f64 on {card}: {summary} in {small_s!r} s; "
          f"solve_general_graph {want_summary}; max|diff| {diff!r} (atol "
          f"{SPIKE_GRID_SMALL_ATOL}); supernode {plan.supernode}, {plan.num_super} supernodes")
    if not (diff <= SPIKE_GRID_SMALL_ATOL and same):
        fail(f"SPIKE 9x8 grid: max|diff| {diff!r}, {summary} vs {want_summary}")
    out["grid_9x8_f64"] = {"seconds": small_s, "max_abs_diff": diff,
                           "iterations": int(summary.iterations)}

    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_grid(*PG_GRID)
    fixed = np.zeros(len(truth), bool)
    fixed[0] = True
    init32 = torch.tensor(initial, dtype=torch.float32, device=device)
    kw = dict(**SE2, max_iterations=SPIKE_GRID_ITERATIONS, tolerance=PG_TOLERANCE)
    _collectives_reset()
    sharded_s, (got, summary, plan) = timed(lambda: solve_general_graph_sharded(
        init32, ef, et, meas, info, fixed, mesh, "data", **kw))
    collectives = dict(pmesh.COLLECTIVES)
    plain_s, (want, want_summary, _) = timed(lambda: banded.solve_general_graph(
        init32, ef, et, meas, info, fixed, **kw))
    diff = float((got - want).abs().max())
    # two unsharded runs differ by the order of the fat-block scatter's
    # atomic adds: the floor any comparison of this solve sits on
    again = banded.solve_general_graph(init32, ef, et, meas, info, fixed, **kw)[0]
    noise = float((again - want).abs().max())
    its, want_its = int(summary.iterations), int(want_summary.iterations)
    width = 2 * pmesh.axis_size(mesh, "data") * plan.supernode * 3
    print(f"SPIKE grid {PG_GRID} f32 on {card}, cut to {SPIKE_GRID_ITERATIONS} LM iterations: "
          f"sharded {sharded_s!r} s ({sharded_s / its!r} s an iteration), solve_general_graph "
          f"{plain_s!r} s ({plain_s / want_its!r} s an iteration); max|diff| {diff!r} (atol "
          f"{SPIKE_GRID_ATOL}; two unsharded runs {noise!r} apart); interface 2·D·s·t = {width} "
          f"({'dense' if width <= _DENSE_INTERFACE_MAX else 'block-Thomas'}); {summary}; "
          f"collectives {collectives}; RMSE {pose_graph_bench.rmse(got.cpu().numpy(), truth)!r}")
    if not diff <= SPIKE_GRID_ATOL:
        fail(f"SPIKE 100x100 grid: max|diff| {diff!r}")
    out["grid_100x100_f32"] = {
        "iterations": its, "sharded_s": sharded_s, "solve_general_graph_s": plain_s,
        "sharded_s_per_iteration": sharded_s / its,
        "solve_general_graph_s_per_iteration": plain_s / want_its, "max_abs_diff": diff,
        "unsharded_run_to_run": noise,
        "interface_width": width, "collectives": collectives,
        "plan": {"supernode": plan.supernode, "num_super": plan.num_super}}
    return out


def spike_ift_part(card, device, mesh, values32):
    """(c) program 8 on (a)'s solution: f64 against chain_implicit_vjp, f32
    timed."""
    truth, _, args64 = chain_problem_on(device, torch.float64, SPIKE_CHAIN)
    resolve_s, (values64, s64) = timed(lambda: make_sharded_chain_solver(
        mesh, "data", **SE2, **SPIKE_LM)(values32.double(), *args64))
    target = torch.tensor(truth + 0.05, dtype=torch.float64, device=device)

    def loss_fn(v):
        return torch.sum((v[:, :2] - target[:, :2].to(v.dtype)) ** 2)

    ift = make_sharded_chain_ift(mesh, "data", **SE2, loss_fn=loss_fn)
    _collectives_reset()
    cold_s, _ = timed(lambda: ift(values64, *args64))
    collectives = dict(pmesh.COLLECTIVES)
    warm_s, got = timed(lambda: ift(values64, *args64))
    plain_s, want = timed(lambda: chain_implicit_vjp(values64, *args64[:-1], args64[-1],
                                                     loss_fn, **SE2))
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    scale = max(float(want[1].abs().max()), float(want[2].abs().max()))
    diff = max(float((got[1] - want[1]).abs().max()), float((got[2] - want[2]).abs().max()))
    last = SPIKE_CHAIN - 2
    g_last = got[1][last].tolist()
    _, _, args32 = chain_problem_on(device, torch.float32, SPIKE_CHAIN)
    f32_s, g32 = timed(lambda: ift(values32, *args32))
    finite32 = all(bool(torch.isfinite(g).all()) for g in g32)
    print(f"SPIKE IFT {SPIKE_CHAIN} chain f64 on {card}: re-solve {resolve_s!r} s ({s64}); "
          f"sharded IFT cold {cold_s!r} s, warm {warm_s!r} s; chain_implicit_vjp {plain_s!r} s; "
          f"loss rel {loss_rel!r} (limit {SPIKE_IFT_LOSS_REL}); gradients max|diff| {diff!r} "
          f"(limit {IFT_CUDA_CPU_REL} x max|g| {scale!r}); d_chain_meas[{last}] {g_last}; "
          f"collectives {collectives}; f32 {f32_s!r} s, finite {finite32}")
    if not (loss_rel <= SPIKE_IFT_LOSS_REL and diff <= IFT_CUDA_CPU_REL * scale
            and max(abs(g) for g in g_last[:2]) > IFT_MIN_GRAD and finite32):
        fail(f"SPIKE IFT: loss rel {loss_rel!r}, max|diff| {diff!r} of {scale!r}, "
             f"g[{last}] {g_last}, f32 finite {finite32}")
    return {"resolve_s": resolve_s, "cold_s": cold_s, "warm_s": warm_s,
            "chain_implicit_vjp_s": plain_s, "loss_rel_err": loss_rel,
            "max_abs_diff": diff, "max_abs_grad": scale, "d_chain_meas_last": g_last,
            "collectives": collectives, "f32_s": f32_s, "f32_finite": finite32}


def spike_phase(card, device, rank=0, world=1, store=None):
    """The SPIKE programs on one NCCL rank (phase 20), or as rank `rank` of
    `world` (`spike_ranks`)."""
    pmesh.init_process_group(rank, world, store, device_type=device.type)
    out = {"card": card, "backend": torch.distributed.get_backend(), "world": world}
    try:
        mesh = pmesh.make_mesh(axis_names=("data",), device_type=device.type)
        start = time.perf_counter()
        out["chain"], values32 = spike_chain_part(card, device, mesh)
        out["grid"] = spike_grid_part(card, device, mesh)
        out["ift"] = spike_ift_part(card, device, mesh, values32)
        out["phase_s"] = time.perf_counter() - start
        print(f"SPIKE programs: {out['phase_s']!r} s")
    finally:
        torch.distributed.destroy_process_group()
    return out


def _spike_rank(rank, world, cards, store_path, out_path):
    """Rank `rank` of `spike_ranks`, on card `rank`; only rank 0 prints."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = spike_phase(cards[rank], torch.device("cuda", rank), rank, world,
                      torch.distributed.FileStore(store_path, world))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def spike_ranks(world=4):
    """Phase 20's SPIKE programs with their rows split over `world` NCCL
    ranks, one card each, every part held to the same unsharded functions
    on each rank's card: `python3 -c 'import chip_smoke as cs;
    cs.spike_ranks(4)'` on a host with `world` cards. Prints rank 0's lines
    and one JSON line `{"parallel_spike_ranks": {...}}`."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        fail(f"spike_ranks({world}) needs {world} CUDA cards")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {cards}")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        torch.multiprocessing.spawn(_spike_rank, args=(world, cards, os.path.join(tmp, "store"),
                                                       out_path), nprocs=world, join=True)
        with open(out_path) as f:
            print(json.dumps({"parallel_spike_ranks": json.load(f)}))


# The navigation stack (phase 21): DWA and the mission FSM with their two
# headless demos, mapping/, and the grid-search family (no kernel on its
# path). Each part runs once under sync debug mode "warn" (its device
# reads), once on the host clock and once under the profiler (launches,
# idle share), with the six kernel entries' counts reset before it, and is
# held to the CPU (f64) at the sizes below.
# (a) the DWA fleet: NAV_FLEET robots in lock-step, DWAConfig's 11 x 41
# samples and 32 states, NAV_OBSTACLES obstacles each, f32, NAV_STEPS steps;
# NAV_LANES lanes bitwise their solo runs; a 16-robot f64 fleet within
# NAV_CUDA_CPU_ATOL of the CPU for NAV_STEPS steps (a control within it is
# the same sample: two samples differ by at least a window's width over 40,
# ~3e-3); the two demos in f64 (bools and ints exact, floats within
# NAV_CUDA_CPU_ATOL) and in f32 (s and reads a step).
NAV_FLEET, NAV_OBSTACLES, NAV_STEPS, NAV_SMALL = 1024, 64, 10, 16
NAV_LANES = (0, 1, 2, 511, 512, 777, 1022, 1023)
NAV_CUDA_CPU_ATOL = 1e-9
# (b) mapping at the widths its users run: a 270° scan of 1081 beams at
# 256 samples into 1000 x 1000 cells of 0.05 m; the SDF of 1024 x 1024; NDT
# of 10^6 points into 500 x 500 cells scored on 10^5; k-means 262,144 x 32
# for 20 iterations; DBSCAN 8192; normals 8192 (k = 8); FPS 10^5 -> 1024;
# GP 2048 x 65,536; split-and-merge on 1081 points. Each is held to the CPU
# in f64 at the reduced size in brackets, at the tests' tolerance
# (MAP_ATOL, tests/test_torch_mapping.py); labels, masks and indices exactly.
MAP_ATOL = 1e-10
MAP_BEAMS, MAP_SAMPLES, MAP_CELLS, MAP_RES = 1081, 256, 1000, 0.05
MAP_SDF, MAP_SDF_CPU = 1024, 256
MAP_NDT_POINTS, MAP_NDT_CELLS, MAP_NDT_QUERIES = 1_000_000, 500, 100_000
MAP_NDT_CPU = (100_000, 100, 10_000)
MAP_KMEANS, MAP_KMEANS_K, MAP_KMEANS_CPU = 262_144, 32, 16_384
MAP_DBSCAN, MAP_DBSCAN_CPU = 8192, 2048
MAP_NORMALS, MAP_NORMALS_CPU = 8192, 1024
MAP_FPS, MAP_FPS_SAMPLES, MAP_FPS_CPU = 100_000, 1024, (10_000, 256)
MAP_GP, MAP_GP_QUERIES, MAP_GP_CPU = 2048, 65_536, (512, 4096)
# (c) grid search in f64 (the RAISE test's tolerance of 1e-6 is below
# float32's rounding of costs of ~10^2): JPS on 512 x 512 at 20 % blocked,
# its cost within GRID_JPS_ATOL of `wavefront_costs` (B2, run after the
# part's counts are read); `repair_costs` after a 5 x 5 edit on 64 maps of
# 256 x 256; ARA*, IDA* and the beam on 128 x 128 at 10 % blocked, IDA*
# cut to GRID_IDA_DEEPENINGS deepenings (JAX's default of 64 ran 265k
# launches in 3.7 s on an NVIDIA H100 80GB HBM3 at 700 W, and the
# profiler's trace of them took a minute; the CPU comparison keeps the 64); the 26-connected 3-D wavefront on 64^3 at 20 %
# and its path; `shortcut_path` on a 128-vertex grid path. Held to the CPU
# within GRID_ATOL with equal counts at the reduced sizes in brackets.
GRID_ATOL, GRID_JPS_ATOL = 1e-12, 1e-9
GRID_JPS, GRID_JPS_CPU = 512, 128
GRID_REPAIR, GRID_REPAIR_CPU = (64, 256), (4, 64)
GRID_SEARCH, GRID_SEARCH_CPU, GRID_IDA_DEEPENINGS = 128, 32, 8
GRID_3D, GRID_3D_CPU = 64, 16
GRID_PATH = 128
# the six kernel entries' launches summed over the phase's parts
NAV_KERNEL_LAUNCHES = {}


def profile_once(label, fn):
    """One call under the profiler (device only): launches, busy, span and
    the idle share of the span."""
    _, events = device_trace(label, fn, cpu=False)
    busy_ms = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    span_ms = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) / 1e3
    return {"launches": len(events), "busy_ms": busy_ms, "span_ms": span_ms,
            "idle": 1 - busy_ms / span_ms}


# the modules that call `wavefront_costs` by name (planning II's B2 users)
WAVEFRONT_CALLERS = (pfields, pcoverage, pfrontier)


@contextlib.contextmanager
def count_wavefront_calls():
    """Counts the calls the fields, coverage and frontier modules make to
    `wavefront_costs` while the block runs."""
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return wavefront_costs(*args, **kwargs)

    for module in WAVEFRONT_CALLERS:
        module.wavefront_costs = counted
    try:
        yield calls
    finally:
        for module in WAVEFRONT_CALLERS:
            module.wavefront_costs = wavefront_costs


def nav_part(label, fn, counted, profiled=True, b2=False, totals=None):
    """fn() under sync debug mode "warn" (its reads), on the host clock, and
    under the profiler, with the kernel entries and the fields', coverage's
    and frontier's `wavefront_costs` calls counted over all three;
    unprofiled, one run under "warn" on the host clock. With b2, B2's
    `wavefront_relax` must launch once per such call, and at least once;
    every other entry (and B2 without b2) never. The launches add into
    `totals` (default phase 21's). Returns (fn's last result, the
    numbers)."""
    totals = NAV_KERNEL_LAUNCHES if totals is None else totals
    for k in counted:
        k.launches = 0
    with count_wavefront_calls() as calls:
        if profiled:
            _, reads = reads_in(fn)
            host_s, out = timed(fn)
        else:
            host_s, (out, reads) = timed(lambda: reads_in(fn))
        stats = {"host_s": host_s, "reads": reads}
        if profiled:
            stats.update(profile_once(label, fn))
    runs = 3 if profiled else 1
    stats["kernel_launches"] = {k.__name__: k.launches for k in counted}
    stats["wavefront_costs_calls"] = calls[0]
    for name, n in stats["kernel_launches"].items():
        totals[name] = totals.get(name, 0) + n
    print(f"{label}: {host_s!r} s host; {reads} device reads; "
          + (f"device busy {stats['busy_ms']!r} ms, {stats['launches']} launches, "
             f"{stats['idle']:.3f} idle; " if profiled else "")
          + f"{calls[0]} wavefront_costs calls over {runs} runs; kernel entries "
          f"{stats['kernel_launches']}")
    b2_launches = stats["kernel_launches"]["wavefront_relax"]
    others = {n: v for n, v in stats["kernel_launches"].items() if n != "wavefront_relax" and v}
    if others or (b2_launches and not b2):
        fail(f"{label}: launched a kernel: {stats['kernel_launches']}")
    if b2 and not b2_launches == calls[0] >= runs:
        fail(f"{label}: {b2_launches} wavefront_relax launches for {calls[0]} wavefront_costs "
             f"calls")
    return out, stats


def _gate(label, ok, detail):
    print(f"{label}: {detail}")
    if not ok:
        fail(f"{label}: {detail}")


def _diff(a, b):
    """max |a − b| over floats moved to the host in f64 (0 for empty)."""
    a, b = (torch.as_tensor(x).detach().cpu().double() for x in (a, b))
    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return math.inf
    return float((a - b)[both].abs().max()) if both.any() else 0.0


def nav_fleet_inputs(rng, b, m):
    """Robots near the origin bound for goals 6-10 m away through a field
    of obstacles, numpy f64."""
    state = np.zeros((b, 5))
    state[:, :2] = rng.uniform(-1.0, 1.0, (b, 2))
    state[:, 2] = rng.uniform(-np.pi, np.pi, b)
    state[:, 3] = rng.uniform(0.0, 0.6, b)
    goal = rng.uniform(6.0, 10.0, (b, 2))
    obstacles = rng.uniform(-3.0, 12.0, (b, m, 2))
    mask = rng.random((b, m)) > 0.1
    return state, goal, obstacles, mask


def nav_dwa_part(card, device, counted):
    """(a) the DWA fleet, lanes, cuda = CPU, and the two demos."""
    out = {}
    cfg = DWAConfig()
    state, goal, obstacles, mask = nav_fleet_inputs(np.random.default_rng(SEED + 210),
                                                    NAV_FLEET, NAV_OBSTACLES)
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (state, goal, obstacles)]
    m = torch.tensor(mask, device=device)

    def fleet_run():
        s = args[0]
        for _ in range(NAV_STEPS):
            control, s, traj, cost = dwa_step(s, args[1], args[2], cfg, m)
        return s

    final, stats = nav_part(f"DWA fleet {NAV_FLEET} x {NAV_STEPS} steps f32 on {card}",
                            fleet_run, counted)
    step_ms = time_ms(lambda: dwa_step(args[0], args[1], args[2], cfg, m), reps=3, bursts=3)
    no_read_in("DWA fleet, one step", lambda: dwa_step(args[0], args[1], args[2], cfg, m))
    k = cfg.v_samples * cfg.w_samples
    d_bytes = NAV_FLEET * k * (cfg.horizon + 1) * NAV_OBSTACLES * 4
    out["fleet"] = {**stats, "robots": NAV_FLEET, "samples": k, "states": cfg.horizon + 1,
                    "obstacles": NAV_OBSTACLES, "steps": NAV_STEPS,
                    "robot_steps_per_s": NAV_FLEET * NAV_STEPS / stats["host_s"],
                    "step_device_ms": step_ms, "distance_tensor_bytes": d_bytes,
                    "finite": bool(torch.isfinite(final).all())}
    print(f"DWA fleet on {card}: {out['fleet']['robot_steps_per_s']!r} robot-steps/s; one step "
          f"{step_ms!r} ms by CUDA events; distances {d_bytes / 1e9:.2f} GB a step")
    _gate("DWA fleet finite", out["fleet"]["finite"], "final states finite")

    fleet = dwa_step(args[0], args[1], args[2], cfg, m)
    same = []
    for lane in NAV_LANES:
        solo = dwa_step(args[0][lane], args[1][lane], args[2][lane], cfg, m[lane])
        same.append(all(bitwise_equal(s, f[lane]) for s, f in zip(solo, fleet)))
    _gate(f"DWA {len(NAV_LANES)} lanes = solo runs", all(same), f"bitwise {same}")

    small = [torch.tensor(a[:NAV_SMALL], dtype=torch.float64) for a in (state, goal, obstacles)]
    small_m = torch.tensor(mask[:NAV_SMALL])
    diffs = []
    s_cpu, s_gpu = small[0], small[0].to(device)
    for _ in range(NAV_STEPS):
        c_cpu, s_cpu, t_cpu, k_cpu = dwa_step(s_cpu, small[1], small[2], cfg, small_m)
        c_gpu, s_gpu, t_gpu, k_gpu = dwa_step(s_gpu, small[1].to(device), small[2].to(device),
                                              cfg, small_m.to(device))
        diffs.append(max(_diff(c_gpu, c_cpu), _diff(s_gpu, s_cpu), _diff(t_gpu, t_cpu),
                         _diff(k_gpu, k_cpu)))
    _gate(f"DWA {NAV_SMALL}-robot fleet f64 cuda = CPU over {NAV_STEPS} steps",
          max(diffs) <= NAV_CUDA_CPU_ATOL,
          f"max|diff| {max(diffs)!r} (atol {NAV_CUDA_CPU_ATOL}; the chosen controls agree, so "
          f"the same samples)")
    out["f64_cuda_cpu_max_abs_diff"] = max(diffs)

    for name, demo in (("navigation", headless_navigation_loop),
                       ("mission", headless_mission_recovery)):
        want = demo(device="cpu", dtype=torch.float64)
        got = demo(device=device, dtype=torch.float64)
        bad = [key for key, w in want.items()
               if (got[key] != w if isinstance(w, (bool, int)) else
                   not abs(got[key] - w) <= NAV_CUDA_CPU_ATOL)]
        _gate(f"headless {name} f64 cuda = CPU", not bad, f"{got} vs {want}; differ: {bad}")
        res32, stats32 = nav_part(f"headless {name} f32 on {card}",
                                  lambda: demo(device=device, dtype=torch.float32), counted,
                                  profiled=False)
        # the loop's steps: the demo's own count, or the reads of the whole
        # run less those of a run of 0 steps, over those a step adds
        limit = "steps" if name == "navigation" else "max_steps"
        r0, r1 = (reads_in(lambda n=n: demo(**{limit: n}, device=device,
                                              dtype=torch.float32))[1] for n in (0, 1))
        if r1 <= r0:
            fail(f"headless {name}: a step read nothing back ({r0} and {r1} reads)")
        steps = res32.get("steps_used") or round((stats32["reads"] - r0) / (r1 - r0))
        out[name] = {"f64": got, "f32": res32, **stats32, "steps": steps,
                     "s_per_step": stats32["host_s"] / steps,
                     "reads_per_step": stats32["reads"] / steps, "setup_reads": r0}
        print(f"headless {name} f32: {steps} steps, {out[name]['s_per_step']!r} s a step, "
              f"{out[name]['reads_per_step']!r} reads a step ({r0} reads with 0 steps)")
    return out


def scan_1081(rng):
    """A 270° scan of MAP_BEAMS beams from inside a 40 m room with posts."""
    angles = np.linspace(-0.75 * np.pi, 0.75 * np.pi, MAP_BEAMS)
    ranges = rng.uniform(2.0, 24.0, MAP_BEAMS)
    ranges[rng.random(MAP_BEAMS) < 0.1] = 25.0
    return np.array([0.7, -0.4]), angles, ranges


def map_mapping_part(card, device, counted):
    """(b) mapping: each function at width, held to the CPU in f64."""
    out = {}
    rng = np.random.default_rng(SEED + 211)
    spec = GridSpec2D(-25.0, -25.0, MAP_RES, MAP_CELLS, MAP_CELLS)
    origin, angles, ranges = scan_1081(rng)

    def lidar(dtype, dev):
        return lidar_to_grid(origin, angles, ranges, spec, max_range=25.0, samples=MAP_SAMPLES,
                             device=dev, dtype=dtype)

    grid, stats = nav_part(f"lidar_to_grid {MAP_BEAMS} x {MAP_SAMPLES} -> {MAP_CELLS}^2 f32 "
                           f"on {card}", lambda: lidar(torch.float32, device), counted)
    again = lidar(torch.float32, device)
    want = lidar(torch.float64, "cpu")
    got = lidar(torch.float64, device).cpu()
    cells = torch.equal(got != 0, want != 0)
    _gate("lidar_to_grid two calls", bitwise_equal(grid, again), "bitwise equal")
    _gate("lidar_to_grid f64 cuda = CPU", cells and _diff(got, want) <= 1e-12,
          f"touched cells equal {cells}, values max|diff| {_diff(got, want)!r} (atol 1e-12)")
    out["lidar_to_grid"] = {**stats, "cells_touched": int((want != 0).sum())}

    obs = torch.tensor(rng.random((MAP_SDF, MAP_SDF)) < 0.02, device=device)
    sdf, stats = nav_part(f"compute_sdf {MAP_SDF}^2 f32 on {card}", lambda: compute_sdf(obs),
                          counted)
    small = obs[:MAP_SDF_CPU, :MAP_SDF_CPU]
    same = bitwise_equal(compute_sdf(small).cpu(), compute_sdf(small.cpu()))
    _gate(f"compute_sdf {MAP_SDF_CPU}^2 f32 cuda = CPU", same, "bitwise equal")
    udf = compute_udf(obs, torch.float64).cpu().numpy()
    edt = ndimage.distance_transform_edt(~obs.cpu().numpy())
    _gate(f"compute_udf {MAP_SDF}^2 f64 = scipy's EDT", np.array_equal(udf, edt),
          f"max|diff| {np.abs(udf - edt).max()!r}")
    out["compute_sdf"] = stats

    def ndt_inputs(n, cells, q):
        centers = rng.uniform(0.0, cells * 0.2, (256, 2))
        pts = centers[rng.integers(0, 256, n)] + 0.15 * rng.standard_normal((n, 2))
        return pts, pts[:q] + 0.02 * rng.standard_normal((q, 2))

    pts, qs = ndt_inputs(MAP_NDT_POINTS, MAP_NDT_CELLS, MAP_NDT_QUERIES)
    pts_d, qs_d = (torch.tensor(a, dtype=torch.float32, device=device) for a in (pts, qs))

    def ndt_call(p, q, cells):
        mean, cov, count, valid = ndt_grid(p, (0.0, 0.0), 0.2, cells, cells)
        return ndt_score(q, mean, cov, valid, (0.0, 0.0), 0.2)

    _, stats = nav_part(f"ndt_grid {MAP_NDT_POINTS} -> {MAP_NDT_CELLS}^2 + ndt_score "
                        f"{MAP_NDT_QUERIES} f32 on {card}",
                        lambda: ndt_call(pts_d, qs_d, MAP_NDT_CELLS), counted)
    n, cells, q = MAP_NDT_CPU
    pts, qs = ndt_inputs(n, cells, q)
    want = [tuple(ndt_grid(torch.tensor(pts, device=dv), (0.0, 0.0), 0.2, cells, cells))
            + (ndt_call(torch.tensor(pts, device=dv), torch.tensor(qs, device=dv), cells),)
            for dv in ("cpu", device)]
    err = max(_diff(g, w) for g, w in zip(want[1], want[0]))
    _gate(f"NDT {MAP_NDT_CPU} f64 cuda = CPU", err <= MAP_ATOL, f"max|diff| {err!r}")
    out["ndt"] = stats

    def blobs(nn, k, dim=2, spread=0.5):
        centers = rng.uniform(-20.0, 20.0, (k, dim))
        return centers[rng.integers(0, k, nn)] + spread * rng.standard_normal((nn, dim)), centers

    km_pts, km_c = blobs(MAP_KMEANS, MAP_KMEANS_K)
    km = [torch.tensor(a, dtype=torch.float32, device=device) for a in (km_pts, km_c + 0.7)]
    _, stats = nav_part(f"kmeans {MAP_KMEANS} x {MAP_KMEANS_K}, 20 iterations f32 on {card}",
                        lambda: kmeans(*km, 20), counted)
    sub = [torch.tensor(a) for a in (km_pts[:MAP_KMEANS_CPU], km_c + 0.7)]
    want, got = kmeans(*sub, 20), kmeans(*(a.to(device) for a in sub), 20)
    _gate(f"kmeans {MAP_KMEANS_CPU} f64 cuda = CPU",
          _diff(got[0], want[0]) <= MAP_ATOL and torch.equal(got[1].cpu(), want[1]),
          f"centers max|diff| {_diff(got[0], want[0])!r}, labels equal")
    out["kmeans"] = stats

    db_pts, _ = blobs(MAP_DBSCAN, 24, spread=0.8)
    db = torch.tensor(db_pts, dtype=torch.float32, device=device)
    labels, stats = nav_part(f"dbscan {MAP_DBSCAN} f32 on {card}", lambda: dbscan(db, 0.6, 5),
                             counted)
    sub = torch.tensor(db_pts[:MAP_DBSCAN_CPU])
    same = torch.equal(dbscan(sub.to(device), 0.6, 5).cpu(), dbscan(sub, 0.6, 5))
    _gate(f"dbscan {MAP_DBSCAN_CPU} f64 cuda = CPU", same, "labels equal")
    out["dbscan"] = {**stats, "clusters": int(torch.unique(labels[labels >= 0]).numel())}

    xy = rng.uniform(0.0, 30.0, (MAP_NORMALS, 2))
    surf = np.concatenate([xy, np.sin(0.3 * xy[:, :1]) + 0.1 * xy[:, 1:]], -1)
    nm = torch.tensor(surf, dtype=torch.float32, device=device)
    _, stats = nav_part(f"estimate_normals {MAP_NORMALS} (k = 8) f32 on {card}",
                        lambda: estimate_normals(nm, 8), counted)
    sub = torch.tensor(surf[:MAP_NORMALS_CPU])
    got, want = estimate_normals(sub.to(device), 8).cpu(), estimate_normals(sub, 8)
    err = float((torch.sum(got * want, -1).abs() - 1.0).abs().max())
    _gate(f"estimate_normals {MAP_NORMALS_CPU} f64 cuda = CPU up to sign", err <= MAP_ATOL,
          f"max ||n·n_cpu| − 1| {err!r}")
    out["estimate_normals"] = stats

    fps_pts = rng.uniform(-50.0, 50.0, (MAP_FPS, 3))
    fp = torch.tensor(fps_pts, dtype=torch.float32, device=device)
    _, stats = nav_part(f"farthest_point_sample {MAP_FPS} -> {MAP_FPS_SAMPLES} f32 on {card}",
                        lambda: farthest_point_sample(fp, MAP_FPS_SAMPLES), counted)
    n, k = MAP_FPS_CPU
    sub = torch.tensor(fps_pts[:n])
    same = torch.equal(farthest_point_sample(sub.to(device), k).cpu(),
                       farthest_point_sample(sub, k))
    _gate(f"farthest_point_sample {MAP_FPS_CPU} f64 cuda = CPU", same, "indices equal")
    out["farthest_point_sample"] = stats

    gx = rng.uniform(-10.0, 10.0, (MAP_GP, 2))
    gy = np.sin(0.4 * gx[:, 0]) * np.cos(0.3 * gx[:, 1]) + 0.05 * rng.standard_normal(MAP_GP)
    gq = rng.uniform(-10.0, 10.0, (MAP_GP_QUERIES, 2))
    gpa = [torch.tensor(a, dtype=torch.float32, device=device) for a in (gx, gy, gq)]
    _, stats = nav_part(f"gp_regression {MAP_GP} x {MAP_GP_QUERIES} f32 on {card}",
                        lambda: gp_regression(*gpa, length_scale=1.5), counted)
    n, q = MAP_GP_CPU
    sub = [torch.tensor(a) for a in (gx[:n], gy[:n], gq[:q])]
    want = gp_regression(*sub, length_scale=1.5)
    got = gp_regression(*(a.to(device) for a in sub), length_scale=1.5)
    err = max(_diff(g, w) for g, w in zip(got, want))
    _gate(f"gp_regression {MAP_GP_CPU} f64 cuda = CPU", err <= MAP_ATOL, f"max|diff| {err!r}")
    out["gp_regression"] = stats

    th = np.linspace(-0.75 * np.pi, 0.75 * np.pi, MAP_BEAMS)
    r = np.minimum(8.0 / np.maximum(np.abs(np.cos(th)), 1e-3),
                   6.0 / np.maximum(np.abs(np.sin(th)), 1e-3))
    wall = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    wall += 0.01 * rng.standard_normal((MAP_BEAMS, 2))
    wp = torch.tensor(wall, dtype=torch.float32, device=device)
    brk, stats = nav_part(f"split_and_merge {MAP_BEAMS} f32 on {card}",
                          lambda: split_and_merge(wp), counted)
    same = torch.equal(split_and_merge(torch.tensor(wall, device=device)).cpu(),
                       split_and_merge(torch.tensor(wall)))
    _gate(f"split_and_merge {MAP_BEAMS} f64 cuda = CPU", same, "breakpoints equal")
    out["split_and_merge"] = {**stats, "segments": int(brk.sum()) - 1}
    return out


def _rand_free(rng, shape, p):
    free = rng.random(shape) > p
    free[(1,) * len(shape)] = free[tuple(n - 2 for n in shape)] = True
    return free


def grid_search_part(card, device, counted):
    """(c) the grid-search family in f64, held to the CPU."""
    out = {}
    f64 = torch.float64
    rng = np.random.default_rng(SEED + 212)

    free = _rand_free(rng, (GRID_JPS, GRID_JPS), 0.2)
    s, g = (1, 1), (GRID_JPS - 2, GRID_JPS - 2)
    plan, stats = nav_part(f"jps_plan {GRID_JPS}^2 f64 on {card}",
                           lambda: jps_plan(free, s, g, device=device, dtype=f64), counted)
    field = wavefront_costs(torch.tensor(free, device=device),
                            torch.tensor(goal_raster_np(free.shape, g), device=device), dtype=f64)
    ref = float(field[s])
    _gate(f"jps_plan {GRID_JPS}^2 = wavefront_costs", abs(plan["cost"] - ref) <= GRID_JPS_ATOL,
          f"{plan} against {ref!r} (atol {GRID_JPS_ATOL})")
    small = _rand_free(rng, (GRID_JPS_CPU, GRID_JPS_CPU), 0.2)
    g = (GRID_JPS_CPU - 2, GRID_JPS_CPU - 2)
    got, want = (jps_plan(small, s, g, device=d, dtype=f64) for d in (device, "cpu"))
    _gate(f"jps_plan {GRID_JPS_CPU}^2 f64 cuda = CPU",
          abs(got["cost"] - want["cost"]) <= GRID_ATOL
          and all(got[k] == want[k] for k in ("found", "jump_edges", "sweeps")),
          f"{got} vs {want}")
    out["jps"] = {**stats, **plan}

    def repair_inputs(b, n, dev):
        free_b = np.stack([_rand_free(rng, (n, n), 0.2) for _ in range(b)])
        goals = np.zeros_like(free_b)
        goals[:, n - 2, n - 2] = True
        edited = free_b.copy()
        edited[:, n // 2 - 2:n // 2 + 3, n // 2 - 2:n // 2 + 3] = False
        t = [torch.tensor(a, device=dev) for a in (free_b, goals, edited)]
        d0, _ = relax_with_stats(torch.full(free_b.shape, torch.inf, dtype=f64, device=dev),
                                 t[0], t[1])
        return d0, t[2], t[1]

    b, n = GRID_REPAIR
    rep_args = repair_inputs(b, n, device)
    (_, raise_s, lower_s), stats = nav_part(f"repair_costs {b} x {n}^2 f64 on {card}",
                                            lambda: repair_costs(*rep_args), counted)
    b, n = GRID_REPAIR_CPU
    cpu_args = repair_inputs(b, n, "cpu")
    want = repair_costs(*cpu_args)
    got = repair_costs(*(a.to(device) for a in cpu_args))
    _gate(f"repair_costs {GRID_REPAIR_CPU} f64 cuda = CPU",
          _diff(got[0], want[0]) <= GRID_ATOL and got[1:] == want[1:],
          f"max|diff| {_diff(got[0], want[0])!r}, sweeps {got[1:]} vs {want[1:]}")
    out["repair_costs"] = {**stats, "raise_sweeps": raise_s, "lower_sweeps": lower_s}

    def search_inputs(nn, dev):
        fr = torch.tensor(_rand_free(rng, (nn, nn), 0.1), device=dev)
        goal = (nn - 2, nn - 2)
        goals = torch.tensor(goal_raster_np((nn, nn), goal), device=dev)
        return fr, goal, goals, octile_heuristic((nn, nn), (1, 1), device=dev, dtype=f64)

    def to_device(inputs):
        return [a.to(device) if isinstance(a, torch.Tensor) else a for a in inputs]

    def searches(fr, goal, goals, h):
        ara = ara_star_plan(fr, (1, 1), goal, dtype=f64)
        ida = ida_star_costs(fr, (1, 1), goal, dtype=f64)
        beam = beam_search_costs(fr, goals, h, beam_width=64)
        return ara, ida, beam

    big = search_inputs(GRID_SEARCH, device)
    for name, call in (("ara_star_plan", lambda: ara_star_plan(big[0], (1, 1), big[1], dtype=f64)),
                       ("ida_star_costs", lambda: ida_star_costs(
                           big[0], (1, 1), big[1], max_deepenings=GRID_IDA_DEEPENINGS,
                           dtype=f64)),
                       ("beam_search_costs", lambda: beam_search_costs(big[0], big[2], big[3],
                                                                      beam_width=64))):
        res, stats = nav_part(f"{name} {GRID_SEARCH}^2 f64 on {card}", call, counted)
        if name == "ida_star_costs":
            stats.update(deepenings=res[2]["deepenings"], cost=float(res[1]))
        elif name == "beam_search_costs":
            stats.update(sweeps=res[1], cost=float(res[0][1, 1]))
        else:
            stats.update(stage_costs=res[1].tolist())
        out[name] = stats
    small = search_inputs(GRID_SEARCH_CPU, "cpu")
    cpu, gpu = searches(*small), searches(*to_device(small))
    err = max(max(_diff(x, y) for x, y in zip(gpu[0], cpu[0])),
              _diff(gpu[1][0], cpu[1][0]), _diff(gpu[2][0], cpu[2][0]))
    counts = (gpu[1][2]["deepenings"], int(gpu[1][2]["expanded_cells"]), gpu[2][1])
    counts_cpu = (cpu[1][2]["deepenings"], int(cpu[1][2]["expanded_cells"]), cpu[2][1])
    _gate(f"ARA*, IDA*, beam {GRID_SEARCH_CPU}^2 f64 cuda = CPU",
          err <= GRID_ATOL and counts == counts_cpu,
          f"max|diff| {err!r}; deepenings, expanded, beam sweeps {counts} vs {counts_cpu}")

    vox = _rand_free(rng, (GRID_3D,) * 3, 0.2)
    path, stats = nav_part(f"plan_grid_3d {GRID_3D}^3 26-connected f64 on {card}",
                           lambda: plan_grid_3d(vox, (1, 1, 1), (GRID_3D - 2,) * 3, device=device,
                                                dtype=f64), counted)
    small = _rand_free(rng, (GRID_3D_CPU,) * 3, 0.2)
    got, want = (plan_grid_3d(small, (1, 1, 1), (GRID_3D_CPU - 2,) * 3, device=d, dtype=f64)
                 for d in (device, "cpu"))
    _gate(f"plan_grid_3d {GRID_3D_CPU}^3 f64 cuda = CPU",
          torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
          and _diff(got[2], want[2]) <= GRID_ATOL, f"cost {float(got[2])!r} vs {float(want[2])!r}")
    out["plan_grid_3d"] = {**stats, "cost": float(path[2]), "path_len": int(path[1].sum())}

    fr = _rand_free(rng, (GRID_PATH, GRID_PATH), 0.15)
    fr[120, 120] = True
    costs = wavefront_costs(torch.tensor(fr), torch.tensor(goal_raster_np(fr.shape, (120, 120))),
                            dtype=f64)
    idx, mask, _ = extract_path(costs, torch.tensor(fr), (1, 1), max_len=GRID_PATH)
    pts = (idx.double() + 0.5) * 0.5  # cell centres at 0.5 m
    args = (pts, mask.double(), torch.tensor(~fr), 0.0, 0.0, 0.5)
    args_d = to_device(args)
    (keep, total), stats = nav_part(f"shortcut_path {GRID_PATH} vertices f64 on {card}",
                                    lambda: shortcut_path(*args_d), counted)
    want = shortcut_path(*args)
    _gate(f"shortcut_path {GRID_PATH} f64 cuda = CPU",
          torch.equal(keep.cpu(), want[0]) and _diff(total, want[1]) <= GRID_ATOL,
          f"kept {int(keep.sum())} of {int(mask.sum())}, length {float(total)!r} vs "
          f"{float(want[1])!r}")
    out["shortcut_path"] = {**stats, "kept": int(keep.sum()), "vertices": int(mask.sum())}
    return out


def goal_raster_np(shape, idx):
    g = np.zeros(shape, bool)
    g[idx] = True
    return g


def navigation_phase(card, device, counted):
    """The navigation stack (phase 21): (a) DWA and the demos, (b) mapping,
    (c) grid search."""
    out = {"card": card}
    start = time.perf_counter()
    for name, part in (("dwa", nav_dwa_part), ("mapping", map_mapping_part),
                       ("grid_search", grid_search_part)):
        t0 = time.perf_counter()
        out[name] = part(card, device, counted)
        out[name]["part_s"] = time.perf_counter() - t0
        print(f"navigation stack, part {name}: {out[name]['part_s']!r} s")
    out["phase_s"] = time.perf_counter() - start
    out["kernel_launches"] = dict(NAV_KERNEL_LAUNCHES)
    print(f"navigation stack: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']}")
    return out


# Planning II (phase 22): the A* variants and the MovingAI loader (host),
# the any-angle planners, fields, frontier exploration, the risk graph,
# coverage, road maps, and the temporal, conformal and STL planners. B2 lies
# on the fields, coverage and frontier parts: every `wavefront_costs` call
# there is counted (`count_wavefront_calls`) and must be one
# `wavefront_relax` launch; every other kernel entry launches 0 times in
# every part. Each part runs under sync debug mode "warn" (its device reads)
# and on the host clock; a part whose run holds few launches also runs under
# the profiler (launches, idle share), and a launch-heavy loop is profiled on
# one short call of it. Sizes are those their users run; each part is held
# to the CPU in f64 at the reduced size in brackets, within P2_ATOL for
# fields and exactly for masks, paths, cells and counts (the fields and
# paths of the B2 parts bitwise, in f32 and f64).
P2_ATOL = 1e-12
P2_MAZE_QUERY = (5.0, 5.0, 35.0, 45.0)  # tests/test_a_star_variants_golden.py:91
P2_MOVING_AI, P2_SCENARIOS = 512, 1000  # an octile map of 512² and its scenarios
P2_VIS, P2_VIS_ROOMS, P2_VIS_B, P2_VIS_CPU = 256, 4, 64, (48, 8)  # room map, 64 queries
P2_THETA, P2_THETA_CPU = 128, 24
P2_FLOW, P2_FLOW_F64_MAPS = (GRID_B, GRID_W, GRID_H), 8  # bench.py's grid shape
P2_POTENTIAL, P2_POTENTIAL_CPU = 1024, 128
P2_FRONTIER, P2_FRONTIER_CPU = 128, 32
P2_TERRAIN, P2_TERRAIN_CPU = 1024, 128
P2_SWEEP, P2_SWEEP_CPU = (16, 256), (4, 32)  # risk weights x map side
P2_CPP, P2_CPP_CPU, P2_STC = 128, 24, 64
P2_PRM, P2_PRM_CPU = (1000, 64), (150, 16)  # samples, obstacles
P2_VORONOI, P2_VORONOI_CPU = 512, 64
P2_TEMPORAL, P2_TEMPORAL_CPU = (256, 256), (32, 24)  # T, map side
P2_MAPF, P2_MAPF_CPU = (8, 64, 128), (4, 16, 32)  # agents, map side, T
P2_KERNEL_LAUNCHES = {}


def p2_part(label, fn, counted, profiled=True, b2=False):
    """`nav_part` with phase 22's launch totals."""
    return nav_part(label, fn, counted, profiled, b2, P2_KERNEL_LAUNCHES)


def one_profile(label, fn):
    """A launch-heavy loop profiled on one short call of it."""
    stats = profile_once(label, fn)
    print(f"{label}: device busy {stats['busy_ms']!r} ms, {stats['launches']} launches, "
          f"{stats['idle']:.3f} idle")
    return stats


def maze_points():
    """The 50x50 wall maze of a_star_variants.rs tests (:835-:860), as
    tests/test_a_star_variants_golden.py builds it."""
    ox, oy = [], []

    def wall(x0, y0, wx, wy):
        for x in range(x0, x0 + wx):
            for y in range(y0, y0 + wy):
                ox.append(float(x))
                oy.append(float(y))

    for x, y, n in ((0, 0, 50), (48, 0, 50)):
        wall(x, y, 2, n)
    for x, y, n in ((0, 0, 50), (0, 48, 50)):
        wall(x, y, n, 2)
    for x, y, n in zip([10, 10, 10, 15, 20, 20, 30, 30, 35, 30, 40, 45],
                       [10, 30, 45, 20, 5, 40, 10, 40, 5, 40, 10, 25],
                       [10, 10, 5, 10, 10, 5, 20, 10, 25, 10, 35, 15]):
        wall(x, y, 2, n)
    for x, y, n in zip([35, 40, 15, 10, 45, 20, 10, 15, 25, 45, 10, 30, 10, 40],
                       [5, 10, 15, 20, 20, 25, 30, 35, 35, 35, 40, 40, 45, 45],
                       [10, 5, 10, 10, 5, 5, 10, 5, 10, 5, 10, 5, 5, 5]):
        wall(x, y, n, 2)
    return ox, oy


def room_map(n, rooms, rng):
    """n x n free raster split into rooms x rooms by one-cell walls, each
    wall with a door of 2-5 cells at a random place."""
    free = np.ones((n, n), bool)
    step = n // rooms
    for k in range(1, rooms):
        free[k * step, :] = False
        free[:, k * step] = False
    for k in range(1, rooms):
        for r in range(rooms):
            lo = r * step + 1
            for axis in (0, 1):
                d = int(rng.integers(lo, lo + step - 6))
                w = int(rng.integers(2, 6))
                if axis == 0:
                    free[k * step, d:d + w] = True
                else:
                    free[d:d + w, k * step] = True
    return free


def rect_world(n, rects, rng, max_side=None):
    """n x n free raster with `rects` random blocked rectangles (the worlds
    of tests/test_any_angle.py, scaled); the corners stay free."""
    max_side = max_side or max(3, n // 8)
    free = np.ones((n, n), bool)
    for _ in range(rects):
        x0, y0 = rng.integers(1, n - 2, 2)
        dw, dh = rng.integers(1, max_side, 2)
        free[x0:x0 + dw, y0:y0 + dh] = False
    free[:2, :2] = free[-2:, -2:] = True
    return free


def free_cells(free, count, rng):
    cells = np.argwhere(free)
    return cells[rng.choice(len(cells), count, replace=False)]


def p2_host_part(card, device, counted):
    """(a) the A* variants on the maze, every mode, and the MovingAI parser
    on a generated 512² map and its scenarios: host only."""
    out = {}
    ox, oy = maze_points()
    lengths = {}
    for mode in pav.MODES:
        path, stats = p2_part(f"A* {mode} on the 50x50 maze (host)", lambda mode=mode:
                              pav.AStarVariantPlanner(ox, oy, pav.AStarVariantConfig(mode=mode))
                              .plan(*P2_MAZE_QUERY), counted, profiled=False)
        lengths[mode] = pav.path_length(path)
        out[mode] = {**stats, "waypoints": len(path), "length": lengths[mode]}
        _gate(f"A* {mode} endpoints", np.array_equal(path[[0, -1]], [[5.0, 5.0], [35.0, 45.0]]),
              f"{len(path)} waypoints, length {lengths[mode]!r}")
    _gate("A* standard no longer than beam and dynamic weighting",
          lengths["standard"] <= min(lengths["beam"], lengths["dynamic_weighting"]) + 1e-9,
          f"{lengths}")

    rng = np.random.default_rng(SEED + 220)
    n = P2_MOVING_AI
    tiles = np.where(rng.random((n, n)) < 0.25, "@", ".")
    tiles[rng.random((n, n)) < 0.02] = "T"
    text = "type octile\nheight %d\nwidth %d\nmap\n" % (n, n) + "\n".join(
        "".join(row) for row in tiles) + "\n"
    cells = np.argwhere(tiles.T != "@")[rng.choice(int((tiles != "@").sum()), 2 * P2_SCENARIOS)]
    scen = "version 1\n" + "".join(
        f"{i % 10}\tgen.map\t{n}\t{n}\t{a[0]}\t{a[1]}\t{b[0]}\t{b[1]}\t{rng.uniform(1, 700):.8f}\n"
        for i, (a, b) in enumerate(zip(cells[::2], cells[1::2])))
    parsed, stats = p2_part(f"MovingAI parse {n}² + {P2_SCENARIOS} scenarios (host)",
                            lambda: (pmai.parse_map(text), pmai.parse_scenarios(scen)), counted,
                            profiled=False)
    grid = parsed[0].to_grid(device=device)
    want = np.ones((n + 1, n + 1), bool)
    want[1:, 1:] = (tiles != ".").T  # "@" and "T" are not passable
    _gate(f"MovingAI {n}² raster on {card}", np.array_equal(grid.blocked.cpu().numpy(), want)
          and len(parsed[1]) == P2_SCENARIOS and parsed[1][5].start_x == cells[10][0],
          f"{int(want.sum())} blocked cells, {len(parsed[1])} scenarios")
    out["moving_ai"] = {**stats, "cells": n * n, "scenarios": len(parsed[1])}
    return out


def p2_any_angle_part(card, device, counted):
    """(b) `VisibilityPlanner` on a 256² room map with 64 queries, and the
    Theta* wavefront on 128², f32; each held to the CPU in f64."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 221)
    free = room_map(P2_VIS, P2_VIS_ROOMS, rng)
    ends = free_cells(free, 2 * P2_VIS_B, rng)
    starts, goals = ends[::2], ends[1::2]

    def visibility():
        planner = pany.VisibilityPlanner(free, device=device, dtype=f32)
        return planner, planner.lengths(starts, goals)

    (planner, lengths), stats = p2_part(
        f"VisibilityPlanner {P2_VIS}² rooms, {P2_VIS_B} queries f32 on {card}", visibility,
        counted)
    straight = np.linalg.norm((goals - starts).astype(float), axis=1)
    lengths = lengths.cpu().numpy()
    _gate(f"visibility lengths {P2_VIS}²", np.isfinite(lengths).all()
          and (lengths >= straight * (1 - 1e-5)).all(),
          f"{planner.corners.shape[0]} corners; lengths {lengths.min()!r}..{lengths.max()!r}")
    out["visibility"] = {**stats, "corners": int(planner.corners.shape[0]),
                         "queries": P2_VIS_B, "mean_length": float(lengths.mean())}

    n, b = P2_VIS_CPU
    small = room_map(n, 3, rng)
    ends = free_cells(small, 2 * b, rng)
    got, want = (pany.VisibilityPlanner(small, device=d, dtype=f64) for d in (device, "cpu"))
    lg, lw = got.lengths(ends[::2], ends[1::2]), want.lengths(ends[::2], ends[1::2])
    pg, pw = got.path(ends[0], ends[1]), want.path(ends[0], ends[1])
    _gate(f"VisibilityPlanner {n}² f64 cuda = CPU",
          torch.equal(got.corners.cpu(), want.corners) and torch.equal(got.vis.cpu(), want.vis)
          and _diff(lg, lw) <= P2_ATOL and (pg is None) == (pw is None)
          and (pg is None or np.array_equal(pg, pw)),
          f"max|diff| {_diff(lg, lw)!r}")

    free = room_map(P2_THETA, 2, rng)
    goal = tuple(free_cells(free, 1, rng)[0])
    (g, parent), stats = p2_part(f"theta_wavefront_costs {P2_THETA}² f32 on {card}",
                                 lambda: pany.theta_wavefront_costs(free, goal, device=device,
                                                                    dtype=f32),
                                 counted, profiled=False)
    stats["one_block"] = one_profile(
        f"theta_wavefront_costs {P2_THETA}², one block of 4 sweeps",
        lambda: pany.theta_wavefront_costs(free, goal, iters=4, device=device, dtype=f32))
    octile = wavefront_costs(torch.tensor(free, device=device),
                             torch.tensor(goal_raster_np(free.shape, goal), device=device))
    reach = torch.isfinite(octile)
    _gate(f"theta {P2_THETA}² <= octile wavefront", torch.equal(torch.isfinite(g), reach)
          and bool((g[reach] <= octile[reach] + 1e-3).all()),
          f"{int(reach.sum())} reachable cells")
    out["theta"] = {**stats, "reachable": int(reach.sum()), "mean_cost": float(g[reach].mean())}
    small = room_map(P2_THETA_CPU, 2, rng)
    sg = tuple(free_cells(small, 1, rng)[0])
    (gg, pg), (gw, pw) = (pany.theta_wavefront_costs(small, sg, device=d, dtype=f64)
                          for d in (device, "cpu"))
    _gate(f"theta {P2_THETA_CPU}² f64 cuda = CPU",
          _diff(gg, gw) <= P2_ATOL and torch.equal(pg.cpu(), pw), f"max|diff| {_diff(gg, gw)!r}")
    return out


def p2_fields_part(card, device, counted):
    """(c) `flow_field` on bench.py's 64 maps of 128² (B2, bitwise the CPU's
    in f32 and f64) and `potential_field` on 1024²."""
    out = {}
    rng = np.random.default_rng(SEED + 222)
    b, w, h = P2_FLOW
    free_np = rng.random((b, w, h)) > 0.2
    free_np[:, 0, 0] = free_np[:, -1, -1] = True
    goals_np = np.zeros_like(free_np)
    goals_np[:, -1, -1] = True
    free_d, goals_d = torch.tensor(free_np, device=device), torch.tensor(goals_np, device=device)
    field, stats = p2_part(f"flow_field {b} x {w}x{h} f32 on {card}",
                           lambda: pfields.flow_field(free_d, goals_d), counted, b2=True)
    want = pfields.flow_field(free_np, goals_np, device="cpu")
    k = P2_FLOW_F64_MAPS
    got64 = pfields.flow_field(free_d[:k], goals_d[:k], dtype=torch.float64)
    want64 = pfields.flow_field(free_np[:k], goals_np[:k], device="cpu", dtype=torch.float64)
    _gate(f"flow_field {b} x {w}x{h} f32 and {k} maps f64 bitwise the CPU's",
          bitwise_equal(field.cpu(), want) and bitwise_equal(got64.cpu(), want64),
          f"{int(torch.isfinite(field).sum())} reachable cells")
    out["flow_field"] = stats

    n = P2_POTENTIAL
    blocked = ~rect_world(n, 60, rng, max_side=64)
    goal = tuple(free_cells(~blocked, 1, rng)[0])
    pot, stats = p2_part(f"potential_field {n}² f32 on {card}",
                         lambda: pfields.potential_field(~blocked, goal, device=device), counted)
    cells, valid = pfields.boustrophedon_sweep(~blocked, device=device)
    ratio = float(pfields.coverage_ratio(torch.zeros(n, n, dtype=torch.bool, device=device)
                                         .index_put_((cells[valid][:, 0], cells[valid][:, 1]),
                                                     torch.ones((), dtype=torch.bool,
                                                                device=device)), ~blocked))
    _gate(f"potential_field {n}² finite, boustrophedon covers",
          bool(torch.isfinite(pot).all()) and ratio == 1.0, f"coverage ratio {ratio!r}")
    out["potential_field"] = stats
    m = P2_POTENTIAL_CPU
    small = ~rect_world(m, 30, rng)
    got, want = (pfields.potential_field(~small, (m - 2, 3), device=d, dtype=torch.float64)
                 for d in (device, "cpu"))
    _gate(f"potential_field {m}² f64 cuda = CPU", _diff(got, want) <= P2_ATOL,
          f"max|diff| {_diff(got, want)!r}")
    return out


def gap_world(n, rng):
    """n x n truth raster: small random blocks, then walls across the map
    every n/4 rows, each with two gaps of four cells cleared three rows
    deep; start (1, 1) and goal (n - 2, n - 2) free."""
    blocked = np.zeros((n, n), bool)
    for _ in range(n // 4):
        x, y = rng.integers(1, n - 4, 2)
        w, h = rng.integers(1, 4, 2)
        blocked[x:x + w, y:y + h] = True
    for k in range(n // 4, n, n // 4):
        blocked[k, :] = True
        for gap in rng.choice(n - 6, 2, replace=False) + 1:
            blocked[k - 3:k + 4, gap:gap + 4] = False
    blocked[:3, :3] = blocked[-3:, -3:] = False
    return blocked


def p2_frontier_part(card, device, counted):
    """(d) `frontier_navigate` on a 128² occluded world (B2, up to two calls
    an episode), f32; the 32² world's trajectory on cuda = CPU in f32 and
    f64."""
    rng = np.random.default_rng(SEED + 223)
    n = P2_FRONTIER
    truth = gap_world(n, rng)
    start, goal = (1, 1), (n - 2, n - 2)
    cfg = pfrontier.FrontierNavConfig(max_episodes=400)
    res, stats = p2_part(f"frontier_navigate {n}² f32 on {card}",
                         lambda: pfrontier.frontier_navigate(truth, start, goal, cfg,
                                                             device=device),
                         counted, profiled=False, b2=True)
    stats["one_episode"] = one_profile(
        f"frontier_navigate {n}², one episode",
        lambda: pfrontier.frontier_navigate(truth, start, goal,
                                            pfrontier.FrontierNavConfig(max_episodes=1),
                                            device=device))
    _gate(f"frontier_navigate {n}² reaches the goal", res["reached"]
          and not truth[res["trajectory"][:, 0], res["trajectory"][:, 1]].any(),
          f"{res['episodes']} episodes, {len(res['trajectory'])} cells, revealed "
          f"{res['revealed_fraction']!r}")
    m = P2_FRONTIER_CPU
    small = gap_world(m, rng)
    for dtype in (torch.float32, torch.float64):
        got, want = (pfrontier.frontier_navigate(small, (1, 1), (m - 2, m - 2), device=d,
                                                 dtype=dtype) for d in (device, "cpu"))
        _gate(f"frontier_navigate {m}² {dtype} cuda = CPU",
              np.array_equal(got["trajectory"], want["trajectory"])
              and got["episodes"] == want["episodes"]
              and np.array_equal(got["frontiers_chosen"], want["frontiers_chosen"]),
              f"{got['episodes']} episodes, reached {got['reached']}")
    return {**stats, "episodes": res["episodes"], "trajectory_cells": len(res["trajectory"]),
            "revealed_fraction": res["revealed_fraction"],
            "frontiers_chosen": len(res["frontiers_chosen"])}


def elevation(n, rng):
    """A smooth random terrain with a cliff, n x n."""
    z = ndimage.gaussian_filter(rng.normal(size=(n, n)), n / 32) * n / 16
    z[n // 3:, n // 2] += 3.0
    return z


def p2_risk_part(card, device, counted):
    """(e) terrain risk from a 1024² elevation (slope, roughness, smoothing,
    exposure) and `sweep_risk_weights` over 16 weights on 256², f32."""
    out = {}
    rng = np.random.default_rng(SEED + 224)

    def terrain(z, dev, dtype):
        risk = prisk.terrain_risk_from_elevation(z, blocking_step_height=1.0, device=dev,
                                                 dtype=dtype)
        return prisk.add_clearance_exposure_risk(prisk.smooth_terrain_risk(risk))

    z = elevation(P2_TERRAIN, rng)
    risk, stats = p2_part(f"terrain risk {P2_TERRAIN}² f32 on {card}",
                          lambda: terrain(z, device, torch.float32), counted)
    out["terrain"] = {**stats, "blocked": int(risk.blocked.sum())}
    zs = elevation(P2_TERRAIN_CPU, rng)
    got, want = (terrain(zs, d, torch.float64) for d in (device, "cpu"))
    err = max(_diff(getattr(got, k), getattr(want, k))
              for k in ("traversability", "stability", "exposure"))
    _gate(f"terrain risk {P2_TERRAIN_CPU}² f64 cuda = CPU",
          err <= P2_ATOL and torch.equal(got.blocked.cpu(), want.blocked), f"max|diff| {err!r}")

    def sweep(k, n, dev, dtype):
        r = terrain(elevation(n, np.random.default_rng(SEED + 225)), dev, dtype)
        blocked = r.blocked.clone()
        blocked[:2, :2] = blocked[-2:, -2:] = False
        r = prisk.RiskChannels(blocked, r.traversability, r.stability, r.exposure)
        weights = [0.25 * i for i in range(k)]
        return prisk.sweep_risk_weights(r, (0, 0), (n - 1, n - 1), weights)

    k, n = P2_SWEEP
    res, stats = p2_part(f"sweep_risk_weights {k} weights x {n}² f32 on {card}",
                         lambda: sweep(k, n, device, torch.float32), counted, profiled=False)
    costs = [float(r["cost"]) for r in res]
    reached = [bool(r["path_mask"].any()) and tuple(r["path_idx"][r["path_mask"]][-1].tolist())
               == (n - 1, n - 1) for r in res]
    _gate(f"sweep_risk_weights {k} x {n}²: costs rise with the weight, paths reach the goal",
          all(a <= b * (1 + 1e-6) for a, b in zip(costs, costs[1:])) and all(reached),
          f"costs {costs[0]!r}..{costs[-1]!r}")
    out["sweep"] = {**stats, "weights": k, "costs": costs}
    k, n = P2_SWEEP_CPU
    got, want = (sweep(k, n, d, torch.float64) for d in (device, "cpu"))
    ok = all(_diff(g["cost"], w["cost"]) <= P2_ATOL and torch.equal(g["path_idx"].cpu(),
                                                                    w["path_idx"])
             for g, w in zip(got, want))
    _gate(f"sweep_risk_weights {k} x {n}² f64 cuda = CPU", ok, "costs and paths")
    return out


def p2_coverage_part(card, device, counted):
    """(f) `wavefront_cpp` on 128² (B2 for the transform, the walk on the
    host), Spiral-STC and the spiral on 64²."""
    out = {}
    rng = np.random.default_rng(SEED + 226)
    n = P2_CPP
    blocked = ~rect_world(n, 40, rng)
    (path, covered), stats = p2_part(
        f"wavefront_cpp {n}² f32 on {card}",
        lambda: pcoverage.wavefront_cpp(blocked, (0, 0), (n - 1, n - 1), device=device),
        counted, profiled=False, b2=True)
    t = pcoverage.coverage_transform(blocked, (n - 1, n - 1), pcoverage.WavefrontCppConfig(),
                                     device=device)
    reach = int(torch.isfinite(t).sum())
    metrics = pcoverage.coverage_metrics(path, blocked)
    # the walk ends at the goal, which it may reach with cells left over
    _gate(f"wavefront_cpp {n}² walks free cells from start to goal",
          tuple(path[0]) == (0, 0) and tuple(path[-1]) == (n - 1, n - 1)
          and not blocked[path[:, 0], path[:, 1]].any() and covered <= reach,
          f"{covered} of {reach} reachable cells, {metrics}")
    out["wavefront_cpp"] = {**stats, **metrics, "covered": covered, "reachable": reach}
    m = P2_CPP_CPU
    small = ~rect_world(m, 6, rng)
    for cfg in (dict(), dict(distance_type="euclidean"), dict(transform_type="path", alpha=0.5)):
        c = pcoverage.WavefrontCppConfig(**cfg)
        for dtype in (torch.float32, torch.float64):
            (pg, _), (pw, _) = (pcoverage.wavefront_cpp(small, (0, 0), (m - 1, m - 1), c,
                                                        device=d, dtype=dtype)
                                for d in (device, "cpu"))
            tg, tw = (pcoverage.coverage_transform(small, (m - 1, m - 1), c, device=d,
                                                   dtype=dtype) for d in (device, "cpu"))
            _gate(f"wavefront_cpp {m}² {cfg or 'chessboard'} {dtype} cuda = CPU",
                  np.array_equal(pg, pw) and bitwise_equal(tg.cpu(), tw), f"{len(pg)} cells")
    free = rect_world(P2_STC, 12, rng, max_side=4)
    stc, stats = p2_part(f"spiral_stc_plan {P2_STC}² (host)",
                         lambda: pcoverage.spiral_stc_plan(free, (0, 0)), counted, profiled=False)
    out["spiral_stc"] = {**stats, "route": len(stc["route"]), "segments": len(stc["path_segments"])}
    spiral = pcoverage.spiral_coverage(~free, (0, 0))
    out["spiral_cells"] = len(spiral)
    return out


def prm_world(m, rng, size=50.0):
    obstacles = rng.uniform(3.0, size - 3.0, (m, 2))
    radii = rng.uniform(0.8, 2.0, m)
    return obstacles, radii


def p2_roadmap_part(card, device, counted):
    """(g) PRM with 1000 samples among 64 obstacles, the Voronoi road map on
    512², f32; each = the CPU in f64 at a reduced size."""
    out = {}
    rng = np.random.default_rng(SEED + 227)
    s, m = P2_PRM
    obstacles, radii = prm_world(m, rng)
    kw = dict(num_samples=s, connect_radius=4.0, area_min=(0.0, 0.0), area_max=(50.0, 50.0))
    gen = torch.Generator(device=device)

    def prm():
        gen.manual_seed(SEED)
        return proad.prm_plan(gen, [1.0, 1.0], [49.0, 49.0], obstacles, radii, device=device,
                              **kw)

    (pts, mask, cost), stats = p2_part(f"prm_plan {s} samples, {m} obstacles f32 on {card}", prm,
                                       counted)
    path = pts[mask].double().cpu().numpy()
    t = np.linspace(0.0, 1.0, 64)[:, None, None]
    seg = path[:-1] + t * (path[1:] - path[:-1])
    clear = (np.linalg.norm(seg[..., None, :] - obstacles, axis=-1) > radii - 1e-4).all()
    _gate(f"prm_plan {s} samples", float(cost) < 1e17 and clear and len(path) >= 2,
          f"cost {float(cost)!r}, {len(path)} waypoints")
    out["prm"] = {**stats, "cost": float(cost), "waypoints": len(path)}
    s, m = P2_PRM_CPU
    obstacles, radii = prm_world(m, rng, 20.0)
    draws = rng.random((s, 2))
    small = dict(num_samples=s, connect_radius=3.0, area_min=(0.0, 0.0), area_max=(20.0, 20.0),
                 draws=draws, dtype=torch.float64)
    got, want = (proad.prm_plan(None, [1.0, 1.0], [19.0, 19.0], obstacles, radii, device=d,
                                **small) for d in (device, "cpu"))
    _gate(f"prm_plan {s} samples f64 cuda = CPU", torch.equal(got[1].cpu(), want[1])
          and _diff(got[0], want[0]) <= P2_ATOL and _diff(got[2], want[2]) <= P2_ATOL,
          f"cost {float(got[2])!r} vs {float(want[2])!r}")

    def corridors(n):
        blocked = np.zeros((n, n), bool)
        blocked[:, :3] = blocked[:, -3:] = True
        blocked[n // 4:n // 2, n // 3:n // 2] = True
        blocked[2 * n // 3:, n // 2:2 * n // 3] = True
        return blocked

    n = P2_VORONOI
    res = 0.05
    (verts, weights), stats = p2_part(
        f"voronoi_roadmap {n}² f32 on {card}",
        lambda: proad.voronoi_roadmap([0.2, 0.5 * n * res], [(n - 4) * res, 0.5 * n * res],
                                      corridors(n), 0.0, 0.0, res, device=device), counted)
    edges = int(((weights < 1e17) & (weights > 0)).sum()) // 2
    _gate(f"voronoi_roadmap {n}² symmetric", torch.equal(weights, weights.T) and edges > 0,
          f"{verts.shape[0]} vertices, {edges} edges")
    out["voronoi"] = {**stats, "vertices": int(verts.shape[0]), "edges": edges}
    n = P2_VORONOI_CPU
    got, want = (proad.voronoi_roadmap([0.3, 3.2], [6.0, 3.2], corridors(n), -0.1, 0.0, 0.1,
                                       device=d, dtype=torch.float64) for d in (device, "cpu"))
    _gate(f"voronoi_roadmap {n}² at 0.1 m f64 cuda = CPU",
          bitwise_equal(got[0].cpu(), want[0]) and bitwise_equal(got[1].cpu(), want[1]),
          f"max|diff| {_diff(got[0], want[0])!r}")
    return out


def mapf_world(n, agents, rng):
    """n x n raster with small random blocks; agent i starts on the left
    edge and crosses to the right edge, to the next agent's lane (the last
    to the first), so that one path crosses all the others."""
    free = rect_world(n, n // 6, rng, max_side=3)
    gap = (n - 4) // agents
    starts = [(1, 2 + gap * i) for i in range(agents)]
    goals = [(n - 2, 2 + gap * ((i + 1) % agents) + gap // 2) for i in range(agents)]
    for x, y in starts + goals:
        free[x, y] = True
    return free, starts, goals


def p2_temporal_part(card, device, counted):
    """(h) `time_expanded_costs` on T=256 x 256² with 8 moving obstacles,
    and `prioritized_multi_agent`, `conformal_sipp_plan` (8 predicted
    obstacles) and `stl_cbs_plan` with 8 agents on 64², T=128, f32."""
    out = {}
    rng = np.random.default_rng(SEED + 228)

    def moving(t_max, n, dev, dtype):
        free = rect_world(n, n // 8, rng)
        trajs = np.cumsum(rng.integers(-1, 2, (8, t_max, 2)), axis=1) + rng.integers(0, n, (8, 1, 2))
        mask = ptemporal.moving_obstacle_mask(free, np.clip(trajs, 0, n - 1), t_max, radius=1,
                                              device=dev)
        goal = (3 * n // 4, n // 4)
        mask[0, 0, 0] = True
        mask[:, goal[0], goal[1]] = True
        costs = ptemporal.time_expanded_costs(mask, (0, 0), dtype=dtype)
        return costs, ptemporal.earliest_arrival(costs, goal)

    t_max, n = P2_TEMPORAL
    (costs, (t_arr, cost)), stats = p2_part(
        f"time_expanded_costs T={t_max} x {n}² f32 on {card}",
        lambda: moving(t_max, n, device, torch.float32), counted, profiled=False)
    stats["one_step"] = one_profile(f"time_expanded_costs T=2 x {n}²",
                                    lambda: moving(2, n, device, torch.float32))
    out["time_expanded"] = {**stats, "arrival": int(t_arr), "cost": float(cost)}
    t_max, n = P2_TEMPORAL_CPU
    state = rng.bit_generator.state
    got = moving(t_max, n, device, torch.float64)
    rng.bit_generator.state = state
    want = moving(t_max, n, "cpu", torch.float64)
    _gate(f"time_expanded_costs T={t_max} x {n}² f64 cuda = CPU",
          _diff(got[0], want[0]) <= P2_ATOL and int(got[1][0]) == int(want[1][0]),
          f"arrival {int(got[1][0])}")

    def plans(agents, n, t_max, dev, dtype):
        w = np.random.default_rng(SEED + 229)
        free, starts, goals = mapf_world(n, agents, w)
        pma = ptemporal.prioritized_multi_agent(free, starts, goals, t_max, device=dev,
                                                dtype=dtype)
        # predicted obstacles sweep across the middle columns
        t = np.arange(t_max)
        pred = np.stack([np.stack([np.full(t_max, n * (0.3 + 0.05 * j)),
                                   (0.6 * t + n * j / agents) % n], -1) for j in range(agents)])
        errs = np.abs(w.normal(0.0, 0.4, (t_max, 32)))
        cp = pconformal.conformal_sipp_plan(~free, pred, errs, starts[0], goals[0],
                                            required_confidence=0.8, obstacle_radius=0.5,
                                            device=dev, dtype=dtype)
        region = pstl.StlRectangle(n * 0.4, n * 0.55, n * 0.4, n * 0.55)
        cbs = pstl.stl_cbs_plan(free, starts, goals, t_max, avoid_regions=((region, (0, t_max - 1)),),
                                reach_specs=((0, [goals[0][0] - 1.0, goals[0][0] + 1.0,
                                                  goals[0][1] - 1.0, goals[0][1] + 1.0],
                                              (0, t_max - 1)),), device=dev, dtype=dtype)
        return pma, cp, cbs

    agents, n, t_max = P2_MAPF
    (pma, cp, cbs), stats = p2_part(
        f"prioritized MAPF, CP-SIPP and STL-CBS, {agents} agents on {n}², T={t_max} f32 on {card}",
        lambda: plans(agents, n, t_max, device, torch.float32), counted, profiled=False)
    _gate(f"MAPF {agents} agents {n}²: every agent arrives, no conflict",
          (pma[1] >= 0).all() and (cbs["arrivals"] >= 0).all()
          and pstl.first_conflict(cbs["paths"]) is None and cp is not None
          and cp["min_confidence"] >= 0.8 - 1e-6,
          f"prioritized arrivals {pma[1].tolist()}, CBS {cbs['arrivals'].tolist()}, "
          f"{cbs['conflicts_resolved']} conflicts resolved, CP-SIPP arrival "
          f"{None if cp is None else cp['arrival']}")
    out["mapf"] = {**stats, "prioritized_arrivals": pma[1].tolist(),
                   "cbs_arrivals": cbs["arrivals"].tolist(),
                   "conflicts_resolved": cbs["conflicts_resolved"],
                   "cp_sipp_arrival": cp["arrival"]}
    agents, n, t_max = P2_MAPF_CPU
    got, want = (plans(agents, n, t_max, d, torch.float64) for d in (device, "cpu"))
    same = (np.array_equal(got[0][0], want[0][0]) and np.array_equal(got[0][1], want[0][1])
            and (got[1] is None) == (want[1] is None)
            and (got[1] is None or (np.array_equal(got[1]["path"], want[1]["path"])
                                    and _diff(got[1]["confidence_field"],
                                              want[1]["confidence_field"]) <= P2_ATOL))
            and np.array_equal(got[2]["paths"], want[2]["paths"])
            and got[2]["conflicts_resolved"] == want[2]["conflicts_resolved"]
            and abs(got[2]["min_pairwise_separation_robustness"]
                    - want[2]["min_pairwise_separation_robustness"]) <= P2_ATOL)
    _gate(f"MAPF {agents} agents {n}², T={t_max} f64 cuda = CPU", same, "paths and counts")
    return out


def planning_ii_phase(card, device, counted):
    """Planning II (phase 22): (a) host planners, (b) any-angle, (c) fields,
    (d) frontier, (e) risk, (f) coverage, (g) road maps, (h) temporal."""
    out = {"card": card}
    start = time.perf_counter()
    for name, part in (("host", p2_host_part), ("any_angle", p2_any_angle_part), ("fields", p2_fields_part),
                       ("frontier", p2_frontier_part), ("risk", p2_risk_part),
                       ("coverage", p2_coverage_part), ("roadmap", p2_roadmap_part),
                       ("temporal", p2_temporal_part)):
        t0 = time.perf_counter()
        out[name] = part(card, device, counted)
        out[name]["part_s"] = time.perf_counter() - t0
        print(f"planning II, part {name}: {out[name]['part_s']!r} s")
    out["phase_s"] = time.perf_counter() - start
    out["kernel_launches"] = dict(P2_KERNEL_LAUNCHES)
    print(f"planning II: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']}")
    return out


# phase 23: the control layer (control/: trackers, laws, CBF, ADMM, MPC,
# trajectory optimisation, C/GMRES, the rocket, the arm, MPPI and its
# variants, value grids, gate racing, the pusher-slider)
CTL_FLEET = 1024
CTL_LANES = (0, 511, 1023)
CTL_LANE_STEPS = 10  # steps (iterations) of a lane's solo run held to the fleet's
CTL_SMALL, CTL_SMALL_STEPS = 16, 10  # the f64 cuda = CPU runs
CTL_ATOL = 1e-9
CTL_TRACK_STEPS = 200  # bench_meta_control's loop on its 401-point path
CTL_LQR_STEPS = 100  # the LQR steer fleet: a DARE a vehicle a step
CTL_XTRACK_RMSE = 0.5  # tests/test_trackers.py's limit (0.4-0.5)
CTL_CBF_STEPS = 75  # of bench_cbf_safety_filter's 150; phase 27 runs the bench
CTL_ILQR_BATCH, CTL_ILQR_ITERATIONS = 256, 8
CTL_CGMRES_STEPS, CTL_CGMRES_CPU_STEPS = 5, 2
# bench_arm_rrt_star's (phase 27's registry runs the bench itself in f64; the
# defaults' 512 nodes were cut for its room)
CTL_RRT = ((192, dict(step_size=0.5, rewire_radius=1.2, edge_checks=6, path_len=32)),)
CTL_IK_ITERATIONS = 100
CTL_MPPI_FLEET = (1024, 1024, 30, 16)  # robots, samples, horizon, obstacles
CTL_RACE = dict(steps=120, horizon=18, num_samples=192)  # simulate_gate_race's defaults
CTL_PUSH_STEPS = 40  # bench_pusher_slider
# the kernel entries' launches summed over phase 23's parts
CTL_KERNEL_LAUNCHES = {}
CTL_WAVEFRONT_CALLS = [0]


def ctl_wavefront(free, goals, **kw):
    """`wavefront_costs`, counted: phase 23's one B2 call site (the
    value-guided MPPI's terminal-value grid)."""
    CTL_WAVEFRONT_CALLS[0] += 1
    return wavefront_costs(free, goals, **kw)


def ctl_part(label, fn, counted, short=None):
    """fn() once under sync debug mode "warn" on the host clock (its reads)
    and `short` (default fn) once under the profiler (launches, busy time,
    idle share), the kernel entries counted over both: B2 once per
    `ctl_wavefront` call, every other entry never. Returns (fn's result,
    the numbers)."""
    for k in counted:
        k.launches = 0
    CTL_WAVEFRONT_CALLS[0] = 0
    host_s, (out, reads) = timed(lambda: reads_in(fn))
    stats = {"host_s": host_s, "reads": reads, **profile_once(label, short or fn)}
    stats["kernel_launches"] = {k.__name__: k.launches for k in counted}
    stats["wavefront_costs_calls"] = CTL_WAVEFRONT_CALLS[0]
    for name, n in stats["kernel_launches"].items():
        CTL_KERNEL_LAUNCHES[name] = CTL_KERNEL_LAUNCHES.get(name, 0) + n
    print(f"{label}: {host_s!r} s host; {reads} device reads; profiled call: device busy "
          f"{stats['busy_ms']!r} ms, {stats['launches']} launches, {stats['idle']:.3f} idle; "
          f"kernel entries {stats['kernel_launches']}")
    others = {n: v for n, v in stats["kernel_launches"].items() if n != "wavefront_relax" and v}
    if others or stats["kernel_launches"]["wavefront_relax"] != CTL_WAVEFRONT_CALLS[0]:
        fail(f"{label}: kernel entries {stats['kernel_launches']} for {CTL_WAVEFRONT_CALLS[0]} "
             f"wavefront_costs calls")
    return out, stats


def ctl_same(label, got, want, atol=CTL_ATOL):
    """Floats within atol, anything else exactly; gated."""
    if not torch.as_tensor(want).is_floating_point():
        ok = torch.equal(torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu())
        _gate(label, ok, "equal" if ok else f"{got} != {want}")
        return 0.0
    d = _diff(got, want)
    _gate(label, d <= atol, f"max|diff| {d!r} (<= {atol})")
    return d


def ctl_lanes(label, fleet, solo, lanes=CTL_LANES):
    """Lane i of `fleet` (a tensor, or a tuple of tensors held to the tuple
    `solo(i)` returns) bitwise `solo(i)`, for each lane."""
    def pairs(i):
        return zip(fleet, solo(i)) if isinstance(fleet, tuple) else ((fleet, solo(i)),)

    ok = all(bitwise_equal(f[i], s) for i in lanes for f, s in pairs(i))
    _gate(f"{label}: lanes {lanes} bitwise their solo runs", ok, "bitwise" if ok else "differ")
    return ok


def ctl_course(device, dtype):
    """bench_meta_control's path: 401 points of y = 2 sin(x/8), 0 <= x <= 40."""
    xs = np.linspace(0.0, 40.0, 401)
    pts = np.stack([xs, 2.0 * np.sin(xs / 8.0)], -1)
    return (torch.tensor(pts, dtype=dtype, device=device),
            torch.ones(401, dtype=dtype, device=device))


CTL_TRACKERS = {
    "pure_pursuit": ctrack.pure_pursuit_control,
    "stanley": ctrack.stanley_control,
    "rear_wheel_feedback": ctrack.rear_wheel_feedback_control,
    "lqr_steer": None,
}


def ctl_track(law, state, pts, mask, steps):
    """`steps` closed-loop steps of `law` at 3 m/s (dt 0.1, wheelbase 2.9)
    from state [..., 4]: (states [steps+1, ..., 4], the last step's target
    index, or the LQR's lateral error)."""
    e = th = torch.zeros_like(state[..., 0])
    traj, last = [state], None
    for _ in range(steps):
        if law == "lqr_steer":
            accel, steer, (e, th) = ctrack.lqr_steer_control(
                state, pts, mask, 3.0, e, th, ctrack.LQRSteerConfig(wheelbase=2.9))
            last = e
        else:
            accel, steer, last = CTL_TRACKERS[law](state, pts, mask, 3.0)
        state = ctrack.bicycle_kinematics(state, accel, steer, 0.1, 2.9)
        traj.append(state)
    return torch.stack(traj), last


def ctl_xtrack_rmse(traj):
    """Each vehicle's cross-track RMSE to y = 2 sin(x/8) over 5 < x < 38."""
    t = traj.double().cpu().numpy()
    err = t[..., 1] - 2.0 * np.sin(t[..., 0] / 8.0)
    sel = (t[..., 0] > 5.0) & (t[..., 0] < 38.0)
    return np.sqrt((err ** 2 * sel).sum(0) / np.maximum(sel.sum(0), 1))


def ctl_nonlinear(state, steps):
    """tests/test_control_families.py's three loops over lanes: sliding
    mode on a double integrator (dt 0.01), feedback linearization on a
    unit circle and backstepping along the x axis (dt 0.02). state: (x,
    xd, pose_fl, pose_bs). Returns the end states and the feedback
    linearization's summed error over k > 700 (per lane)."""
    x, xd, pose_fl, pose_bs = state
    s_steps, f_steps, b_steps = steps
    for _ in range(s_steps):
        u, _ = cnl.sliding_mode_control(x, xd)
        xd = xd + u * 0.01
        x = x + xd * 0.01

    def unicycle(pose, v, w, dt=0.02):
        return torch.stack([pose[..., 0] + v * torch.cos(pose[..., 2]) * dt,
                            pose[..., 1] + v * torch.sin(pose[..., 2]) * dt,
                            pose[..., 2] + w * dt], -1)

    err = torch.zeros_like(x)
    for k in range(f_steps):
        t = torch.full_like(x, k * 0.02)
        target = torch.stack([torch.cos(t), torch.sin(t)], -1)
        tvel = torch.stack([-torch.sin(t), torch.cos(t)], -1)
        pose_fl = unicycle(pose_fl, *cnl.feedback_linearization_control(pose_fl, target, tvel))
        if k > 700:
            err = err + torch.sqrt(torch.sum((pose_fl[..., :2] - target) ** 2, -1))
    for k in range(b_steps):
        ref = torch.stack([torch.full_like(x, k * 0.02), torch.zeros_like(x),
                           torch.zeros_like(x)], -1)
        pose_bs = unicycle(pose_bs, *cnl.backstepping_control(pose_bs, ref, 1.0, 0.0))
    return x, xd, pose_fl, pose_bs, err


def ctl_cbf(pos, steps):
    """bench_cbf_safety_filter's loop over robots pos [..., 2]: (the end
    positions, each robot's least barrier value)."""
    cfg = cbf.CBFConfig(alpha=2.0)
    obstacles = torch.tensor([[2.0, 0.0]], dtype=pos.dtype, device=pos.device)
    radii = torch.ones(1, dtype=pos.dtype, device=pos.device)
    u_des = torch.tensor([1.5, 0.0], dtype=pos.dtype, device=pos.device)
    min_h = torch.full_like(pos[..., 0], math.inf)
    for _ in range(steps):
        pos = pos + 0.05 * cbf.cbf_filter_single_integrator(pos, u_des, obstacles, radii, cfg)
        min_h = torch.minimum(min_h, torch.sum((pos - obstacles[0]) ** 2, -1) - 1.0)
    return pos, min_h


def ctl_admm(device, dtype):
    """bench_admm_formation, bench_admm_graph_consensus and
    bench_admm_horizon_consensus on `device`."""
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    offsets = t([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    positions = t([[5.8, 2.1], [4.1, 2.0], [5.1, 2.9], [4.9, 1.2]])
    out = {"formation": cadmm.solve_formation_consensus(positions, offsets,
                                                        cfg=cadmm.ADMMConfig(iterations=200))}
    for n in (3, 8):
        xs = np.linspace(0.0, 4.0, n)
        targets = t(np.stack([xs, np.sin(np.linspace(0.0, 3.0, n))], -1))
        out[f"consensus_{n}"] = (targets, cadmm.solve_consensus(
            targets, cfg=cadmm.ADMMConfig(iterations=300)))
    cycles, horizon, dx, corner, amp = 34, 10, 0.18, 18, 0.25

    def goal(step):
        return np.array([min(step, corner) * dx, max(step - corner, 0) * dx])

    for weight in (0.0, 40.0):
        center = t(goal(0))
        path = [center]
        for c in range(cycles):
            goals = np.stack([goal(c + k) for k in range(horizon)])
            trajs = np.stack([goals + np.stack([[amp * np.sin(2.1 * a + 0.7 * (c + k)),
                                                 amp * np.cos(1.3 * a + 0.9 * (c + k))]
                                                for k in range(horizon)]) for a in range(4)])
            z, _ = cadmm.solve_horizon_consensus(t(trajs), center, smooth_weight=weight,
                                                 cfg=cadmm.ADMMConfig(iterations=120))
            center = z[1]
            path.append(center)
        path = torch.stack(path)
        accel = path[2:] - 2 * path[1:-1] + path[:-2]
        out[f"horizon_{weight:g}"] = (path, torch.sqrt(torch.mean(torch.sum(accel ** 2, -1))))
    return out


def ctl_trackers_part(card, device, counted):
    """(a) the trackers over a fleet on bench_meta_control's path, the
    nonlinear laws, the CBF filter, ADMM."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 231)
    # around tests/test_trackers.py's starts: up to 1 m off the path, 0-0.3 rad, 0.5-1 m/s
    starts = np.stack([rng.uniform(0.0, 1.0, CTL_FLEET), rng.uniform(-1.0, 0.0, CTL_FLEET),
                       rng.uniform(0.0, 0.3, CTL_FLEET), rng.uniform(0.5, 1.0, CTL_FLEET)], -1)
    pts, mask = ctl_course(device, f32)
    pts64, mask64 = ctl_course(device, f64)
    cpts64, cmask64 = ctl_course("cpu", f64)
    s32 = torch.tensor(starts, dtype=f32, device=device)
    for law in CTL_TRACKERS:
        steps = CTL_LQR_STEPS if law == "lqr_steer" else CTL_TRACK_STEPS
        (traj, _), stats = ctl_part(
            f"{law}: {CTL_FLEET} vehicles x {steps} steps f32 on {card}",
            lambda: ctl_track(law, s32, pts, mask, steps), counted,
            short=lambda: ctl_track(law, s32, pts, mask, 1))
        rmse = ctl_xtrack_rmse(traj)
        _gate(f"{law}: every vehicle's cross-track RMSE < {CTL_XTRACK_RMSE}",
              bool(np.isfinite(traj.cpu().numpy()).all()) and rmse.max() < CTL_XTRACK_RMSE,
              f"max {rmse.max()!r}, median {np.median(rmse)!r}")
        fleet = ctl_track(law, s32, pts, mask, CTL_LANE_STEPS)[0][-1]
        ctl_lanes(f"{law} f32, {CTL_LANE_STEPS} steps", fleet,
                  lambda i: ctl_track(law, s32[i], pts, mask, CTL_LANE_STEPS)[0][-1])
        small = starts[:CTL_SMALL]
        got = ctl_track(law, torch.tensor(small, dtype=f64, device=device), pts64, mask64,
                        CTL_SMALL_STEPS)
        want = ctl_track(law, torch.tensor(small, dtype=f64), cpts64, cmask64, CTL_SMALL_STEPS)
        d = ctl_same(f"{law}: {CTL_SMALL} vehicles x {CTL_SMALL_STEPS} steps f64 cuda = CPU",
                     got[0], want[0])
        ctl_same(f"{law}: last targets (LQR: lateral errors) f64 cuda = CPU", got[1], want[1])
        out[law] = {**stats, "steps": steps, "xtrack_rmse_max": float(rmse.max()),
                    "f64_max_diff": d}

    steps = (2000, 1500, 1500)

    def nl_state(b, dtype, dev):
        r = np.random.default_rng(SEED + 232)
        x = r.uniform(-2.0, 2.0, b)
        fl = np.stack([1.2 + r.normal(0, 0.2, b), r.normal(0, 0.2, b),
                       np.pi / 2 + r.normal(0, 0.2, b)], -1)
        bs = np.stack([np.zeros(b), r.uniform(0.5, 1.5, b), r.normal(0, 0.2, b)], -1)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
        return t(x), torch.zeros(b, dtype=dtype, device=dev), t(fl), t(bs)

    st = nl_state(CTL_FLEET, f32, device)
    res, stats = ctl_part(f"nonlinear laws: {CTL_FLEET} lanes x {steps} steps f32 on {card}",
                          lambda: ctl_nonlinear(st, steps), counted,
                          short=lambda: ctl_nonlinear(st, (1, 1, 1)))
    x, xd, _, pose_bs, err = (r.double().cpu() for r in res)
    mean_err = err / (steps[1] - 701)
    ok = (bool((x.abs() < 0.05).all() and (xd.abs() < 0.2).all())
          and float(mean_err.max()) < 0.25 and bool((pose_bs[:, 1].abs() < 0.05).all())
          and bool(((pose_bs[:, 0] - steps[2] * 0.02).abs() < 0.5).all()))
    _gate("nonlinear laws: tests/test_control_families.py's gates in every lane", ok,
          f"sliding max|x| {float(x.abs().max())!r}, feedback linearization max mean error "
          f"{float(mean_err.max())!r}, backstepping max|y| {float(pose_bs[:, 1].abs().max())!r}")
    fleet = torch.stack(ctl_nonlinear(st, (CTL_LANE_STEPS,) * 3)[2:4], 0)
    ctl_lanes("nonlinear laws f32", fleet.transpose(0, 1),
              lambda i: torch.stack(ctl_nonlinear(tuple(a[i] for a in st),
                                                  (CTL_LANE_STEPS,) * 3)[2:4], 0))
    small = (CTL_SMALL_STEPS,) * 3
    d = ctl_same("nonlinear laws f64 cuda = CPU",
                 torch.cat([a.reshape(CTL_SMALL, -1) for a in ctl_nonlinear(
                     nl_state(CTL_SMALL, f64, device), small)], -1),
                 torch.cat([a.reshape(CTL_SMALL, -1) for a in ctl_nonlinear(
                     nl_state(CTL_SMALL, f64, "cpu"), small)], -1))
    out["nonlinear"] = {**stats, "f64_max_diff": d}

    start = np.stack([np.zeros(CTL_FLEET), np.random.default_rng(SEED + 233).uniform(
        -0.3, 0.3, CTL_FLEET)], -1)
    p32 = torch.tensor(start, dtype=f32, device=device)
    (_, min_h), stats = ctl_part(f"CBF filter: {CTL_FLEET} robots x {CTL_CBF_STEPS} steps f32 "
                                 f"on {card}", lambda: ctl_cbf(p32, CTL_CBF_STEPS), counted,
                                 short=lambda: ctl_cbf(p32, 1))
    far = cbf.cbf_filter_single_integrator(
        torch.tensor([-50.0, 0.0], device=device), torch.tensor([1.5, 0.0], device=device),
        torch.tensor([[2.0, 0.0]], device=device), torch.ones(1, device=device),
        cbf.CBFConfig(alpha=2.0))
    far_err = float(torch.linalg.vector_norm(far.cpu() - torch.tensor([1.5, 0.0])))
    _gate("CBF filter: barrier > -0.05 throughout, inactive far away (test_control_misc.py)",
          float(min_h.min()) > -0.05 and far_err < 1e-6,
          f"least barrier {float(min_h.min())!r}, far error {far_err!r}")
    ctl_lanes("CBF f32", ctl_cbf(p32, CTL_LANE_STEPS)[0],
              lambda i: ctl_cbf(p32[i], CTL_LANE_STEPS)[0])
    d = ctl_same("CBF f64 cuda = CPU", ctl_cbf(torch.tensor(start[:CTL_SMALL], device=device),
                                               CTL_SMALL_STEPS)[0],
                 ctl_cbf(torch.tensor(start[:CTL_SMALL]), CTL_SMALL_STEPS)[0])
    out["cbf"] = {**stats, "least_barrier": float(min_h.min()), "f64_max_diff": d}

    res, stats = ctl_part(f"ADMM formation, consensus and horizon consensus f32 on {card}",
                          lambda: ctl_admm(device, f32), counted,
                          short=lambda: cadmm.solve_consensus(
                              torch.ones(3, 2, device=device), cfg=cadmm.ADMMConfig(10)))
    center, targets, fres = res["formation"]
    offsets = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], device=device)
    want_center = torch.tensor([[5.8, 2.1], [4.1, 2.0], [5.1, 2.9], [4.9, 1.2]],
                               device=device).sub(offsets).mean(0)
    cons_err = max(float((c[1].z - c[0].mean(0)).abs().max()) for k, c in res.items()
                   if k.startswith("consensus"))
    ok = (float((center - want_center).abs().max()) < 1e-4
          and float((targets - center - offsets).abs().max()) < 1e-4 and cons_err < 1e-4
          and float(res["horizon_40"][1]) < float(res["horizon_0"][1]))
    _gate("ADMM: the center and consensus within 1e-4 of the means, smoothing lowers the RMS "
          "acceleration", ok, f"consensus error {cons_err!r}, RMS acceleration stiff "
          f"{float(res['horizon_0'][1])!r} smooth {float(res['horizon_40'][1])!r}")
    def admm_small(dev):
        t = lambda a: torch.tensor(a, dtype=f64, device=dev)  # noqa: E731
        rng_ = np.random.default_rng(SEED + 250)
        targets, offsets = t(rng_.normal(0, 2, (6, 2))), t(rng_.normal(0, 1, (6, 2)))
        goals = t(rng_.normal(0, 1, (4, 10, 2)))
        return (cadmm.solve_formation_consensus(targets, offsets)[1],
                cadmm.solve_horizon_consensus(goals, goals[0, 0], 40.0,
                                              cadmm.ADMMConfig(iterations=120))[0])

    got, want = admm_small(device), admm_small("cpu")
    d = max(ctl_same("ADMM formation consensus f64 cuda = CPU", got[0], want[0]),
            ctl_same("ADMM horizon consensus f64 cuda = CPU", got[1], want[1], 1e-8))
    out["admm"] = {**stats, "f64_max_diff": d}
    return out


def ctl_pendulum(x, u, dt):
    """tests/test_control_misc.py's pendulum."""
    return torch.stack([x[0] + x[1] * dt, x[1] + (9.81 * torch.sin(x[0]) + u[0]) * dt])


def ctl_pendulum_stage(x, u):
    return 0.5 * (x[0] ** 2 + 0.1 * x[1] ** 2 + 0.01 * u[0] ** 2)


def ctl_pendulum_terminal(x):
    return 50.0 * (x[0] ** 2 + x[1] ** 2)


def ctl_vdp(x, u):
    """tests/test_cgmres_rocket.py's controlled Van der Pol."""
    return torch.stack([x[1], -x[0] + (1.0 - x[0] ** 2) * x[1] + u[0]])


def ctl_vdp_stage(x, u):
    return 0.5 * (2.0 * x[0] ** 2 + x[1] ** 2 + 0.1 * u[0] ** 2)


def ctl_vdp_terminal(x):
    return 0.5 * (2.0 * x[0] ** 2 + x[1] ** 2)


def ctl_mpc_inputs(b, dtype, device):
    """test_mpc_respects_control_limits's reference (x from 0 to 20 m at
    5 m/s) from starts scattered around the origin."""
    r = np.random.default_rng(SEED + 234)
    x0 = np.stack([r.uniform(-1, 1, b), r.uniform(-1, 1, b), r.uniform(0, 2, b),
                   r.uniform(-0.2, 0.2, b)], -1)
    ref = np.zeros((b, 6, 4))
    ref[:, :, 0] = np.linspace(0.0, 20.0, 6) + x0[:, :1]
    ref[:, :, 1] = x0[:, 1:2]
    ref[:, :, 2] = 5.0
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return t(x0), t(ref), torch.zeros((b, 5, 2), dtype=dtype, device=device)


def ctl_ilqr_starts(b):
    r = np.random.default_rng(SEED + 235)
    x0 = np.stack([r.uniform(-0.8, 0.8, b), r.uniform(-0.5, 0.5, b)], -1)
    x0[0], x0[1] = (0.5, 0.0), (0.8, 0.0)  # tests/test_control_misc.py's starts
    return x0


def ctl_trajopt_part(card, device, counted):
    """(b) the MPC over a fleet, iLQR and DDP, the LQR regulator, C/GMRES
    and the rocket landing."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    cfg = cmpc.MPCConfig()
    x0, ref, u0 = ctl_mpc_inputs(CTL_FLEET, f32, device)
    (u, xs, _), stats = ctl_part(f"mpc_control: {CTL_FLEET} vehicles f32 on {card}",
                                 lambda: cmpc.mpc_control(x0, ref, u0, cfg), counted,
                                 short=lambda: cmpc.mpc_control(
                                     x0, ref, u0, cmpc.MPCConfig(outer_iterations=1,
                                                                 qp_iterations=1)))
    ok = (float(u[..., 0].abs().max()) <= cfg.max_accel + 1e-6
          and float(u[..., 1].abs().max()) <= cfg.max_steer + 1e-6
          and float(u[:, 0, 0].min()) > 0.5 and bool(torch.isfinite(xs).all()))
    _gate("mpc_control: within the limits, accelerating toward the fast reference "
          "(test_mpc_respects_control_limits) in every lane", ok,
          f"least first acceleration {float(u[:, 0, 0].min())!r}")
    small = cmpc.MPCConfig(qp_iterations=40)
    ctl_lanes("mpc_control f32, 3 x 40 steps", cmpc.mpc_control(x0, ref, u0, small)[0],
              lambda i: cmpc.mpc_control(x0[i], ref[i], u0[i], small)[0])
    got = cmpc.mpc_control(*ctl_mpc_inputs(CTL_SMALL, f64, device), small)[0]
    want = cmpc.mpc_control(*ctl_mpc_inputs(CTL_SMALL, f64, "cpu"), small)[0]
    out["mpc"] = {**stats, "f64_max_diff": ctl_same(
        f"mpc_control {CTL_SMALL} vehicles (3 x 40 steps) f64 cuda = CPU", got, want, 1e-8)}

    x0s = ctl_ilqr_starts(CTL_ILQR_BATCH)
    icfg = ctraj.ILQRConfig(iterations=CTL_ILQR_ITERATIONS)
    xb = torch.tensor(x0s, dtype=f32, device=device)
    ub = torch.zeros((CTL_ILQR_BATCH, 60, 1), dtype=f32, device=device)
    costs, ends = {}, {}
    for name, solve in (("ilqr", ctraj.ilqr_solve), ("ddp", ctraj.ddp_solve)):
        run = lambda solve=solve, xb=xb, ub=ub, it=icfg: solve(  # noqa: E731
            ctl_pendulum, ctl_pendulum_stage, ctl_pendulum_terminal, xb, ub, 0.02, it)
        (xs, us, cost), stats = ctl_part(
            f"{name}: {CTL_ILQR_BATCH} pendulums x 60 knots, {CTL_ILQR_ITERATIONS} iterations "
            f"f32 on {card}", run, counted,
            short=lambda solve=solve: solve(ctl_pendulum, ctl_pendulum_stage,
                                            ctl_pendulum_terminal, xb, ub, 0.02,
                                            ctraj.ILQRConfig(iterations=1)))
        costs[name], ends[name] = cost, xs
        lane = 0 if name == "ilqr" else 1
        small = ctraj.ILQRConfig(iterations=5)
        args = (ctl_pendulum, ctl_pendulum_stage, ctl_pendulum_terminal)
        fleet = solve(*args, xb, ub, 0.02, small)
        solo = solve(*args, xb[lane], ub[lane], 0.02, small)
        ok = bitwise_equal(solo[1], fleet[1][lane]) and bitwise_equal(solo[2], fleet[2][lane])
        _gate(f"{name}: lane {lane} of the batch bitwise its solo solve (5 iterations)", ok,
              "bitwise" if ok else "differ")
        got = solve(*args, torch.tensor(x0s[:4], dtype=f64, device=device),
                    torch.zeros((4, 60, 1), dtype=f64, device=device), 0.02, small)
        want = solve(*args, torch.tensor(x0s[:4], dtype=f64), torch.zeros((4, 60, 1), dtype=f64),
                     0.02, small)
        # the controls are O(10): 1e-9 of their largest
        out[name] = {**stats, "f64_max_diff": ctl_same(
            f"{name}: 4 pendulums, 5 iterations, f64 cuda = CPU", got[1], want[1],
            CTL_ATOL * float(want[1].abs().max()))}
    theta_end = float(ends["ilqr"][0, -1, 0])
    ok = (abs(theta_end) < 0.05 and float(costs["ilqr"][0]) < 10.0
          and float(costs["ddp"][1]) <= 1.2 * float(costs["ilqr"][1]))
    _gate("iLQR swings the pendulum up (|θ_H| < 0.05, cost < 10) and DDP <= 1.2 iLQR "
          "(test_control_misc.py)", ok,
          f"θ_H {theta_end!r}, cost {float(costs['ilqr'][0])!r}, DDP "
          f"{float(costs['ddp'][1])!r} vs iLQR {float(costs['ilqr'][1])!r}")

    dt = 0.02

    def regulate(dev, dtype):
        a = torch.tensor([[1.0, dt], [9.81 * dt, 1.0]], dtype=dtype, device=dev)
        b = torch.tensor([[0.0], [dt]], dtype=dtype, device=dev)
        k = ctraj.lqr_regulator(a, b, torch.eye(2, dtype=dtype, device=dev),
                                torch.eye(1, dtype=dtype, device=dev))
        x = torch.tensor([0.3, 0.0], dtype=dtype, device=dev)
        for _ in range(400):
            x = a @ x + b @ -(k @ x)
        return k, x

    (k, x), stats = ctl_part(f"lqr_regulator and 400 closed-loop steps f32 on {card}",
                             lambda: regulate(device, f32), counted)
    _gate("lqr_regulator: |x_400| < 1e-3 (test_control_misc.py)",
          float(torch.linalg.vector_norm(x)) < 1e-3, f"|x| {float(torch.linalg.vector_norm(x))!r}")
    out["lqr_regulator"] = {**stats, "f64_max_diff": ctl_same(
        "lqr_regulator f64 cuda = CPU", regulate(device, f64)[0], regulate("cpu", f64)[0])}

    ccfg = ccg.CGMRESConfig(sampling_dt=0.01)
    residual = ccg.make_optimality_residual(
        ctl_vdp, torch.func.grad(ctl_vdp_stage, argnums=1),
        torch.func.grad(ctl_vdp_stage, argnums=0), torch.func.grad(ctl_vdp_terminal), ccfg)

    def continuation(steps, dev=device):
        """`run_cgmres`'s loop, step for step, keeping the horizon's
        controls U: (states, |F(U, x)| at the start and the end)."""
        x = torch.tensor([1.5, 0.0], dtype=f64, device=dev)
        u_flat = torch.zeros(ccfg.horizon, dtype=f64, device=dev)
        f0 = torch.linalg.vector_norm(residual(u_flat, x))
        xs = [x]
        for _ in range(steps):
            u0 = u_flat[:1]
            u_flat = ccg.cgmres_step(residual, u_flat, x, ctl_vdp(x, u0), ccfg)
            x = x + ctl_vdp(x, u0) * ccfg.sampling_dt
            xs.append(x)
        return torch.stack(xs), f0, torch.linalg.vector_norm(residual(u_flat, x))

    (xs, f0, f_end), stats = ctl_part(
        f"C/GMRES: {CTL_CGMRES_STEPS} of test_cgmres_rocket.py's 1200 steps f64 on {card}",
        lambda: continuation(CTL_CGMRES_STEPS), counted, short=lambda: continuation(1))
    _gate(f"C/GMRES: finite, the optimality residual |F| down 100x in {CTL_CGMRES_STEPS} steps "
          f"(the continuation's ζ = {ccfg.zeta:g}; the test's |x_1200| < 0.15 needs all 1200)",
          bool(torch.isfinite(xs).all()) and float(f_end) < 0.01 * float(f0),
          f"|F| {float(f0)!r} -> {float(f_end)!r}, x {xs[-1].tolist()}")
    n = CTL_CGMRES_CPU_STEPS
    got = ccg.run_cgmres(ctl_vdp, ctl_vdp_stage, ctl_vdp_terminal, [1.5, 0.0], n, ccfg,
                         dtype=f64, device=device)[0]
    want = ccg.run_cgmres(ctl_vdp, ctl_vdp_stage, ctl_vdp_terminal, [1.5, 0.0], n, ccfg,
                          dtype=f64, device="cpu")[0]
    _gate(f"run_cgmres {n} steps bitwise the continuation loop's", bitwise_equal(got, xs[:n + 1]),
          "bitwise")
    out["cgmres"] = {**stats, "steps": CTL_CGMRES_STEPS, "residual": [float(f0), float(f_end)],
                     "f64_max_diff": ctl_same(f"run_cgmres {n} steps f64 cuda = CPU", got, want,
                                              1e-8)}

    rcfg = crocket.RocketConfig()
    land = lambda dtype, dev=device: crocket.plan_landing(  # noqa: E731
        [20.0, 60.0, -3.0, -8.0], [0.0, 0.0], rcfg, dtype=dtype, device=dev)
    (xs, us, cost), stats = ctl_part(
        f"plan_landing at RocketConfig() f64 on {card}", lambda: land(f64), counted,
        short=lambda: crocket.plan_landing([20.0, 60.0, -3.0, -8.0], [0.0, 0.0],
                                           crocket.RocketConfig(outer_iterations=1,
                                                                inner_iterations=1),
                                           dtype=f64, device=device))
    final = xs[-1].cpu()
    mags = torch.linalg.vector_norm(us.cpu(), dim=-1)
    ok = (float(torch.linalg.vector_norm(final[:2])) < 1.0
          and float(torch.linalg.vector_norm(final[2:])) < 1.0
          and float(mags.max()) <= rcfg.max_thrust + 1e-6 and float(xs[:, 1].min()) > -1.0)
    _gate("plan_landing f64 lands softly within the thrust bound (test_rocket_lands_softly, "
          "x64)", ok, f"final {final.tolist()}, max thrust {float(mags.max())!r}")
    small = crocket.RocketConfig(outer_iterations=1, inner_iterations=20)
    out["rocket"] = {**stats, "f64_max_diff": ctl_same(
        "plan_landing (20 steps) f64 cuda = CPU",
        crocket.plan_landing([20.0, 60.0, -3.0, -8.0], [0.0, 0.0], small, dtype=f64,
                             device=device)[1],
        crocket.plan_landing([20.0, 60.0, -3.0, -8.0], [0.0, 0.0], small, dtype=f64,
                             device="cpu")[1], 1e-8)}
    return out


CTL_ARM = dict(lengths=[0.5] * 7, centers=[[1.2, 0.6, 0.3], [0.8, -0.8, 0.5]], radii=[0.25, 0.25])


def ctl_rrt(nodes, kw, dtype, device, seed=SEED + 236):
    """bench_arm_rrt_star's problem with seeded numpy draws."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    draws = (t(r.uniform(-np.pi, np.pi, (nodes - 2, 7))), t(r.random(nodes - 2)))
    return carm.rrt_star_arm_plan(None, t(np.zeros(7)), t(np.full(7, 0.6)), t(CTL_ARM["lengths"]),
                                  t(CTL_ARM["centers"]), t(CTL_ARM["radii"]), max_nodes=nodes,
                                  draws=draws, **kw)


def ctl_ik_inputs(b, dtype, device):
    r = np.random.default_rng(SEED + 237)
    q = r.uniform(-1.0, 1.0, (b, 7))
    lengths = torch.full((7,), 0.5, dtype=dtype, device=device)
    targets = carm.end_effector_3d(torch.tensor(q, dtype=dtype, device=device), lengths)
    start = torch.tensor(q + r.normal(0, 0.3, q.shape), dtype=dtype, device=device)
    return start, targets, lengths


def ctl_arm_part(card, device, counted):
    """(c) the arm: RRT* in joint space and the 3-D IK over a batch."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    for nodes, kw in CTL_RRT:
        plan, stats = ctl_part(f"rrt_star_arm_plan: 7 joints, {nodes} nodes f32 on {card}",
                               lambda nodes=nodes, kw=kw: ctl_rrt(nodes, kw, f32, device),
                               counted, short=lambda kw=kw: ctl_rrt(4, kw, f32, device))
        _gate(f"rrt_star_arm_plan {nodes} nodes finds a path (bench_arm_rrt_star)",
              bool(plan["found"]), f"cost {float(plan['cost'])!r}, "
              f"{int(plan['mask'].sum())} waypoints")
        out[f"rrt_{nodes}"] = {**stats, "found": bool(plan["found"]),
                               "cost": float(plan["cost"])}
    kw = CTL_RRT[0][1]
    got, want = ctl_rrt(48, kw, f64, device), ctl_rrt(48, kw, f64, "cpu")
    ctl_same("rrt_star_arm_plan 48 nodes f64 cuda = CPU: mask", got["mask"], want["mask"])
    out["rrt_f64_max_diff"] = ctl_same("rrt_star_arm_plan 48 nodes f64 cuda = CPU: waypoints",
                                       got["waypoints"], want["waypoints"])

    start, targets, lengths = ctl_ik_inputs(CTL_FLEET, f32, device)
    (angles, err), stats = ctl_part(
        f"inverse_kinematics_3d: {CTL_FLEET} targets x {CTL_IK_ITERATIONS} iterations f32 on "
        f"{card}", lambda: carm.inverse_kinematics_3d(start, targets, lengths, CTL_IK_ITERATIONS),
        counted, short=lambda: carm.inverse_kinematics_3d(start, targets, lengths, 1))
    med = float(err.median())
    _gate("inverse_kinematics_3d reaches reachable targets (median error < 1e-3)", med < 1e-3,
          f"median {med!r}, max {float(err.max())!r}")
    ctl_lanes(f"inverse_kinematics_3d f32, {CTL_LANE_STEPS} iterations",
              carm.inverse_kinematics_3d(start, targets, lengths, CTL_LANE_STEPS)[0],
              lambda i: carm.inverse_kinematics_3d(start[i], targets[i], lengths,
                                                   CTL_LANE_STEPS)[0])
    got = carm.inverse_kinematics_3d(*ctl_ik_inputs(CTL_SMALL, f64, device), 20)[0]
    want = carm.inverse_kinematics_3d(*ctl_ik_inputs(CTL_SMALL, f64, "cpu"), 20)[0]
    out["ik"] = {**stats, "median_error": med, "f64_max_diff": ctl_same(
        "inverse_kinematics_3d 20 iterations f64 cuda = CPU", got, want, 1e-8)}
    return out


def ctl_mppi_loop(stage, terminal, state, cfg, steps, draws):
    """A closed loop of `steps` MPPI plans on the double integrator, plan i
    drawing draws[i]; the states [steps+1, ..., 4]."""
    u = torch.zeros(state.shape[:-1] + (cfg.horizon, 2), dtype=state.dtype, device=state.device)
    traj = [state]
    for i in range(steps):
        u, first, _ = cmppi.mppi_plan(None, cmppi.double_integrator_dynamics, stage, terminal,
                                      state, u, cfg, draws=draws[i])
        state = cmppi.double_integrator_dynamics(state, first, cfg.dt)
        u = cmppi.shift_nominal(u)
        traj.append(state)
    return torch.stack(traj)


def ctl_normals(seed, shape, dtype, device):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape), dtype=dtype,
                        device=device)


def ctl_value_world(device):
    """bench_mppi_value's 48x48 world: a wall between start and goal."""
    res, origin, w, h = 0.25, (-2.0, -4.0), 48, 48
    free = np.ones((w, h), bool)
    wall_x, wall_top = int((2.5 - origin[0]) / res), int((2.0 - origin[1]) / res)
    free[wall_x:wall_x + 2, :wall_top] = False
    goal_idx = (int((6.0 - origin[0]) / res), int((0.0 - origin[1]) / res))
    obstacle_pts = np.argwhere(~free) * res + np.asarray(origin) + res / 2
    return res, origin, free, goal_idx, obstacle_pts


def ctl_value_mppi(device, dtype, steps, samples=512, wavefront=None):
    """bench_mppi_value: value-guided against vanilla MPPI behind the wall;
    (final distances, the value field)."""
    res, origin, free, goal_idx, obstacle_pts = ctl_value_world(device)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    goal = t([6.0, 0.0])
    field = (wavefront or wavefront_costs)(
        torch.tensor(free, device=device),
        goal_raster(free.shape, torch.tensor(goal_idx, device=device)), dtype=dtype) * res
    vgrid = cvalue.TerminalValueGrid(t(origin), torch.full((), res, dtype=dtype, device=device),
                                     field)
    stage, quad_terminal = cmppi.make_goal_costs(goal, obstacles=t(obstacle_pts),
                                                 obstacle_radius=0.4, obstacle_weight=500.0)
    cfg = cmppi.MPPIConfig(horizon=25, num_samples=samples, noise_sigma=(0.8, 0.8))
    draws = ctl_normals(SEED + 238, (steps, samples, 25, 2), dtype, device)
    dists = []
    for terminal in (cvalue.make_value_terminal_cost(vgrid, weight=30.0), quad_terminal):
        traj = ctl_mppi_loop(stage, terminal, torch.zeros(4, dtype=dtype, device=device), cfg,
                             steps, draws)
        dists.append(torch.linalg.vector_norm(traj[-1, :2] - goal))
    return torch.stack(dists), field


def ctl_person_racing(device, dtype, steps=(80, 120), samples=512):
    """tests/test_temporal_mppi_variants.py's loops: following a walker at
    1.5 m (mean distance over steps > 40) and racing a 5 m circle (lap
    progress, the farthest distance from the centerline)."""
    cfg = cmppi.MPPIConfig(horizon=20, num_samples=samples, temperature=0.4,
                           noise_sigma=(0.6, 0.6))
    tt = torch.arange(20, dtype=dtype, device=device) * 0.1
    state = torch.tensor([0.0, 2.5, 0.0, 0.0], dtype=dtype, device=device)
    u = torch.zeros((20, 2), dtype=dtype, device=device)
    draws = ctl_normals(SEED + 239, (steps[0], samples, 20, 2), dtype, device)
    dist = torch.zeros((), dtype=dtype, device=device)
    for k in range(steps[0]):
        target = torch.stack([0.5 * (k * 0.1 + tt), torch.zeros_like(tt)], -1)
        stage, term = cvar.make_person_following_costs(target, standoff=1.5)
        u, u0, _ = cmppi.mppi_plan(None, cmppi.double_integrator_dynamics, stage, term, state, u,
                                   cfg, draws=draws[k])
        state = cmppi.double_integrator_dynamics(state, u0, cfg.dt)
        u = cmppi.shift_nominal(u)
        if k > 40:
            dist = dist + torch.linalg.vector_norm(state[:2] - target[0])
    th = torch.tensor(np.linspace(0, 2 * np.pi, 100, endpoint=False), dtype=dtype, device=device)
    centerline = torch.stack([5 * torch.cos(th), 5 * torch.sin(th)], -1)
    stage, term = cvar.make_racing_costs(centerline, half_width=1.0)
    rcfg = cmppi.MPPIConfig(horizon=25, num_samples=samples, temperature=0.4,
                            noise_sigma=(0.8, 0.8), control_min=(-3, -3), control_max=(3, 3))
    traj = ctl_mppi_loop(stage, term, torch.tensor([5.0, 0.0, 0.0, 0.5], dtype=dtype,
                                                   device=device), rcfg, steps[1],
                         ctl_normals(SEED + 240, (steps[1], samples, 25, 2), dtype, device))
    prog = cvar.lap_progress(traj, centerline)
    off = torch.amax(torch.amin(torch.linalg.vector_norm(traj[:, None, :2] - centerline, dim=-1),
                                -1))
    return dist / max(steps[0] - 41, 1), prog, off


def ctl_square_gates():
    """demos/benchmarks.py's square lap of four gates."""
    return [crace.GatePlane(c, n, half_width=1.2, half_height=1.2) for c, n in (
        ((3.0, 0.0, 1.5), (0.0, 1.0, 0.0)), ((0.0, 3.0, 1.5), (-1.0, 0.0, 0.0)),
        ((-3.0, 0.0, 1.5), (0.0, -1.0, 0.0)), ((0.0, -3.0, 1.5), (1.0, 0.0, 0.0)))]


def ctl_race(device, dtype, steps, horizon, num_samples):
    draws = ctl_normals(SEED + 241, (steps, num_samples, horizon, 4), dtype, device)
    return crace.simulate_gate_race(None, ctl_square_gates(), crace.PowertrainParams(),
                                    start=(3.0, -3.0, 1.5), steps=steps, horizon=horizon,
                                    num_samples=num_samples, draws=draws, dtype=dtype,
                                    device=device)


def ctl_push(device, dtype, steps, horizon=12, samples=64):
    draws = ctl_normals(SEED + 242, (steps, 4, samples, horizon, 3), dtype, device)
    return cpush.simulate_push(None, cpush.PusherSliderParams(), (0.0, 0.0, 0.0), (1.2, 0.6, 0.0),
                               steps=steps, cfg=cpush.PusherMppiConfig(horizon=horizon,
                                                                       num_samples=samples),
                               goal_tol=0.12, draws=draws, dtype=dtype, device=device)


def ctl_mppi_part(card, device, counted):
    """(d) MPPI: bench_mppi's loop, a fleet plan, the value-guided MPPI (B2),
    person following and racing, gate racing, the pusher-slider."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    goal = torch.tensor([5.0, 5.0], device=device)
    stage, terminal = cmppi.make_goal_costs(goal)
    cfg = cmppi.MPPIConfig(horizon=25, num_samples=256)
    draws = ctl_normals(SEED + 243, (40, 256, 25, 2), f32, device)
    traj, stats = ctl_part(f"bench_mppi: K 256 x H 25, 40 steps f32 on {card}",
                           lambda: ctl_mppi_loop(stage, terminal, torch.zeros(4, device=device),
                                                 cfg, 40, draws), counted,
                           short=lambda: ctl_mppi_loop(stage, terminal,
                                                       torch.zeros(4, device=device), cfg, 1,
                                                       draws))
    dist = float(torch.linalg.vector_norm(traj[-1, :2] - goal))
    # tests/test_dwa_mppi.py's loop: K 512, temperature 0.5, σ 0.8, 120 steps
    goal2 = torch.tensor([5.0, 3.0], device=device)
    tcfg = cmppi.MPPIConfig(horizon=25, num_samples=512, temperature=0.5, noise_sigma=(0.8, 0.8))
    traj2 = ctl_mppi_loop(*cmppi.make_goal_costs(goal2), torch.zeros(4, device=device), tcfg, 120,
                          ctl_normals(SEED + 249, (120, 512, 25, 2), f32, device))
    dist2 = float(torch.linalg.vector_norm(traj2[-1, :2] - goal2))
    _gate("bench_mppi finite and nearer its goal; test_dwa_mppi.py's loop within 0.3 m of its "
          "goal", bool(torch.isfinite(traj).all()) and dist < float(torch.linalg.vector_norm(goal))
          and dist2 < 0.3, f"final distances {dist!r}, {dist2!r}")
    out["bench_mppi"] = {**stats, "final_distance": dist, "test_loop_final_distance": dist2}

    robots, samples, horizon, n_obs = CTL_MPPI_FLEET
    r = np.random.default_rng(SEED + 244)
    obstacles = torch.tensor(r.uniform(1.0, 4.0, (n_obs, 2)), dtype=f32, device=device)
    fstage, fterm = cmppi.make_goal_costs(goal, obstacles, 0.4)
    fcfg = cmppi.MPPIConfig(horizon=horizon, num_samples=samples)
    fstate = torch.tensor(np.concatenate([r.uniform(-1, 1, (robots, 2)),
                                          r.normal(0, 0.3, (robots, 2))], -1), dtype=f32,
                          device=device)
    fu = torch.zeros((robots, horizon, 2), device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 245)
    fdraws = torch.randn((robots, samples, horizon, 2), generator=gen, device=device)
    plan = lambda: cmppi.mppi_plan(None, cmppi.double_integrator_dynamics, fstage, fterm,  # noqa
                                   fstate, fu, fcfg, draws=fdraws)
    (u, first, diag), stats = ctl_part(f"mppi_plan: {robots} robots x {samples} samples x H "
                                       f"{horizon}, {n_obs} obstacles f32 on {card}", plan,
                                       counted)
    ess = diag.effective_sample_size
    _gate("mppi fleet plan: finite, within the control box",
          bool(torch.isfinite(u).all()) and float(u.abs().max()) <= 2.0,
          f"ESS median {float(ess.median())!r}, least {float(ess.min())!r}")
    ctl_lanes("mppi fleet plan f32", u, lambda i: cmppi.mppi_plan(
        None, cmppi.double_integrator_dynamics, fstage, fterm, fstate[i], fu[i], fcfg,
        draws=fdraws[i])[0])
    del fdraws
    scfg = cmppi.MPPIConfig(horizon=horizon, num_samples=64)

    def small_plan(dev):
        t = lambda a: a.to(device=dev, dtype=f64)  # noqa: E731
        st, tm_ = cmppi.make_goal_costs(t(goal), t(obstacles), 0.4)
        return cmppi.mppi_plan(None, cmppi.double_integrator_dynamics, st, tm_,
                               t(fstate[:CTL_SMALL]), t(fu[:CTL_SMALL]), scfg,
                               draws=ctl_normals(SEED + 246, (CTL_SMALL, 64, horizon, 2), f64,
                                                 dev))[0]

    out["fleet_plan"] = {**stats, "f64_max_diff": ctl_same(
        f"mppi_plan {CTL_SMALL} robots x 64 samples f64 cuda = CPU", small_plan(device),
        small_plan("cpu"))}

    (dists, field), stats = ctl_part(
        f"bench_mppi_value: 48x48 value grid (B2) and 2 x 70 steps, K 512 f32 on {card}",
        lambda: ctl_value_mppi(device, f32, 70, wavefront=ctl_wavefront), counted,
        short=lambda: ctl_value_mppi(device, f32, 1, wavefront=ctl_wavefront))
    _gate("bench_mppi_value: the value-guided MPPI ends nearer the goal than the vanilla "
          "(test_mppi_value.py)", float(dists[0]) < float(dists[1]),
          f"value {float(dists[0])!r}, vanilla {float(dists[1])!r}")
    res, origin, free, goal_idx, _ = ctl_value_world(device)
    for dtype in (f32, f64):
        got = wavefront_costs(torch.tensor(free, device=device),
                              goal_raster(free.shape, torch.tensor(goal_idx, device=device)),
                              dtype=dtype)
        want = wavefront_costs(torch.tensor(free), goal_raster(free.shape, torch.tensor(goal_idx)),
                               dtype=dtype)
        _gate(f"bench_mppi_value's field {dtype} bitwise the CPU's",
              bitwise_equal(got.cpu(), want), "bitwise")
    got = ctl_value_mppi(device, f64, 3, samples=64)[0]
    want = ctl_value_mppi("cpu", f64, 3, samples=64)[0]
    out["value_mppi"] = {**stats, "value_distance": float(dists[0]),
                         "vanilla_distance": float(dists[1]), "f64_max_diff": ctl_same(
                             "bench_mppi_value 3 steps, K 64 f64 cuda = CPU", got, want)}

    (dist, prog, off), stats = ctl_part(
        f"person following (80 steps) and racing (120 steps), K 512 f32 on {card}",
        lambda: ctl_person_racing(device, f32), counted,
        short=lambda: ctl_person_racing(device, f32, (1, 1)))
    ok = 0.7 < float(dist) < 2.6 and float(prog) > 0.25 and float(off) < 2.0
    _gate("person following keeps its standoff, racing makes lap progress "
          "(test_temporal_mppi_variants.py)", ok,
          f"mean distance {float(dist)!r}, lap progress {float(prog)!r}, farthest off "
          f"{float(off)!r}")
    got = torch.stack(ctl_person_racing(device, f64, (3, 3), 64))
    want = torch.stack(ctl_person_racing("cpu", f64, (3, 3), 64))
    out["person_racing"] = {**stats, "f64_max_diff": ctl_same(
        "person following and racing 3 steps, K 64 f64 cuda = CPU", got, want)}

    rep, stats = ctl_part(f"simulate_gate_race at its defaults {CTL_RACE} f32 on {card}",
                          lambda: ctl_race(device, f32, **CTL_RACE), counted,
                          short=lambda: ctl_race(device, f32, 1, CTL_RACE["horizon"],
                                                 CTL_RACE["num_samples"]))
    _gate("simulate_gate_race passes a gate, draws charge, stays finite (test_racing.py)",
          rep["gates_passed"] >= 1 and rep["final_soc"] < 1.0
          and bool(np.isfinite(rep["trajectory"]).all()),
          f"{rep['gates_passed']} gates, final SOC {rep['final_soc']!r}")
    got, want = ctl_race(device, f64, 2, 6, 16), ctl_race("cpu", f64, 2, 6, 16)
    ctl_same("simulate_gate_race 2 steps gates passed cuda = CPU",
             torch.tensor(got["gates_passed"]), torch.tensor(want["gates_passed"]))
    out["gate_race"] = {**stats, "gates_passed": rep["gates_passed"],
                        "final_soc": rep["final_soc"], "f64_max_diff": ctl_same(
                            "simulate_gate_race 2 steps, K 16 f64 cuda = CPU",
                            torch.tensor(got["trajectory"]), torch.tensor(want["trajectory"]))}

    rep, stats = ctl_part(f"simulate_push: {CTL_PUSH_STEPS} steps, K 64 x H 12 x 4 faces f32 "
                          f"on {card}", lambda: ctl_push(device, f32, CTL_PUSH_STEPS), counted,
                          short=lambda: ctl_push(device, f32, 1))
    twist, modes, valid = cpush.two_contact_twist(cpush.PusherSliderParams(), (0, 2), (0.0, 0.0),
                                                  (0.05, 0.05), (0.5, 0.5), dtype=f32,
                                                  device=device)
    ok = (rep["final_position_error"] < 0.25 and len(rep["faces"]) > 0
          and bool(np.isfinite(rep["trajectory"]).all()) and bool(valid)
          and abs(float(twist[2])) > 0.1)
    _gate("simulate_push nears its goal (test_pusher_slider.py) and the two-contact couple "
          "spins (bench_pusher_slider)", ok,
          f"final position error {rep['final_position_error']!r} after {rep['steps_used']} "
          f"steps, couple ω {float(twist[2])!r}")
    got, want = ctl_push(device, f64, 2, 6, 16), ctl_push("cpu", f64, 2, 6, 16)
    ctl_same("simulate_push 2 steps faces and modes cuda = CPU",
             torch.tensor(np.concatenate([got["faces"], got["modes"]])),
             torch.tensor(np.concatenate([want["faces"], want["modes"]])))
    out["push"] = {**stats, "final_position_error": rep["final_position_error"],
                   "f64_max_diff": ctl_same("simulate_push 2 steps, K 16 f64 cuda = CPU",
                                            torch.tensor(got["trajectory"]),
                                            torch.tensor(want["trajectory"]))}
    return out


def ctl_tf32_part(card, device):
    """(e) The solver paths (mpc_control, ilqr_solve, solve_horizon_consensus,
    lqr_steer_control) give the same bits with TF32 allowed as without."""
    f32 = torch.float32
    x0, ref, u0 = ctl_mpc_inputs(CTL_SMALL, f32, device)
    xb = torch.tensor(ctl_ilqr_starts(4), dtype=f32, device=device)
    ub = torch.zeros((4, 60, 1), dtype=f32, device=device)
    goals = torch.tensor(np.random.default_rng(SEED + 247).normal(0, 1, (4, 10, 2)), dtype=f32,
                         device=device)
    pts, mask = ctl_course(device, f32)
    starts = torch.tensor(np.random.default_rng(SEED + 248).uniform(0, 2, (64, 4)), dtype=f32,
                          device=device)

    def runs():
        return {
            "mpc_control": cmpc.mpc_control(x0, ref, u0, cmpc.MPCConfig(qp_iterations=40))[0],
            "ilqr_solve": ctraj.ilqr_solve(ctl_pendulum, ctl_pendulum_stage, ctl_pendulum_terminal,
                                           xb, ub, 0.02, ctraj.ILQRConfig(iterations=5))[1],
            "solve_horizon_consensus": cadmm.solve_horizon_consensus(
                goals, goals[0, 0], 40.0, cadmm.ADMMConfig(iterations=120))[0],
            "lqr_steer_control": ctrack.lqr_steer_control(
                starts, pts, mask, 3.0, starts[:, 0] * 0, starts[:, 0] * 0,
                ctrack.LQRSteerConfig(wheelbase=2.9))[1],
        }

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = runs()
        torch.set_float32_matmul_precision("high")
        got = runs()
    finally:
        torch.set_float32_matmul_precision(saved)
    bad = [k for k in want if not bitwise_equal(got[k], want[k])]
    _gate(f"control solver paths with TF32 allowed (float32 matmul precision 'high') bitwise "
          f"their 'highest' runs on {card}", not bad, f"differ: {bad}" if bad else "bitwise")
    return {"tf32_bitwise": sorted(want)}


def control_phase(card, device, counted):
    """The control layer (phase 23): (a) trackers and laws, (b) MPC and
    trajectory optimisation, (c) the arm, (d) MPPI, (e) TF32."""
    out = {"card": card}
    start = time.perf_counter()
    for name, part in (("trackers", ctl_trackers_part), ("trajopt", ctl_trajopt_part),
                       ("arm", ctl_arm_part), ("mppi", ctl_mppi_part)):
        t0 = time.perf_counter()
        out[name] = part(card, device, counted)
        out[name]["part_s"] = time.perf_counter() - t0
        print(f"control, part {name}: {out[name]['part_s']!r} s")
    out["tf32"] = ctl_tf32_part(card, device)
    out["phase_s"] = time.perf_counter() - start
    out["kernel_launches"] = dict(CTL_KERNEL_LAUNCHES)
    print(f"control: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']}")
    return out


# phase 24: the kinematic planners (planning/: curves, Frenet, Reeds-Shepp,
# eta3, the RRT family and its variants, the kinematic RRTs, the reactive
# planners, hybrid A*, the lattice, CHOMP, the bipedal planner; no kernel)
KIN_FOREST = 1024
KIN_RRT_SEEDS = (0,)  # bench_rrt_star's seeds run here; phase 27 runs the bench's four plans
KIN_ATOL = 1e-9
KIN_PAIRS = 1024  # Dubins and Reeds-Shepp pose pairs
KIN_RRT = dict(expand_dis=1.0, max_nodes=300, connect_radius=2.5, goal_threshold=1.0)
KIN_COURSE = ([[5.0, 5.0], [3.0, 6.0], [7.0, 4.0]], [1.0, 0.8, 0.8])  # bench_rrt_star's
KIN_KCOURSE = ([[4.5, 4.5], [2.0, 6.5]], [1.2, 0.9])  # tests/test_rrt_kinematic.py's
KIN_KLANES = 16  # the kinematic RRTs' small forest (a lane per seed)
KIN_KNODES = 64  # their nodes: 64 of tests/test_rrt_kinematic.py's 96 (room for phase 27)
KIN_HYBRID = (128, 16)  # map side, headings
# Each part is profiled at the size it is timed, but those whose call
# launches ~70k kernels or more (the kinematic RRTs, the closed loop,
# LQR-RRT*, the clothoid, CHOMP): the profiler adds ~0.1 ms of host time a
# launch, so they profile a short call, named in their numbers
# ("profiled"). KIN_PROFILE_FULL=1 in the environment profiles them at
# full size too (phase 24 then takes ~100 s more).
KIN_PROFILE_FULL = os.environ.get("KIN_PROFILE_FULL") == "1"
# the RRT family's trees (~20k-220k launches at 256-300 nodes) profile a
# tree of this many nodes (cut for phase 26: their full-size profiles cost
# ~50 s of phase 24)
KIN_PROFILE_NODES = 20
KIN_KERNEL_LAUNCHES = {}


def kin_part(label, fn, counted, short=None, totals=KIN_KERNEL_LAUNCHES):
    """fn() once under sync debug mode "warn" on the host clock (its reads)
    and once more under the profiler (launches, busy time, idle share): at
    the same size, or, for a part given `short` = (its size, a callable) and
    without KIN_PROFILE_FULL, that short call. The kernel entries counted
    over both (summed into `totals`): none may launch. Returns (fn's result,
    the numbers)."""
    for k in counted:
        k.launches = 0
    host_s, (out, reads) = timed(lambda: reads_in(fn))
    profiled, call = ("full", fn) if short is None or KIN_PROFILE_FULL else short
    stats = {"host_s": host_s, "reads": reads, "profiled": profiled,
             **profile_once(label, call)}
    stats["kernel_launches"] = {k.__name__: k.launches for k in counted}
    for name, n in stats["kernel_launches"].items():
        totals[name] = totals.get(name, 0) + n
    print(f"{label}: {host_s!r} s host; {reads} device reads; profiled call ({profiled}): "
          f"device busy {stats['busy_ms']!r} ms, {stats['launches']} launches, "
          f"{stats['idle']!r} idle; kernel entries {stats['kernel_launches']}")
    if any(stats["kernel_launches"].values()):
        fail(f"{label}: launched a kernel: {stats['kernel_launches']}")
    return out, stats


def kin_same_tree(label, got, want):
    """Parents, active masks and counts exactly, nodes (or poses) and costs
    within KIN_ATOL; gated. Returns the largest float difference."""
    for name in ("parents", "active", "count"):
        ctl_same(f"{label}: {name}", getattr(got, name), getattr(want, name))
    nodes = "nodes" if hasattr(got, "nodes") else "poses"
    return max(ctl_same(f"{label}: {nodes}", getattr(got, nodes), getattr(want, nodes), KIN_ATOL),
               ctl_same(f"{label}: costs", got.costs, want.costs, KIN_ATOL))


def kin_pose_pairs(n, dtype, device, seed=SEED + 260):
    r = np.random.default_rng(seed)
    a = np.concatenate([r.uniform(-5, 5, (n, 2)), r.uniform(-np.pi, np.pi, (n, 1))], 1)
    b = np.concatenate([r.uniform(-5, 5, (n, 2)), r.uniform(-np.pi, np.pi, (n, 1))], 1)
    return (torch.tensor(a, dtype=dtype, device=device), torch.tensor(b, dtype=dtype,
                                                                      device=device))


def kin_frenet(dtype, device):
    """bench_frenet's cycle: the reference's demo course and obstacles."""
    csp = pcurves.Spline2D.fit([0.0, 10.0, 20.5, 35.0, 70.5], [0.0, -6.0, 5.0, 6.5, 0.0],
                               dtype=dtype, device=device)
    obs = torch.tensor([[20.0, 10.0], [30.0, 6.0], [35.0, 8.0]], dtype=dtype, device=device)
    return csp, obs, pfrenet.frenet_optimal_plan(csp, 0.0, 10.0 / 3.6, 2.0, 0.0, 0.0, obs)


def kin_eta3(dtype, device):
    chain = peta3.eta3_path_coefficients([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0],
                                          [7.0, 3.0, math.pi / 2]], dtype=dtype, device=device)
    line = peta3.eta3_path_coefficients([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]], dtype=dtype,
                                        device=device)
    return (peta3.eta3_path_sample(chain, 200),
            peta3.eta3_trajectory_sample(line, max_vel=2.0, max_accel=1.0, num_points=100))


def kin_curves_part(card, device, counted):
    """(a) bench_frenet's cycle, `calc_spline_course` on its 5 waypoints,
    Dubins and Reeds-Shepp on 1024 pose pairs, η³ path and trajectory."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    (csp, obs, plan), stats = kin_part(f"frenet_optimal_plan (bench_frenet) f32 on {card}",
                                       lambda: kin_frenet(f32, device), counted)
    path = plan["path"].cpu().double()
    rx, ry = (float(v) for v in csp.calc_position(torch.zeros((), dtype=f32, device=device)))
    d = torch.linalg.vector_norm(path[:, None, :] - obs.cpu().double(), dim=-1)
    ok = (bool(plan["any_valid"]) and math.isfinite(float(plan["cost"]))
          and math.hypot(float(path[0, 0]) - rx, float(path[0, 1]) - ry) < 3.0
          and float(d.min()) > 2.0)
    _gate("frenet_optimal_plan: a valid plan clear of the obstacles (test_produces_valid_plan)",
          ok, f"cost {float(plan['cost'])!r}, {int(plan['num_valid'])} valid, min clearance "
              f"{float(d.min())!r}")
    got, want = kin_frenet(f64, device)[2], kin_frenet(f64, "cpu")[2]
    ctl_same("frenet_optimal_plan f64 cuda = CPU: best index", got["best_index"],
             want["best_index"])
    out["frenet"] = {**stats, "cost": float(plan["cost"]), "valid": int(plan["num_valid"]),
                     "f64_max_diff": ctl_same("frenet_optimal_plan f64 cuda = CPU: path",
                                              got["path"], want["path"])}

    wx, wy = [0.0, 2.0, 4.0, 6.0, 8.0], [0.0, 1.5, 0.0, -1.5, 0.0]
    course, stats = kin_part(f"calc_spline_course (5 waypoints, ds 0.1) f32 on {card}",
                             lambda: pcurves.calc_spline_course(wx, wy, 0.1, dtype=f32,
                                                                device=device), counted)
    px, py = course[0].cpu().double(), course[1].cpu().double()
    near = max(float(torch.min(torch.hypot(px - a, py - b))) for a, b in zip(wx, wy))
    _gate("calc_spline_course passes its waypoints (< 0.06) with finite curvature "
          "(test_course_properties)", near < 0.06 and bool(torch.isfinite(course[3]).all()),
          f"farthest waypoint {near!r}")
    out["spline_course"] = {**stats, "points": int(px.shape[0])}

    a, b = kin_pose_pairs(KIN_PAIRS, f32, device)
    (pts, total, word), stats = kin_part(
        f"dubins_shortest_path: {KIN_PAIRS} pose pairs x 200 samples f32 on {card}",
        lambda: pcurves.dubins_shortest_path(a, b, 1.0, 200), counted)
    end_err = float(torch.linalg.vector_norm(pts[:, -1, :2] - b[:, :2], dim=-1).max())
    yaw_err = float(torch.abs(torch.atan2(torch.sin(pts[:, -1, 2] - b[:, 2]),
                                          torch.cos(pts[:, -1, 2] - b[:, 2]))).max())
    lower = float((total - torch.linalg.vector_norm(b[:, :2] - a[:, :2], dim=-1)).min())
    _gate("dubins_shortest_path reaches every goal (test_endpoint_reached, f32: 1e-3)",
          end_err < 1e-3 and yaw_err < 1e-3 and lower >= -1e-4,
          f"end {end_err!r}, yaw {yaw_err!r}, total − chord >= {lower!r}")
    a64, b64 = kin_pose_pairs(64, f64, device)
    g = pcurves.dubins_shortest_path(a64, b64, 1.0, 50)
    w = pcurves.dubins_shortest_path(a64.cpu(), b64.cpu(), 1.0, 50)
    ctl_same("dubins_shortest_path 64 pairs f64 cuda = CPU: words", g[2], w[2])
    out["dubins"] = {**stats, "end_err": end_err, "f64_max_diff": ctl_same(
        "dubins_shortest_path 64 pairs f64 cuda = CPU: samples", g[0], w[0])}

    def rs():
        segs, steers, total = preeds.reeds_shepp_path(a, b, 1.0)
        return total, preeds.sample_reeds_shepp(a, segs, steers, 1.0, 200)

    (total, pts), stats = kin_part(
        f"reeds_shepp_path + sample: {KIN_PAIRS} pose pairs x 200 samples f32 on {card}", rs,
        counted)
    fin = torch.isfinite(total)
    end_err = float(torch.linalg.vector_norm(pts[fin][:, -1, :2] - b[fin][:, :2], dim=-1).max())
    share = float(fin.double().mean())
    # the three base words and their symmetries leave ~2 % of random pairs
    # without a word, in JAX too (0.9805 of these 1024 in f64 on the CPU)
    _gate("reeds_shepp_path: the samples of every pair with a word reach the goal "
          "(test_round2_batch, f32: 1e-3); >= 95 % of pairs have one",
          share >= 0.95 and end_err < 1e-3, f"{share!r} with a word, end {end_err!r}")
    g = preeds.reeds_shepp_path(a64, b64, 1.0)[2]
    w = preeds.reeds_shepp_path(a64.cpu(), b64.cpu(), 1.0)[2]
    # a tied CCC word pair may split by rounding; the total cannot
    out["reeds_shepp"] = {**stats, "end_err": end_err, "word_share": share, "f64_max_diff": ctl_same(
        "reeds_shepp_path 64 pairs f64 cuda = CPU: totals", g, w)}

    (pts, traj), stats = kin_part(f"eta3 path (200) and trajectory (100) samples f32 on {card}",
                                  lambda: kin_eta3(f32, device), counted)
    pts, st = pts.cpu().double(), traj["states"].cpu().double()
    knots = max(float(torch.linalg.vector_norm(pts - torch.tensor(p), dim=-1).min())
                for p in ([0.0, 0.0], [4.0, 0.0], [7.0, 3.0]))
    v = st[:, 3]
    ok = (knots < 0.08 and float(torch.diff(pts, dim=0).norm(dim=-1).max()) < 0.3
          and abs(float(v.max()) - 2.0) < 1e-5 and float(v[0]) < 0.25 and float(v[-1]) < 0.25
          and abs(float(st[-1, 0]) - 10.0) < 0.05)
    _gate("eta3 chain passes its knots; the trapezoid reaches cruise and the end "
          "(test_eta3_path_chain_continuous, test_eta3_trajectory_trapezoid; f32 cruise 1e-5)",
          ok, f"knots {knots!r}, v max {float(v.max())!r}, end x {float(st[-1, 0])!r}")
    g, w = kin_eta3(f64, device), kin_eta3(f64, "cpu")
    out["eta3"] = {**stats, "f64_max_diff": max(
        ctl_same("eta3_path_sample f64 cuda = CPU", g[0], w[0]),
        ctl_same("eta3_trajectory_sample f64 cuda = CPU", g[1]["states"], w[1]["states"]))}
    return out


def kin_draws(shape, dtype, device, seed):
    return torch.tensor(np.random.default_rng(seed).random(shape), dtype=dtype, device=device)


def kin_rrt(star, draws, dtype, device, cfg=None):
    cfg = cfg or prrt.RRTConfig(**KIN_RRT)
    obs, rad = KIN_COURSE
    return prrt.rrt_plan(None, [0.0, 0.0], [10.0, 10.0], obs, rad, cfg, star=star,
                         draws=draws, dtype=dtype, device=device)


def kin_path_clear(pts, mask, obs, rad, checks=20):
    """tests/test_rrt.py's `path_clear`: every segment sampled at `checks`
    points clears every circle (numpy, on the host)."""
    p = pts.cpu().double().numpy()[mask.cpu().numpy()]
    obs, rad = np.asarray(obs), np.asarray(rad)
    for a, b in zip(p[:-1], p[1:]):
        for t in np.linspace(0, 1, checks):
            if (np.linalg.norm(obs - (a + t * (b - a)), axis=-1) <= rad - 1e-6).any():
                return False
    return True


def kin_rrt_part(card, device, counted):
    """(b) bench_rrt_star's runs of KIN_RRT_SEEDS and a forest of 1024 RRT*
    trees."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    n = KIN_RRT["max_nodes"]
    runs = {}
    short_cfg = prrt.RRTConfig(**{**KIN_RRT, "max_nodes": KIN_PROFILE_NODES})
    for seed in KIN_RRT_SEEDS:
        for star in (False, True):
            d = kin_draws((n - 1, 3), f32, device, SEED + 270 + seed)
            (tree, best, cost), stats = kin_part(
                f"rrt_plan seed {seed} star {star}: {n} nodes (bench_rrt_star) f32 on {card}",
                lambda d=d, star=star: kin_rrt(star, d, f32, device), counted,
                (f"{KIN_PROFILE_NODES} nodes", lambda d=d, star=star: kin_rrt(
                    star, d[:KIN_PROFILE_NODES - 1], f32, device, short_cfg)))
            pts, mask = prrt.extract_rrt_path(tree, best)
            clear = kin_path_clear(pts, mask, *KIN_COURSE)
            _gate(f"rrt_plan seed {seed} star {star} finds a clear path (test_rrt_finds_feasible_"
                  f"path{'; RRT* < 2x the straight line' if star else ''})",
                  float(cost) < 1e17 and clear and (not star or float(cost) < 2 * math.hypot(10, 10)),
                  f"cost {float(cost)!r}, {int(tree.active.sum())} nodes")
            runs[f"seed{seed}_{'star' if star else 'rrt'}"] = {
                **stats, "cost": float(cost), "nodes": int(tree.active.sum())}
    out["bench_rrt_star"] = runs

    d = kin_draws((KIN_FOREST, n - 1, 3), f32, device, SEED + 272)
    (forest, best, cost), stats = kin_part(
        f"rrt_plan star: a forest of {KIN_FOREST} trees x {n} nodes f32 on {card}",
        lambda: kin_rrt(True, d, f32, device), counted,
        (f"{KIN_FOREST} trees x {KIN_PROFILE_NODES} nodes", lambda: kin_rrt(
            True, d[:, :KIN_PROFILE_NODES - 1], f32, device, short_cfg)))
    found = float((cost < 1e17).double().mean())
    _gate("rrt_plan star forest: most trees find the goal (test_rrt_forest_vmap: >= 3 of 4)",
          found >= 0.75, f"{found!r} of the trees")
    ctl_lanes(f"rrt_plan star forest of {KIN_FOREST}", (forest.nodes, forest.parents, cost),
              lambda i: (lambda t: (t[0].nodes, t[0].parents, t[2]))(kin_rrt(True, d[i], f32,
                                                                             device)))
    small = prrt.RRTConfig(**{**KIN_RRT, "max_nodes": 48})
    d64 = kin_draws((47, 3), f64, "cpu", SEED + 273)
    g = kin_rrt(True, d64.to(device), f64, device, small)
    w = kin_rrt(True, d64, f64, "cpu", small)
    ctl_same("rrt_plan star 48 nodes f64 cuda = CPU: best", g[1], w[1])
    out["forest"] = {**stats, "trees": KIN_FOREST, "found_share": found,
                     "f64_max_diff": kin_same_tree("rrt_plan star 48 nodes f64 cuda = CPU", g[0],
                                                   w[0])}
    return out


def kin_variants_part(card, device, counted):
    """(c) informed RRT*, RRT-connect, bidirectional RRT, FMT* and RRG at 256
    samples, BIT*, the Sobol RRT and `shortcut_path`."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    obs, rad = [[5.0, 5.0], [3.0, 6.0], [7.0, 4.0]], [1.0, 0.8, 0.8]  # test_rrt_variants.py's
    cfg = prrt.RRTConfig(expand_dis=1.0, max_nodes=300, connect_radius=2.5, goal_threshold=1.0)
    s, g = [0.0, 0.0], [10.0, 10.0]
    straight = math.hypot(10.0, 10.0)
    n = cfg.max_nodes
    short_cfg = dataclasses.replace(cfg, max_nodes=KIN_PROFILE_NODES)
    short = f"{KIN_PROFILE_NODES} nodes"

    def informed(c, dt, dev, seed=SEED + 280):
        return pvar.informed_rrt_star_plan(None, s, g, obs, rad, c, dtype=dt, device=dev,
                                           draws=kin_draws((c.max_nodes - 1, 5), dt, dev, seed))

    (tree, best, cost), stats = kin_part(f"informed_rrt_star_plan {n} nodes f32 on {card}",
                                         lambda: informed(cfg, f32, device), counted,
                                         (short, lambda: informed(short_cfg, f32, device)))
    pts, mask = prrt.extract_rrt_path(tree, best)
    _gate("informed_rrt_star_plan: a clear path, straight line <= cost < 2.2x it",
          float(cost) < pvar.BIG / 2 and kin_path_clear(pts, mask, obs, rad, 30)
          and straight - 1e-4 <= float(cost) < 2.2 * straight, f"cost {float(cost)!r}")
    out["informed"] = {**stats, "cost": float(cost)}

    for name, fn in (("rrt_connect_plan", pvar.rrt_connect_plan),
                     ("bidirectional_rrt_plan", pvar.bidirectional_rrt_plan)):
        def connect(c, dt, dev, fn=fn):
            return fn(None, s, g, obs, rad, c, dtype=dt, device=dev,
                      draws=kin_draws((c.max_nodes - 1, 2), dt, dev, SEED + 281))
        (trees, link, cost), stats = kin_part(f"{name} {n} nodes f32 on {card}",
                                              lambda connect=connect: connect(cfg, f32, device),
                                              counted, (short, lambda connect=connect: connect(
                                                  short_cfg, f32, device)))
        _gate(f"{name} joins its trees (test_rrt_connect_joins_trees)", float(cost) < pvar.BIG / 2,
              f"cost {float(cost)!r}")
        out[name] = {**stats, "cost": float(cost)}

    gcfg = pvar.GraphPlannerConfig(num_samples=256, connect_radius=2.5)

    def fmt(c, dt, dev):
        return pvar.fmt_star_plan(None, s, g, obs, rad, c, dtype=dt, device=dev,
                                  draws=kin_draws((c.num_samples, 2), dt, dev, SEED + 282))

    (nodes, idx, mask, cost), stats = kin_part(f"fmt_star_plan 256 samples f32 on {card}",
                                               lambda: fmt(gcfg, f32, device), counted)
    path = torch.gather(nodes, 0, idx[:, None].expand(-1, 2))
    # a graph planner checks an edge at its own `edge_checks` points; an
    # r-disk edge (up to 2.5-3 m) may clip a circle between them, in JAX too
    _gate("fmt_star_plan: a path clear at its edge checks (test_fmt_star_plans_free_path)",
          float(cost) < pvar.BIG / 2 and kin_path_clear(path, mask, obs, rad, gcfg.edge_checks),
          f"cost {float(cost)!r}, clear at 30 points an edge: "
          f"{kin_path_clear(path, mask, obs, rad, 30)}")
    small = pvar.GraphPlannerConfig(num_samples=48, connect_radius=3.0)
    gg, ww = fmt(small, f64, device), fmt(small, f64, "cpu")
    ctl_same("fmt_star_plan 48 samples f64 cuda = CPU: path", gg[1], ww[1])
    out["fmt_star"] = {**stats, "cost": float(cost), "f64_max_diff": ctl_same(
        "fmt_star_plan 48 samples f64 cuda = CPU: cost", gg[3], ww[3])}

    rcfg = prrt.RRTConfig(expand_dis=1.0, max_nodes=256, connect_radius=2.5, goal_threshold=1.0)

    def rrg(c, dt, dev):
        return pvar.rrg_plan(None, s, g, obs, rad, c, dtype=dt, device=dev,
                             draws=kin_draws((c.max_nodes - 1, 3), dt, dev, SEED + 283))

    (nodes, idx, mask, cost), stats = kin_part(
        f"rrg_plan 256 nodes f32 on {card}", lambda: rrg(rcfg, f32, device), counted,
        (short, lambda: rrg(dataclasses.replace(rcfg, max_nodes=KIN_PROFILE_NODES), f32, device)))
    path = torch.gather(nodes, 0, idx[:, None].expand(-1, 2))
    _gate("rrg_plan: a path clear at its edge checks (test_rrg_plans_free_path)",
          float(cost) < pvar.BIG / 2 and kin_path_clear(path, mask, obs, rad, rcfg.edge_checks),
          f"cost {float(cost)!r}, clear at 30 points an edge: "
          f"{kin_path_clear(path, mask, obs, rad, 30)}")
    out["rrg"] = {**stats, "cost": float(cost)}

    bcfg = pvar.GraphPlannerConfig(num_samples=0, connect_radius=3.0, batches=4, batch_size=96)

    def bit(c, dt, dev):
        return pvar.bit_star_plan(None, s, g, obs, rad, c, dtype=dt, device=dev,
                                  draws=kin_draws((c.batches, c.batch_size, 4), dt, dev,
                                                  SEED + 284))

    (nodes, idx, mask, cost, hist), stats = kin_part(
        f"bit_star_plan 4 batches x 96 f32 on {card}", lambda: bit(bcfg, f32, device), counted)
    path = torch.gather(nodes, 0, idx[:, None].expand(-1, 2))
    h = hist.cpu().double()
    clear = kin_path_clear(path, mask, obs, rad, bcfg.edge_checks)
    _gate("bit_star_plan: a path clear at its edge checks, cost never rising over the batches "
          "(test_bit_star_monotone_improvement)",
          float(cost) < pvar.BIG / 2 and bool((torch.diff(h) <= 1e-6).all()) and clear,
          f"history {h.tolist()}, clear at 30 points an edge: "
          f"{kin_path_clear(path, mask, obs, rad, 30)}")
    out["bit_star"] = {**stats, "cost": float(cost)}

    (tree, best, cost), stats = kin_part(
        f"rrt_sobol_plan {n} nodes f32 on {card}",
        lambda: pvar.rrt_sobol_plan(s, g, obs, rad, cfg, dtype=f32, device=device), counted,
        (short, lambda: pvar.rrt_sobol_plan(s, g, obs, rad, short_cfg, dtype=f32, device=device)))
    again = pvar.rrt_sobol_plan(s, g, obs, rad, cfg, dtype=f32, device=device)
    pts, mask = prrt.extract_rrt_path(tree, best)
    _gate("rrt_sobol_plan: a clear path, the same on a second run "
          "(test_rrt_sobol_deterministic_plan)",
          float(cost) < pvar.BIG / 2 and bitwise_equal(cost, again[2])
          and kin_path_clear(pts, mask, obs, rad, 30), f"cost {float(cost)!r}")
    out["sobol"] = {**stats, "cost": float(cost)}

    wiggly = torch.tensor([[0.0, 0.0], [0.0, 3.0], [1.0, 8.0], [2.0, 9.5], [5.0, 9.8],
                           [8.0, 9.9], [10.0, 10.0]], dtype=f32, device=device)
    keep0 = torch.ones(7, dtype=torch.bool, device=device)
    sd = kin_draws((64, 2), f32, device, SEED + 285)
    (_, keep, length), stats = kin_part(
        f"shortcut_path 64 iterations f32 on {card}",
        lambda: pvar.shortcut_path(None, wiggly, keep0, obs, rad, iters=64, draws=sd), counted)
    before = float(torch.linalg.vector_norm(torch.diff(wiggly, dim=0), dim=-1).sum())
    kept = wiggly[keep]
    _gate("shortcut_path keeps the ends and shortens a clear path (test_shortcut_path_reduces_"
          "length)", bool(keep[0]) and bool(keep[-1]) and float(length) <= before + 1e-4
          and kin_path_clear(kept, torch.ones(len(kept), dtype=torch.bool), obs, rad, 30),
          f"{before!r} -> {float(length)!r}")
    out["shortcut"] = {**stats, "before": before, "after": float(length)}
    return out


def kin_kinematic(name, draws, dtype, device, nodes=96):
    """tests/test_rrt_kinematic.py's course and configuration; draws [...,
    nodes − 1, 4] (leading dims: the forest)."""
    fn = {"rrt_dubins": pkin.rrt_dubins_plan, "rrt_star_dubins": pkin.rrt_star_dubins_plan,
          "rrt_star_reeds_shepp": pkin.rrt_star_reeds_shepp_plan}[name]
    cfg = pkin.KinematicRRTConfig(max_nodes=nodes, curvature=0.8, connect_radius=5.0)
    return fn(None, [0.0, 0.0, 0.0], [9.0, 9.0, math.pi / 2], *KIN_KCOURSE, cfg, draws=draws,
              dtype=dtype, device=device)


def kin_kinematic_part(card, device, counted):
    """(d) the Dubins and Reeds-Shepp RRT/RRT* at the tests' configuration
    (16 lanes of KIN_KNODES of their 96 nodes), closed-loop RRT*, LQR-RRT* at
    200 nodes."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    goal = torch.tensor([9.0, 9.0, math.pi / 2], dtype=f32, device=device)
    obs, rad = (np.asarray(v) for v in KIN_KCOURSE)
    d = kin_draws((KIN_KLANES, KIN_KNODES - 1, 4), f32, device, SEED + 290)
    for name in ("rrt_dubins", "rrt_star_dubins", "rrt_star_reeds_shepp"):
        (tree, best, cost), stats = kin_part(
            f"{name}: {KIN_KLANES} trees x {KIN_KNODES} nodes f32 on {card}",
            lambda name=name: kin_kinematic(name, d, f32, device, nodes=KIN_KNODES), counted,
            short=(f"{KIN_KLANES} trees x 3 nodes",
                   lambda name=name: kin_kinematic(name, d[:, :2], f32, device, nodes=3)))
        found = cost < 1e17
        poses, mask = pkin.extract_pose_path(tree, best, goal, 0.8,
                                             reeds_shepp=name.endswith("shepp"))
        bad = []
        for lane in torch.nonzero(found).flatten().tolist():
            kept = poses[lane][mask[lane]].cpu().double().numpy()
            clearance = np.linalg.norm(kept[:, None, :2] - obs[None], axis=-1)
            end = np.linalg.norm(kept[-1, :2] - [9.0, 9.0])
            if not (np.all(clearance > rad[None] - 1e-6) and end < 0.05):
                bad.append(lane)
        share = float(found.double().mean())
        _gate(f"{name}: most of {KIN_KLANES} trees find a path; every path clear, ending at the "
              f"goal (test_rrt_kinematic.py)", share >= 0.5 and not bad,
              f"{share!r} found, bad lanes {bad}")
        # a solo run costs what the forest does (launch-bound): the Dubins
        # RRT* checks its first and last lanes, the others their last
        lanes = (0, KIN_KLANES - 1) if name == "rrt_star_dubins" else (KIN_KLANES - 1,)
        ctl_lanes(name, (tree.poses, tree.parents, cost),
                  lambda i, name=name: (lambda t: (t[0].poses, t[0].parents, t[2]))(
                      kin_kinematic(name, d[i], f32, device, nodes=KIN_KNODES)), lanes=lanes)
        out[name] = {**stats, "found_share": share, "best_cost": float(cost.min())}
    d64 = kin_draws((2, 23, 4), f64, "cpu", SEED + 293)
    g = kin_kinematic("rrt_star_dubins", d64.to(device), f64, device, nodes=24)
    w = kin_kinematic("rrt_star_dubins", d64, f64, "cpu", nodes=24)
    out["rrt_star_dubins"]["f64_max_diff"] = kin_same_tree(
        "rrt_star_dubins 2 x 24 nodes f64 cuda = CPU", g[0], w[0])

    cfg = pkin.KinematicRRTConfig(max_nodes=96, curvature=0.8, connect_radius=5.0)

    def closed(steps, nodes=96, c=cfg):
        return pkin.closed_loop_rrt_star_plan(
            None, [0.0, 0.0, 0.0], [9.0, 9.0, math.pi / 2], *KIN_KCOURSE, c, target_speed=1.2,
            sim_steps=steps, draws=kin_draws((nodes - 1, 4), f32, device, SEED + 291),
            dtype=f32, device=device)

    (traj, tree, cost, report), stats = kin_part(
        f"closed_loop_rrt_star_plan 96 nodes x 300 steps f32 on {card}", lambda: closed(300),
        counted, short=("3 nodes x 15 steps", lambda: closed(15, 3, pkin.KinematicRRTConfig(
            max_nodes=3, curvature=0.8, connect_radius=5.0))))
    v = traj[:, 3]
    ok = (float(cost) < 1e17 and bool(report["tracked_collision_free"])
          and float(report["min_goal_distance"]) < 2.0 and bool(torch.isfinite(traj).all())
          and float(v.max()) <= 2.4 + 1e-6)
    _gate("closed_loop_rrt_star_plan tracks its plan clear of the obstacles "
          "(test_closed_loop_rrt_star_tracks_plan)", ok,
          f"cost {float(cost)!r}, min goal distance {float(report['min_goal_distance'])!r}")
    out["closed_loop"] = {**stats, "cost": float(cost),
                          "min_goal_distance": float(report["min_goal_distance"])}

    lcfg = pkin.LQRRRTConfig(max_nodes=200)

    def lqr(c, dt, dev):
        return pkin.lqr_rrt_star_plan(None, [0.0, 0.0, 0.0, 0.0], [8.0, 8.0, 0.0, 0.0],
                                      *KIN_KCOURSE, c, dtype=dt, device=dev,
                                      draws=kin_draws((c.max_nodes - 1, 3), dt, dev, SEED + 292))

    (tree, best, cost), stats = kin_part(
        f"lqr_rrt_star_plan 200 nodes f32 on {card}", lambda: lqr(lcfg, f32, device), counted,
        short=("12 nodes", lambda: lqr(pkin.LQRRRTConfig(max_nodes=12), f32, device)))
    nodes = tree["nodes"].cpu().double().numpy()
    parents = tree["parents"].cpu().numpy()
    chain_ok, cur, seen = True, int(best), 0
    while cur >= 0 and seen < lcfg.max_nodes:
        chain_ok &= bool(np.all(np.linalg.norm(nodes[cur, :2] - obs, axis=-1) > rad - 1e-6))
        cur, seen = int(parents[cur]), seen + 1
    end = float(np.linalg.norm(nodes[int(best), :2] - [8.0, 8.0]))
    _gate("lqr_rrt_star_plan reaches the goal region along clear nodes "
          "(test_lqr_rrt_star_reaches_goal_region)",
          float(cost) < 1e17 and end <= lcfg.goal_threshold and chain_ok,
          f"cost {float(cost)!r}, end {end!r}")
    small = pkin.LQRRRTConfig(max_nodes=32)
    g, w = lqr(small, f64, device), lqr(small, f64, "cpu")
    ctl_same("lqr_rrt_star_plan 32 nodes f64 cuda = CPU: parents", g[0]["parents"],
             w[0]["parents"])
    out["lqr_rrt_star"] = {**stats, "cost": float(cost), "f64_max_diff": ctl_same(
        "lqr_rrt_star_plan 32 nodes f64 cuda = CPU: nodes", g[0]["nodes"], w[0]["nodes"])}
    return out


def kin_reactive_part(card, device, counted):
    """(e) the elastic band, DMP, PSO with 64 particles, `lqr_plan`, and
    Bug2 and tangent Bug on the host."""
    out = {}
    f32, f64 = torch.float32, torch.float64

    def band(dt, dev):
        xs = torch.linspace(0.0, 10.0, 21, dtype=dt, device=dev)
        return preactive.elastic_band_optimize(torch.stack([xs, torch.zeros_like(xs)], -1),
                                               [[5.0, 0.0]], [1.0])

    pts, stats = kin_part(f"elastic_band_optimize 21 points x 100 iterations f32 on {card}",
                          lambda: band(f32, device), counted)
    d = float(torch.linalg.vector_norm(pts - torch.tensor([5.0, 0.0], device=device), dim=-1).min())
    _gate("elastic_band_optimize pushes off the obstacle, ends fixed "
          "(test_elastic_band_pushes_off_obstacle)",
          d > 0.8 and float(pts[0].abs().max()) == 0.0 and float(pts[-1, 0]) == 10.0, f"{d!r}")
    out["elastic_band"] = {**stats, "min_distance": d,
                           "f64_max_diff": ctl_same("elastic_band f64 cuda = CPU",
                                                    band(f64, device), band(f64, "cpu"))}

    def dmp(dt, dev):
        t = torch.arange(100, dtype=dt, device=dev) * 0.01
        demo = torch.stack([torch.sin(2 * math.pi * t), t**2], -1)
        w, (y0, g) = preactive.dmp_fit(demo, 0.01)
        return demo, preactive.dmp_rollout(w, y0, g, 100, 0.01)

    (demo, roll), stats = kin_part(f"dmp_fit + dmp_rollout 100 steps f32 on {card}",
                                   lambda: dmp(f32, device), counted)
    end = float((roll[-1] - demo[-1]).abs().max())
    err = float((roll - demo).abs().mean())
    _gate("dmp reproduces its demonstration (test_dmp_reproduces_demo)", end < 0.08 and err < 0.12,
          f"end {end!r}, mean {err!r}")
    out["dmp"] = {**stats, "mean_error": err, "f64_max_diff": ctl_same(
        "dmp f64 cuda = CPU", dmp(f64, device)[1], dmp(f64, "cpu")[1])}

    def pso(dt, dev):
        target = torch.tensor([2.0, -3.0], dtype=dt, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 300)
        return preactive.pso_minimize(gen, lambda x: ((x - target) ** 2).sum(-1), 2,
                                      num_particles=64, dtype=dt, device=dev)

    (best, val), stats = kin_part(f"pso_minimize 64 particles x 100 iterations f32 on {card}",
                                  lambda: pso(f32, device), counted)
    off = float((best.cpu().double() - torch.tensor([2.0, -3.0], dtype=f64)).abs().max())
    _gate("pso_minimize finds the minimum (test_pso_finds_minimum)", off < 0.05 and float(val) < 1e-2,
          f"off {off!r}, value {float(val)!r}")
    out["pso"] = {**stats, "off": off}

    traj, stats = kin_part(f"lqr_plan 120 steps f32 on {card}",
                           lambda: preactive.lqr_plan([0.0, 0.0], [6.0, -4.0], steps=120,
                                                      dtype=f32, device=device), counted)
    off = float((traj[-1].cpu().double() - torch.tensor([6.0, -4.0], dtype=f64)).abs().max())
    _gate("lqr_plan reaches the goal (test_lqr_plan_reaches_goal)", off < 0.1, f"{off!r}")
    g = preactive.lqr_plan([0.0, 0.0], [6.0, -4.0], steps=40, dtype=f64, device=device)
    w = preactive.lqr_plan([0.0, 0.0], [6.0, -4.0], steps=40, dtype=f64, device="cpu")
    out["lqr_plan"] = {**stats, "off": off,
                       "f64_max_diff": ctl_same("lqr_plan f64 cuda = CPU", g, w)}

    wall = np.zeros((30, 30), bool)
    wall[14:16, 0:22] = True
    box = np.zeros((20, 20), bool)
    box[8:12, 5:15] = True
    t0 = time.perf_counter()
    path, reached = preactive.bug2_plan(wall, (2, 10), (28, 10))
    tpath, treached = preactive.tangent_bug_plan(box, (2, 10), (18, 10), sensor_range=5.0)
    host_s = time.perf_counter() - t0
    ok = (reached and len(path) > 30 and not wall[path[:, 0], path[:, 1]].any() and treached
          and not box[tpath[:, 0], tpath[:, 1]].any())
    _gate("bug2_plan and tangent_bug_plan reach their goals on free cells (host)", ok,
          f"{len(path)} and {len(tpath)} cells")
    out["bug"] = {"host_s": host_s, "bug2_cells": len(path), "tangent_cells": len(tpath)}
    return out


def kin_hybrid(side, headings, dtype, device):
    """tests/test_hybrid_astar.py's detour scaled to a side² map: a wall
    across the middle, the goal beyond it."""
    blocked = np.zeros((side, side), bool)
    blocked[side * 9 // 20:side * 11 // 20, side // 8:side * 7 // 8] = True
    costs = phybrid.hybrid_astar_costs(~blocked, (side // 2, side - 2), headings // 4,
                                       n_theta=headings, dtype=dtype, device=device)
    return blocked, costs


def kin_grid_part(card, device, counted):
    """(f) `hybrid_astar_costs` on 128² x 16 headings, the lattice lookup
    table, the clothoid, CHOMP and the bipedal plan."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    side, headings = KIN_HYBRID
    (blocked, costs), stats = kin_part(
        f"hybrid_astar_costs {side}² x {headings} headings f32 on {card}",
        lambda: kin_hybrid(side, headings, f32, device), counted)
    start = (side // 2, 2)
    c = float(costs[headings // 4, start[0], start[1]])
    # the host descent compares its f64 sums at 1e-9, so it walks the f64 field
    c64 = kin_hybrid(side, headings, f64, device)[1]
    states, _, total = phybrid.extract_hybrid_path(c64, ~blocked, start, headings // 4,
                                                   n_theta=headings)
    clear = not any(blocked[int(x), int(y)] for x, y, _ in states)
    fin = torch.isfinite(c64)
    f32_rel = float(((costs.double() - c64)[fin] / c64[fin].clamp(min=1.0)).abs().max())
    _gate("hybrid_astar_costs: the detour is finite, longer than the straight line, its path "
          "clear to the goal (test_obstacle_detour); f32 within 1e-5 of f64",
          math.isfinite(c) and c > side - 4 and clear and len(states) > 10
          and tuple(int(v) for v in states[-1][:2]) == (side // 2, side - 2) and f32_rel < 1e-5,
          f"cost {c!r}, {len(states)} states, f32 rel {f32_rel!r}")
    g = kin_hybrid(32, 8, f64, device)[1]
    w = kin_hybrid(32, 8, f64, "cpu")[1]
    _gate("hybrid_astar_costs 32² x 8 f64 cuda = CPU bitwise", bitwise_equal(g.cpu(), w),
          "bitwise")
    out["hybrid_astar"] = {**stats, "cost": c, "path_states": len(states)}

    lut = lambda dt, dev: plattice.generate_lookup_table(  # noqa: E731
        [4.0, 6.0], [-1.0, 0.0, 1.0], [-0.3, 0.0, 0.3], dtype=dt, device=dev)
    (params, errs, _), stats = kin_part(
        f"generate_lookup_table 18 targets f32 on {card}", lambda: lut(f32, device), counted,
        short=("2 targets", lambda: plattice.generate_lookup_table(
            [4.0], [0.0], [0.0, 0.3], dtype=f32, device=device)))
    med = float(errs.median())
    _gate("generate_lookup_table converges (test_lookup_table_generation; f32 median < 1e-3)",
          med < 1e-3 and bool((params[:, 0] > 0).all()), f"median error {med!r}")
    out["lookup_table"] = {**stats, "median_error": med, "f64_max_diff": ctl_same(
        "generate_lookup_table f64 cuda = CPU", lut(f64, device)[0], lut(f64, "cpu")[0])}

    clo = lambda dt, dev: plattice.clothoid_path([5.0, 2.0, 0.6], dtype=dt, device=dev)  # noqa
    (poses, p, err), stats = kin_part(
        f"clothoid_path 60 iterations f32 on {card}", lambda: clo(f32, device), counted,
        short=("6 iterations", lambda: plattice.clothoid_path([5.0, 2.0, 0.6], iterations=6,
                                                              dtype=f32, device=device)))
    end = float((poses[-1, :2].cpu().double() - torch.tensor([5.0, 2.0], dtype=f64)).abs().max())
    _gate("clothoid_path reaches its pose (test_clothoid_reaches_pose_with_linear_curvature)",
          float(err) < 5e-3 and end < 5e-3, f"error {float(err)!r}")
    out["clothoid"] = {**stats, "error": float(err)}

    ch = pchomp.ChompConfig(n_waypoints=40, max_iterations=200, learning_rate=0.02,
                            obstacle_cost_weight=5.0)
    run = lambda dt, dev: pchomp.chomp_optimize([0.0, 0.0], [10.0, 0.0], [[5.0, 0.0]], [1.0], ch,  # noqa
                                                dtype=dt, device=dev)
    (x, cost, iters), stats = kin_part(
        f"chomp_optimize 40 waypoints f32 on {card}", lambda: run(f32, device), counted,
        short=("20 iterations", lambda: pchomp.chomp_optimize(
            [0.0, 0.0], [10.0, 0.0], [[5.0, 0.0]], [1.0],
            dataclasses.replace(ch, max_iterations=20), dtype=f32, device=device)))
    xh = x.cpu().double()
    mid = xh[torch.argmin((xh[:, 0] - 5.0).abs())]
    _gate("chomp_optimize bows the path off the obstacle (test_chomp_clears_obstacle_and_"
          "reduces_cost)", int(iters) > 1 and float(torch.linalg.vector_norm(
              mid - torch.tensor([5.0, 0.0], dtype=f64))) > 1.0 and bool(torch.isfinite(xh).all()),
          f"{int(iters)} iterations, cost {float(cost)!r}")
    g, w = run(f64, device), run(f64, "cpu")
    ctl_same("chomp_optimize f64 cuda = CPU: iterations", g[2], w[2])
    out["chomp"] = {**stats, "iterations": int(iters),
                    "f64_max_diff": ctl_same("chomp_optimize f64 cuda = CPU: waypoints", g[0],
                                             w[0])}

    steps = [[0.0, 0.2, 0.0]] + [[0.3, 0.2, 0.0]] * 6 + [[0.0, 0.2, 0.0]]
    plan, stats = kin_part(
        f"bipedal_plan 8 steps f32 on {card}",
        lambda: pbipedal.bipedal_plan(steps, dtype=f32, device=device), counted,
        short=("3 steps", lambda: pbipedal.bipedal_plan(steps[:3], dtype=f32, device=device)))
    refs, mods = plan["reference_footsteps"].cpu(), plan["modified_footsteps"].cpu()
    com = plan["com_trajectory"].cpu()
    ok = (bool(torch.isfinite(com).all()) and float(refs[-1, 0]) > float(refs[1, 0])
          and float((mods[2:, :2] - refs[2:, :2]).abs().max()) < 0.5
          and float(com[:, 1].max() - com[:, 1].min()) > 0.05 and float(com[-1, 0]) > 1.0)
    _gate("bipedal_plan walks and tracks (test_bipedal_straight_walk_converges_and_tracks)", ok,
          f"com end x {float(com[-1, 0])!r}")
    g = pbipedal.bipedal_plan(steps, dtype=f64, device=device)["com_trajectory"]
    w = pbipedal.bipedal_plan(steps, dtype=f64, device="cpu")["com_trajectory"]
    out["bipedal"] = {**stats, "f64_max_diff": ctl_same("bipedal_plan f64 cuda = CPU", g, w)}
    return out


def kin_tf32_part(card, device):
    """(g) The solver paths (the spline and Frenet solves, the lattice's
    Gauss-Newton, LQR-RRT*'s gain) give the same bits with TF32 allowed."""
    f32 = torch.float32

    def runs():
        return {"frenet": kin_frenet(f32, device)[2]["path"],
                "lookup_table": plattice.generate_lookup_table([4.0], [1.0], [0.3], dtype=f32,
                                                               device=device)[0],
                "lqr_rrt_star": pkin.lqr_rrt_star_plan(
                    None, [0.0, 0.0, 0.0, 0.0], [8.0, 8.0, 0.0, 0.0], *KIN_KCOURSE,
                    pkin.LQRRRTConfig(max_nodes=16), dtype=f32, device=device,
                    draws=kin_draws((15, 3), f32, device, SEED + 292))[0]["nodes"]}

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = runs()
        torch.set_float32_matmul_precision("high")
        got = runs()
    finally:
        torch.set_float32_matmul_precision(saved)
    bad = [k for k in want if not bitwise_equal(got[k], want[k])]
    _gate(f"kinematic planners' solver paths with TF32 allowed bitwise their 'highest' runs on "
          f"{card}", not bad, f"differ: {bad}" if bad else "bitwise")
    return {"tf32_bitwise": sorted(want)}


def kinematic_phase(card, device, counted):
    """The kinematic planners (phase 24): (a) curves, Frenet, Dubins,
    Reeds-Shepp, η³; (b) RRT/RRT* and a forest; (c) the variants; (d) the
    kinematic RRTs; (e) the reactive planners; (f) hybrid A*, the lattice,
    CHOMP, bipedal; (g) TF32."""
    out = {"card": card}
    KIN_KERNEL_LAUNCHES.clear()
    start = time.perf_counter()
    for name, part in (("curves", kin_curves_part), ("rrt", kin_rrt_part),
                       ("variants", kin_variants_part), ("kinematic", kin_kinematic_part),
                       ("reactive", kin_reactive_part), ("grid", kin_grid_part)):
        t0 = time.perf_counter()
        out[name] = part(card, device, counted)
        out[name]["part_s"] = time.perf_counter() - t0
        print(f"kinematic planning, part {name}: {out[name]['part_s']!r} s")
    out["tf32"] = kin_tf32_part(card, device)
    out["phase_s"] = time.perf_counter() - start
    out["kernel_launches"] = dict(KIN_KERNEL_LAUNCHES)
    print(f"kinematic planning: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']}")
    return out


# phase 25: the rigid-body and BranchOut planners, the aerial, meta and
# arena controllers, the compaction serving runner, the experiment suites,
# utils/ and viz/ (no kernel on their path)
BRD_FLEET = 1024
BRD_META_STEPS = 200  # bench_meta_control
BRD_LANES = (0, 511, 1023)
BRD_LANE_STEPS = 4  # steps of a lane's solo run held to the fleet's
BRD_SMALL, BRD_SMALL_STEPS = 16, 10  # the f64 cuda = CPU runs
BRD_ATOL = 1e-9
BRD_WPS = ((0.0, 0.0, 1.0), (2.0, 1.0, 2.0), (4.0, -1.0, 1.5), (6.0, 0.0, 1.0))  # the JAX test's
BRD_SNAP = ((0.0, 1.0, -0.5, 2.0), (1.0, 1.0, 1.5))  # waypoints, segment times
BRD_WALL = (3.5, 6.5, 0.0, 6.0)  # tests/test_breadth_planners.py's obstacle
BRD_START, BRD_GOAL = (1.0, 1.0, 0.0), (9.0, 1.0, 0.0)
BRD_SCENES = ("simple_overtake", "wide_overtake", "forced_yield")
BRD_COMPACT_SMALL = dict(size=100, batch=6, chunk_iters=5, max_rounds=5)
BRD_ARENA_F64_STEPS = 20
BRD_ARENA_STEPS = 300  # of run_controller_arena's 600; phase 27's registry runs its bench's 500
BRD_UKF_STEPS = 60  # the UKF/CKF suite's steps (its default 120)
BRD_KERNEL_LAUNCHES = {}


def brd_part(label, fn, counted, short=None):
    """kin_part, its kernel entries summed into phase 25's totals."""
    return kin_part(label, fn, counted, short, totals=BRD_KERNEL_LAUNCHES)


def brd_meta(state, pts, mask, steps):
    """bench_meta_control's loop over a fleet: pure pursuit the primary, the
    LQR speed-steer law the fallback (both at 3 m/s), the latch on the EMA
    of the cross-track error. Returns (states [steps, ..., 4], use, ema)."""
    cfg = cmeta.LQRSpeedSteerConfig(wheelbase=2.9)
    speed = torch.full_like(mask, 3.0)
    zero = torch.zeros_like(state[..., 0])
    errs = [zero, zero]  # the fallback's (e, θe), threaded from step to step
    use, ema = zero > 0, zero

    def fallback(s):
        accel, steer, errs[:] = cmeta.lqr_speed_steer_control(s, pts, mask, speed, *errs, cfg)
        return accel, steer, tuple(errs)

    traj = []
    for _ in range(steps):
        accel, steer, use, ema = cmeta.meta_control_step(
            state, pts, mask, 3.0, use, ema,
            lambda s: ctrack.pure_pursuit_control(s, pts, mask, 3.0), fallback)
        state = ctrack.bicycle_kinematics(state, accel, steer, 0.1, 2.9)
        traj.append(state)
    return torch.stack(traj), use, ema


def brd_controllers_part(card, device, counted):
    """(a) The meta controller over a fleet on bench_meta_control's path, the
    controller arena at BRD_ARENA_STEPS of its 600 steps, the quintic and
    minimum-snap flights."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 250)
    # around bench_meta_control's start (0, -1, 0.2, 1)
    starts = np.stack([rng.uniform(0.0, 1.0, BRD_FLEET), rng.uniform(-1.5, -0.5, BRD_FLEET),
                       rng.uniform(0.0, 0.4, BRD_FLEET), rng.uniform(0.5, 1.5, BRD_FLEET)], -1)
    pts, mask = ctl_course(device, f32)
    s32 = torch.tensor(starts, dtype=f32, device=device)
    (traj, use, ema), stats = brd_part(
        f"meta control (pure pursuit, LQR speed-steer fallback): {BRD_FLEET} vehicles x "
        f"{BRD_META_STEPS} steps f32 on {card}",
        lambda: brd_meta(s32, pts, mask, BRD_META_STEPS), counted,
        short=("1 step", lambda: brd_meta(s32, pts, mask, 1)))
    x = traj[-1, :, 0]
    _gate(f"meta control: every vehicle past x = 25 after {BRD_META_STEPS} steps, the EMA finite "
          f"(tests/test_meta_p2p.py's gates)", bool((x > 25.0).all() and torch.isfinite(ema).all()),
          f"min x {float(x.min())!r}, {int(use.sum())} vehicles on the fallback at the end")
    ctl_lanes(f"meta control f32, {BRD_LANE_STEPS} steps",
              brd_meta(s32, pts, mask, BRD_LANE_STEPS)[0][-1],
              lambda i: brd_meta(s32[i], pts, mask, BRD_LANE_STEPS)[0][-1], BRD_LANES)
    small = torch.tensor(starts[:BRD_SMALL], dtype=f64)
    got = brd_meta(small.to(device), *ctl_course(device, f64), BRD_SMALL_STEPS)
    want = brd_meta(small, *ctl_course("cpu", f64), BRD_SMALL_STEPS)
    d = ctl_same(f"meta control: {BRD_SMALL} vehicles x {BRD_SMALL_STEPS} steps f64 cuda = CPU",
                 got[0], want[0], BRD_ATOL)
    ctl_same("meta control: latches f64 cuda = CPU", got[1], want[1])
    out["meta"] = {**stats, "vehicles": BRD_FLEET, "steps": BRD_META_STEPS,
                   "min_x": float(x.min()), "on_fallback": int(use.sum()), "f64_max_diff": d}
    brd_state = {"states": traj[-1], "use": use, "ema": ema}

    (res, (header, rows)), stats = brd_part(
        f"run_controller_arena ({BRD_ARENA_STEPS} steps, three controllers) f32 on {card}",
        lambda: carena.run_controller_arena(steps=BRD_ARENA_STEPS, device=device), counted,
        short=("1 step", lambda: carena.run_controller_arena(steps=1, device=device)))
    ok = all(m["cross_track_rmse"] < 1.0 and m["progress"] > 20.0 for m in res.values())
    _gate("controller arena: every controller's cross-track RMSE < 1 and progress > 20 m "
          "(tests/test_aux.py's gates)", ok, f"{res}")
    with tempfile.TemporaryDirectory() as tmp:
        texts = [open(ugate.write_csv(os.path.join(tmp, f"{k}.csv"), *carena.run_controller_arena(
            steps=BRD_ARENA_F64_STEPS, dtype=f64, device=dev)[1])).read()
            for k, dev in (("cuda", device), ("cpu", "cpu"))]
    problems = ugate.compare_csv(texts[1], texts[0])
    _gate(f"controller arena, {BRD_ARENA_F64_STEPS} steps f64: the CSV gate holds cuda against "
          f"the CPU", not problems, f"{problems or 'passes (the elapsed_ms column ignored)'}")
    out["arena"] = {**stats, "metrics": res, "elapsed_ms": {r[0]: r[-1] for r in rows}}

    wps = torch.tensor(BRD_WPS, dtype=f32, device=device)
    (ps, refs), stats = brd_part(f"quintic segments + PD quadrotor (300 steps) f32 on {card}",
                                 lambda: caerial.simulate_quadrotor(
                                     caerial.quintic_3d_segments(wps, 2.0), 2.0), counted,
                                 short=("one segment, 100 steps", lambda: caerial.simulate_quadrotor(
                                     caerial.quintic_3d_segments(wps[:2], 2.0), 2.0)))
    err = float(torch.linalg.vector_norm(ps - refs, dim=-1).max())
    end = float(torch.linalg.vector_norm(ps[-1] - wps[-1]))
    _gate("quadrotor: tracking error < 0.3 m, the flight ends within 0.2 m of the last waypoint "
          "(tests/test_control_families.py's gates)", err < 0.3 and end < 0.2,
          f"max error {err!r}, end {end!r}")
    fleet = caerial.quintic_3d_segments(wps + torch.linspace(0.0, 1.0, 4, device=device)[:, None,
                                                                                       None], 2.0)
    flights = caerial.simulate_quadrotor(fleet, 2.0)
    ctl_lanes("quadrotor flights f32", flights,
              lambda i: caerial.simulate_quadrotor(fleet[i], 2.0), (0, 3))
    wps64 = torch.tensor(BRD_WPS, dtype=f64)
    d = ctl_same("quadrotor f64 cuda = CPU", caerial.simulate_quadrotor(
        caerial.quintic_3d_segments(wps64.to(device), 2.0), 2.0)[0],
        caerial.simulate_quadrotor(caerial.quintic_3d_segments(wps64, 2.0), 2.0)[0], BRD_ATOL)
    out["quadrotor"] = {**stats, "max_error": err, "end_error": end, "f64_max_diff": d}

    w, ts = (torch.tensor(v, dtype=f64, device=device) for v in BRD_SNAP)
    c, stats = brd_part(f"minimum-snap coefficients (3 segments) f64 on {card}",
                        lambda: caerial.minimum_snap_coeffs(w, ts), counted)
    ends = torch.stack([caerial.eval_poly8(c, torch.zeros(3, dtype=f64, device=device)),
                        caerial.eval_poly8(c, ts)])
    interp = float((ends - torch.stack([w[:-1], w[1:]])).abs().max())
    rest = float(caerial.eval_poly8(c[0], torch.zeros((), dtype=f64, device=device), 1).abs())
    _gate("minimum snap: each segment interpolates its waypoints within 1e-7, rest to rest within "
          "1e-8 (the JAX test's gates)", interp < 1e-7 and rest < 1e-8,
          f"max|p - w| {interp!r}, |v(0)| {rest!r}")
    d = ctl_same("minimum snap f64 cuda = CPU", c,
                 caerial.minimum_snap_coeffs(w.cpu(), ts.cpu()), BRD_ATOL * float(c.abs().max()))
    out["minimum_snap"] = {**stats, "interpolation_error": interp, "f64_max_diff": d}
    return out, brd_state


def brd_lattice(device, dtype):
    return prb.rigid_body_lattice_plan(BRD_START, BRD_GOAL, [prb.aabb_obstacle(
        *BRD_WALL, dtype=dtype, device=device)], prb.RigidBodyConfig())


def brd_rrt(device, dtype):
    return prb.rigid_body_rrt_plan(SEED, BRD_START, BRD_GOAL, [prb.aabb_obstacle(
        *BRD_WALL, dtype=dtype, device=device)], prb.RigidBodyConfig(), max_nodes=600)


def brd_scene(name):
    return getattr(pbo.BranchOutScene, name)()


def brd_branchout(device, dtype, steps=40):
    """Each scene's plan, the wide overtake's metrics against its
    lane-change-left mode, and each scene's closed loop."""
    plans = {s: pbo.branchout_plan(brd_scene(s), dtype=dtype, device=device) for s in BRD_SCENES}
    gt = plans["wide_overtake"]["poses"][2][None]
    metrics = pbo.evaluate_multimodal(plans["wide_overtake"], gt)
    loops = {s: pbo.simulate_closed_loop(brd_scene(s), [(0.0, 0.0)], steps=steps, dtype=dtype,
                                         device=device) for s in BRD_SCENES}
    return plans, metrics, loops


def brd_planners_part(card, device, counted):
    """(b) The rigid-body lattice and RRT planners at `RigidBodyConfig()` on
    the JAX test's scene; BranchOut's plan, metrics and closed loop (40
    steps) on the three scenes."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    cfg = prb.RigidBodyConfig()
    plan, stats = brd_part(f"rigid_body_lattice_plan {cfg.heading_count} x 21 x 21 f32 on {card}",
                           lambda: brd_lattice(device, f32), counted)
    ok = (plan is not None and plan["min_separation_margin"] > cfg.clearance
          and np.abs(plan["poses"][0][:2] - BRD_START[:2]).max() <= 0.26
          and np.abs(plan["poses"][-1][:2] - BRD_GOAL[:2]).max() <= 0.26
          and bool((plan["certificate_margins"] > cfg.clearance).all()))
    _gate("rigid-body lattice: a certified path from start to goal (the JAX test's gates)", ok,
          f"cost {plan and plan['total_cost']!r}, {plan and len(plan['poses'])} poses, min margin "
          f"{plan and plan['min_separation_margin']!r}")
    got, want = brd_lattice(device, f64), brd_lattice("cpu", f64)
    same = all(np.array_equal(got[k], want[k]) for k in ("poses", "certificate_halfspaces",
                                                         "certificate_margins", "iterations"))
    _gate("rigid-body lattice f64 cuda = CPU", same and got["total_cost"] == want["total_cost"],
          "poses, certificates and costs equal" if same else "differ")
    out["lattice"] = {**stats, "total_cost": plan["total_cost"], "poses": len(plan["poses"]),
                      "feasible_states": plan["iterations"]}

    plan, stats = brd_part(f"rigid_body_rrt_plan (600 nodes) f32 on {card}",
                           lambda: brd_rrt(device, f32), counted)
    ok = plan is not None and plan["min_separation_margin"] > cfg.clearance and plan[
        "path_length"] >= 8.0
    _gate("rigid-body RRT: a certified path (the JAX test's gates)", ok,
          f"{plan and plan['iterations']} iterations, length {plan and plan['path_length']!r}")
    got, want = brd_rrt(device, f64), brd_rrt("cpu", f64)
    _gate("rigid-body RRT f64 cuda = CPU", np.array_equal(got["poses"], want["poses"])
          and got["iterations"] == want["iterations"], "the same tree and path")
    out["rrt"] = {**stats, "iterations": plan["iterations"], "path_length": plan["path_length"]}

    (plans, metrics, loops), stats = brd_part(
        f"BranchOut: plans, metrics, 40-step closed loops on {len(BRD_SCENES)} scenes f32 on "
        f"{card}", lambda: brd_branchout(device, f32), counted,
        short=("2-step loops", lambda: brd_branchout(device, f32, steps=2)))
    best = {s: pbo.MODES[int(torch.argmax(p["probability"]))] for s, p in plans.items()}
    yt = plans["forced_yield"]["poses"][1, -1]
    wide = loops["wide_overtake"]
    ok = (all(abs(float(p["probability"].sum()) - 1.0) < 1e-6 for p in plans.values())
          and best["simple_overtake"] != "keep-lane" and best["forced_yield"] == "yield"
          and float(yt[2]) < 0.5 and float(yt[0]) < 4.1 and metrics["mode_count"] == 4
          and 0.0 <= metrics["speed_jsd"] <= math.log(2) + 1e-6
          and wide["collision_steps"] == 0 and wide["route_completion"] > 0.9
          and wide["min_clearance"] > 0)
    _gate("BranchOut: tests/test_breadth_planners.py's gates", ok,
          f"winners {best}, wide overtake's loop {wide['route_completion']!r} complete, "
          f"{wide['collision_steps']} collision steps")
    got, want = brd_branchout(device, f64), brd_branchout("cpu", f64)
    d = max(max(ctl_same(f"BranchOut {s} plan f64 cuda = CPU: {k}", got[0][s][k], want[0][s][k],
                         BRD_ATOL) for k in ("poses", "cost", "probability"))
            for s in BRD_SCENES)
    d = max(d, *(abs(got[1][k] - want[1][k]) for k in want[1]))
    for s in BRD_SCENES:
        ctl_same(f"BranchOut {s} closed loop f64 cuda = CPU: mode sequence",
                 torch.tensor([pbo.MODES.index(m) for m in got[2][s]["mode_sequence"]]),
                 torch.tensor([pbo.MODES.index(m) for m in want[2][s]["mode_sequence"]]))
        d = max(d, ctl_same(f"BranchOut {s} closed loop f64 cuda = CPU: executed path",
                            torch.tensor(got[2][s]["executed_path"]),
                            torch.tensor(want[2][s]["executed_path"]), BRD_ATOL))
    _gate("BranchOut metrics f64 cuda = CPU", d <= BRD_ATOL, f"max|diff| {d!r}")
    out["branchout"] = {**stats, "winners": best, "metrics": metrics,
                        "loops": {s: {k: v for k, v in lp.items() if k != "executed_path"}
                                  for s, lp in loops.items()}, "f64_max_diff": d}
    return out


def brd_serving_part(card, device, counted, lockstep=None):
    """(c) bench.py's serving row: the compaction runner at its defaults
    (256 graphs x 200 poses, rounds of 6 iterations, at most 8, tolerance
    1e-6) beside the lock-step batch at the same shape (25 iterations, best
    of 2): phase 15's run of it (`lockstep`, its "serving" numbers), or its
    own when phase 25 runs alone."""
    f32, f64 = torch.float32, torch.float64
    (c_s, c_worst, c_rate, rounds), c_stats = brd_part(
        f"run_batched_compaction_benchmark() 256 x 200 f32 on {card}",
        lambda: pose_graph_bench.run_batched_compaction_benchmark(device=device), counted,
        short=("one round", lambda: pose_graph_bench.run_batched_compaction_benchmark(
            max_rounds=1, device=device)))
    if lockstep is None:
        (l_s, l_worst, l_rate, _, summ), l_stats = brd_part(
            f"run_batched_benchmark 256 x 200 f32, lock-step, 25 iterations, best of 2 on {card}",
            lambda: pose_graph_bench.run_batched_benchmark(
                size=200, batch=256, max_iterations=25, device=device, runs=2), counted,
            short=("1 iteration", lambda: pose_graph_bench.run_batched_benchmark(
                size=200, batch=256, max_iterations=1, device=device)))
        l_stats["iterations_max"] = int(summ.iterations.max())
    else:
        l_s, l_worst, l_rate = (lockstep[k] for k in ("seconds", "worst_rmse", "graphs_per_s"))
        l_stats = {"from": "phase 15"}
    buckets = [b for b, _ in rounds]
    active = [a for _, a in rounds]
    ok = (c_worst < 5e-3 and l_worst < 5e-3 and rounds[0] == (256, 256)
          and buckets == sorted(buckets, reverse=True) and active == sorted(active, reverse=True)
          and all(a <= b < 2 * a or a == b for b, a in rounds))
    _gate("serving: both runners' worst RMSE < 5e-3, the rounds packed into shrinking "
          "power-of-two buckets", ok, f"compaction {c_worst!r} in {len(rounds)} rounds {rounds}; "
                                      f"lock-step {l_worst!r}")
    print(f"serving 256 x 200 f32 on {card}: compaction {c_rate!r} graphs/s ({c_s!r} s), "
          f"lock-step {l_rate!r} graphs/s ({l_s!r} s): compaction / lock-step = "
          f"{c_rate / l_rate!r}")
    got = pose_graph_bench.run_batched_compaction_benchmark(**BRD_COMPACT_SMALL, device=device,
                                                            dtype=f64)
    want = pose_graph_bench.run_batched_compaction_benchmark(**BRD_COMPACT_SMALL, device="cpu",
                                                             dtype=f64)
    _gate(f"compaction {BRD_COMPACT_SMALL} f64 cuda = CPU: the rounds profile exactly, the worst "
          f"RMSE within {BRD_ATOL}", got[3] == want[3] and abs(got[1] - want[1]) <= BRD_ATOL,
          f"{got[3]} against {want[3]}, {got[1]!r} against {want[1]!r}")
    return {"compaction": {**c_stats, "seconds": c_s, "worst_rmse": c_worst,
                           "graphs_per_s": c_rate, "rounds": [list(r) for r in rounds]},
            "lockstep": {**l_stats, "seconds": l_s, "worst_rmse": l_worst, "graphs_per_s": l_rate},
            "compaction_over_lockstep": c_rate / l_rate, "batch": 256, "size": 200}


def brd_cell_draws(case, bucket, slots, max_iter, seed):
    """A point-cloud cell's draws from a CPU generator, the Poisson sampler's
    first points among each cloud's valid ones."""
    gen = torch.Generator().manual_seed(seed)
    draws = epcs.draw_cell(gen, case, slots, max_iter, torch.float64, "cpu")
    _, valid = epcs._generate_cell_clouds(case, bucket, draws)
    lanes = len(epcs._POISSON_FACTORS)
    first = torch.multinomial(valid.double().repeat_interleave(lanes, 0), 1, generator=gen)
    return draws._replace(poisson_first=first.reshape(slots, lanes))


def brd_experiments_part(card, device, counted):
    """(d) The experiment suites at their defaults but for depth: UKF
    against CKF (10 families x 32 scenarios x BRD_UKF_STEPS steps, f64), path
    tracking (3 controllers x 3 courses x 3 seeds x 500 steps), drone
    trajectories (3 seeds), point-cloud
    sampling (the six problems, 10 slots a cell)."""
    out = {}
    f32, f64 = torch.float32, torch.float64
    # f64: the UKF's sigma weights at α = 1e-3 cancel in f32, where JAX's
    # own suite gives NaN RMSEs (11 of 32 nominal scenarios; ROADMAP C13)
    ukf, stats = brd_part(
        f"run_ukf_ckf_accuracy() (10 families x 32 scenarios x {BRD_UKF_STEPS} steps) f64 on "
        f"{card}", lambda: eukf.run_ukf_ckf_accuracy(steps=BRD_UKF_STEPS, dtype=f64,
                                                      device=device), counted,
        short=("one family, 20 steps", lambda: eukf.simulate_family_rmse(
            eukf.SCENARIO_FAMILIES["nominal"], 20,
            generator=torch.Generator(device=device).manual_seed(0), dtype=f64, device=device)))
    rows = ukf["full_coverage"]
    full = {r.comparison_key(): r for r in rows}
    ok = (set(ukf) == {"full_coverage", "strided_2", "strided_4", "head_8", "escalating"}
          and len(rows) == 10 * 3
          and all(r.winner() in ("UKF", "CKF") and 0 < r.coverage_ratio() <= 1.0
                  and math.isfinite(r.ukf_over_ckf())
                  and r.ukf_min_rmse <= r.ukf_bucket_median_rmse <= r.ukf_max_rmse for r in rows)
          and all(len(r.selected_slots) <= len(full[r.comparison_key()].selected_slots)
                  for r in ukf["strided_4"])
          and all(r.ukf_bucket_median_rmse < 1.0 and r.ckf_bucket_median_rmse < 1.0
                  for r in rows if r.family_name == "nominal"))
    _gate("UKF/CKF suite: tests/test_experiments.py's gates", ok,
          f"CKF wins {sum(r.winner() == 'CKF' for r in rows)} of {len(rows)} full-coverage rows")
    fams = {k: eukf.SCENARIO_FAMILIES[k] for k in ("outliers", "latency")}
    draws = {k: eukf.draw_family(torch.Generator().manual_seed(i), 20, 8, f64)
             for i, k in enumerate(sorted(fams))}
    got = [eukf.simulate_family_rmse(p, 20, 8, draws=eukf.FamilyDraws(
        *(t.to(device) for t in draws[k])), dtype=f64) for k, p in sorted(fams.items())]
    want = [eukf.simulate_family_rmse(p, 20, 8, draws=draws[k], dtype=f64)
            for k, p in sorted(fams.items())]
    d = ctl_same("UKF/CKF RMSEs, 2 families x 8 scenarios x 20 steps f64 cuda = CPU",
                 torch.stack([torch.stack(g) for g in got]),
                 torch.stack([torch.stack(w) for w in want]), BRD_ATOL)
    out["ukf_ckf"] = {**stats, "ckf_wins": sum(r.ckf_wins for r in rows), "f64_max_diff": d}

    reports, stats = brd_part(
        f"run_path_tracking_accuracy() (3 x 3 x 3 x 500 steps) f32 on {card}",
        lambda: ept.run_path_tracking_accuracy(device=device), counted,
        short=("2 steps", lambda: ept.run_path_tracking_accuracy(steps=2, device=device)))
    ok = ({r.variant.name for r in reports} == {"pure_pursuit", "stanley", "lqr_steer"}
          and all(len(r.observations) == 9 and r.summary["mean_cross_track_rmse"] < 3.0
                  and 0.0 <= r.summary["goal_rate"] <= 1.0 for r in reports)
          and reports[0].reference_deltas["mean_cross_track_rmse"] == 0.0)
    _gate("path-tracking suite: tests/test_experiments.py's gates", ok,
          f"{ {r.variant.name: r.summary for r in reports} }")
    pts = torch.stack([ept._course(c, dtype=f32, device=device)[0] for c in ept.COURSES])
    offsets = torch.rand((3, 2), generator=torch.Generator().manual_seed(SEED), dtype=f32)
    # the lane's state and its exact reductions (a mean's order may follow
    # the batch)
    exact = ("max_cross_track", "progress", "goal_reached")

    def lanes(off, p):
        m = ept._rollout(off.to(device), p, torch.ones_like(p[..., 0]), "lqr_steer",
                         BRD_LANE_STEPS)
        return torch.stack([m[k].float() for k in exact], -1)

    ctl_lanes(f"path tracking LQR f32, {BRD_LANE_STEPS} steps, a course a lane",
              lanes(offsets, pts), lambda i: lanes(offsets[i:i + 1], pts[i:i + 1])[0], (0, 1, 2))
    got, want = (ept.run_path_tracking_accuracy(seeds=(0,), steps=30, dtype=f64, device=dev)
                 for dev in (device, "cpu"))
    d = max(abs(g.summary[k] - w.summary[k]) for g, w in zip(got, want) for k in w.summary)
    _gate("path-tracking suite (1 seed, 30 steps) f64 cuda = CPU", d <= BRD_ATOL,
          f"max|diff| {d!r}")
    out["path_tracking"] = {**stats, "summaries": {r.variant.name: r.summary for r in reports},
                            "f64_max_diff": d}

    wps = edq._waypoints(torch.rand((5, 3), generator=torch.Generator().manual_seed(SEED)).to(
        device) * 2.0 - 1.0)
    reports, stats = brd_part(f"run_drone_trajectory_quality() (3 seeds) f32 on {card}",
                              lambda: edq.run_drone_trajectory_quality(device=device), counted,
                              short=("a 20-step minimum-snap flight",
                                     lambda: edq._fly_min_snap(wps, segment_time=0.1)))
    by = {r.variant.name: r for r in reports}
    ok = (set(by) == {"quintic", "min_snap"}
          and all(math.isfinite(r.summary["mean_tracking_rmse"])
                  and r.summary["mean_tracking_rmse"] < 5.0 for r in reports)
          and by["min_snap"].summary["mean_jerk"] <= by["quintic"].summary["mean_jerk"] * 5.0)
    _gate("drone suite: tests/test_experiments.py's gates", ok,
          f"{ {n: r.summary for n, r in by.items()} }")
    got, want = (edq.run_drone_trajectory_quality(seeds=(0,), dtype=f64, device=dev)
                 for dev in (device, "cpu"))
    d = max(abs(g.observations[0][k] - w.observations[0][k]) / max(1.0, abs(w.observations[0][k]))
            for g, w in zip(got, want) for k in w.observations[0])
    _gate("drone suite (1 seed) f64 cuda = CPU", d <= BRD_ATOL, f"max relative diff {d!r}")
    out["drone"] = {**stats, "summaries": {n: r.summary for n, r in by.items()},
                    "f64_max_rel_diff": d}

    case0 = epcs.PROCESS_PROBLEMS["point_cloud_sampling"][0]
    reports, stats = brd_part(
        f"run_point_cloud_sampling_quality() (six problems, 10 slots a cell) f32 on {card}",
        lambda: epcs.run_point_cloud_sampling_quality(device=device), counted,
        short=("one cell, 2 slots", lambda: epcs.slot_scores_for_cell(
            case0, 48, 2, generator=torch.Generator(device=device).manual_seed(0), device=device)))
    obs = [o for r in reports.values() for o in r["observations"]]
    full = reports["full-bucket"]
    checks = {
        "roster": set(reports) == {"full-bucket", "first-scenario", "sampled-bucket",
                                   "percentile-bucket", "variance-triggered"},
        "reference": (full["agreement_vs_reference"] == 1.0
                      and full["mean_ratio_error_vs_reference"] == 0
                      and full["average_coverage_ratio"] == 1.0),
        "first-scenario coverage 1/10": abs(
            reports["first-scenario"]["average_coverage_ratio"] - 0.1) < 1e-12,
        "observations": all(
            o.total_scenarios == 10 and all(map(math.isfinite, o.median_scores))
            and o.runner_up_over_best() >= 1.0 and sum(o.wins) == len(o.selected_slots)
            and all(lo <= md <= hi + 1e-12 for lo, md, hi in zip(
                o.min_scores, o.median_scores, o.max_scores)) for o in obs)}
    _gate("point-cloud suite: tests/test_experiments.py's gates", all(checks.values()),
          f"{len(full['observations'])} cells; winners "
          f"{collections.Counter(o.winner() for o in full['observations'])}; failing "
          f"{[k for k, v in checks.items() if not v]}")
    case = epcs.PROCESS_PROBLEMS["density_shift"][0]
    draws = brd_cell_draws(case, 48, 3, 8 * epcs.cloud_size(case), SEED)
    d = ctl_same("point-cloud cell (density shift, 48, 3 slots) f64 cuda = CPU",
                 epcs.slot_scores_for_cell(case, 48, 3, draws=epcs.CellDraws(
                     *(None if x is None else x.to(device) for x in draws)), dtype=f64),
                 epcs.slot_scores_for_cell(case, 48, 3, draws=draws, dtype=f64), BRD_ATOL)
    out["point_cloud"] = {**stats, "agreement": {k: r["agreement_vs_reference"]
                                                 for k, r in reports.items()},
                          "f64_max_diff": d}
    return out


def brd_utilities_part(card, device, counted, rates, state):
    """(e) The roofline of the run's EKF and resampling rates, one trace, a
    checkpoint round trip of a CUDA state, `assert_deterministic` on a
    planner, `nan_report`, frames drawn (no GIF: the card's machine has no
    PIL)."""
    out = {}
    extras = uroof.roofline_extras(rates, uroof.card_peaks(torch.cuda.get_device_name(0)))
    _gate("roofline of the run's rates", set(extras) >= {"ekf_update", "resampled_particle"}
          and all(math.isfinite(v) for m in extras.values() for k, v in m.items()
                  if k != "expected_bound"), f"{extras}")
    out["roofline"] = extras
    with tempfile.TemporaryDirectory() as tmp:
        with uprof.trace(tmp):
            pbo.branchout_plan(brd_scene("wide_overtake"), device=device)
        events = json.load(open(os.path.join(tmp, "trace.json")))["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        _gate("utils.profiling.trace: a Chrome trace written", len(events) > 0,
              f"{len(events)} events, {kernels} device kernels")
        out["trace_events"], out["trace_kernels"] = len(events), kernels
        ckpt.save_checkpoint(tmp, 25, state)
        like = {k: torch.zeros_like(v) for k, v in state.items()}
        back = ckpt.load_checkpoint(tmp, ckpt.latest_step(tmp), like)
    ok = all(back[k].device == state[k].device and bitwise_equal(back[k], state[k])
             for k in state)
    _gate(f"checkpoint round trip of the meta fleet's state on {device}", ok, "bitwise")
    _gate("nan_report of the meta fleet's state", uprof.nan_report(state) == {}, "all finite")
    uprof.assert_deterministic(lambda: pbo.branchout_plan(brd_scene("simple_overtake"),
                                                          device=device), runs=3)
    uprof.assert_deterministic(lambda: brd_lattice(device, torch.float32), runs=2)
    print("assert_deterministic: BranchOut's plan (3 runs) and the rigid-body lattice plan (2 "
          "runs) bitwise")
    frame = vraster.Frame(vraster.CanvasConfig(x_range=(-1.0, 11.0), y_range=(-1.0, 11.0)))
    plan = brd_lattice(device, torch.float32)
    frame.draw_path_xy(plan["poses"][:, 0], plan["poses"][:, 1], vraster.ESTIMATED)
    for p in plan["poses"]:
        frame.draw_robot(p[0], p[1], p[2], 0.4, vraster.GROUND_TRUTH)
    inked = int((frame.rgb != 255).any(-1).sum())
    _gate("viz.raster: the lattice path drawn", inked > 0, f"{inked} pixels inked")
    out["frame_pixels_inked"] = inked
    return out


def breadth_phase(card, device, counted, rates, lockstep=None):
    """The rigid-body and BranchOut planners, the aerial, meta and arena
    controllers, the compaction runner, the experiment suites, utils/ and
    viz/ (phase 25): (a) controllers; (b) planners; (c) serving; (d)
    experiments; (e) utilities. `rates`: the run's EKF updates/s and
    resampled particles/s, for the roofline; `lockstep`: phase 15's serving
    numbers, if it ran."""
    out = {"card": card}
    BRD_KERNEL_LAUNCHES.clear()
    start = time.perf_counter()
    t0 = time.perf_counter()
    out["controllers"], state = brd_controllers_part(card, device, counted)
    out["controllers"]["part_s"] = time.perf_counter() - t0
    print(f"breadth, part controllers: {out['controllers']['part_s']!r} s")
    for name, part in (("planners", brd_planners_part),
                       ("serving", functools.partial(brd_serving_part, lockstep=lockstep)),
                       ("experiments", brd_experiments_part)):
        t0 = time.perf_counter()
        out[name] = part(card, device, counted)
        out[name]["part_s"] = time.perf_counter() - t0
        print(f"breadth, part {name}: {out[name]['part_s']!r} s")
    for k in counted:
        k.launches = 0
    out["utilities"] = brd_utilities_part(card, device, counted, rates, state)
    out["phase_s"] = time.perf_counter() - start
    for k in counted:
        BRD_KERNEL_LAUNCHES[k.__name__] = BRD_KERNEL_LAUNCHES.get(k.__name__, 0) + k.launches
    out["kernel_launches"] = dict(BRD_KERNEL_LAUNCHES)
    print(f"breadth: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']}")
    if any(out["kernel_launches"].values()):
        fail(f"phase 25 launched a kernel: {out['kernel_launches']}")
    return out


# ---------------------------------------------------------------------------
# 26. the headless demo family, the playground, dataflow, the speed
# comparison and the embedded demo (B2 on every wavefront_costs call)

FAM_ATOL = 1e-9  # f64 cuda = CPU (tests/test_torch_headless_family.py's tolerance)
FAM_SHORT = 3  # steps of the MPPI family's cuda = CPU runs, on shared draws
FAM_ARENA_LANE_STEPS = 20  # steps of an arena speed lane's solo run held to the lanes'
FAM_SPEED = dict(runs=20, batch=32)  # run_speed_comparison's defaults
FAM_KERNEL_LAUNCHES = {}
FAM_WAVEFRONT_CALLS = [0]  # wavefront_costs calls on cuda tensors this phase
# tests/test_headless_family.py's FAST list: cuda = CPU at full size
FAM_FAST = (
    "headless_grid_planners", "headless_factor_graph_stack", "headless_conformal_sipp",
    "headless_stl_cbs_multi_robot", "headless_kinodynamic_stl_cbs",
    "headless_hierarchical_mapf_replanning", "headless_traversal_risk_graph",
    "headless_clearance_risk_graph", "headless_elevation_risk_graph",
    "headless_risk_map_smoothing", "headless_adaptive_costmap_namo",
    "headless_rigid_body_mip_planning")
# the demos with steps, run FAM_SHORT steps on cuda and the CPU: (name,
# extra kwargs, the shape of their draws at FAM_SHORT steps)
FAM_STEPPED = (
    ("headless_localizers", {}, None),
    ("headless_mppi_double_integrator", {}, (FAM_SHORT, 256, 25, 2)),
    ("headless_mppi_terminal_value", {}, (FAM_SHORT, 512, 25, 2)),
    ("headless_mppi_value_learning", {"episodes": 2}, (2, FAM_SHORT, 256, 24, 2)),
    ("headless_mppi_replay_value_learning", {"episodes": 2}, (2, FAM_SHORT, 256, 22, 2)),
    ("headless_mppi_adaptive_temperature", {}, (FAM_SHORT, 256, 25, 2)),
    ("headless_mppi_constraint_discount", {}, (FAM_SHORT, 320, 28, 2)),
    ("headless_mppi_track_progress", {}, (FAM_SHORT, 320, 25, 2)),
    ("headless_mppi_racing_gate_progress", {}, (FAM_SHORT, 128, 15, 4)),
    ("headless_adap_rpf_mppi", {}, (FAM_SHORT, 360, 16, 2)),
)


def _fam_expect():
    """tests/test_headless_family.py's EXPECT gates: name -> out -> [(what,
    holds)]."""
    def mppi_rows(out):
        return [(f"{v} final distance < 0.5 and min clearance > 0.1",
                 out[f"{v}_final_distance"] < 0.5 and out[f"{v}_min_clearance"] > 0.1)
                for v in ("uniform", "discounted")]

    return {
        "headless_grid_planners": lambda o: [
            ("4-conn >= 8-conn optimum", o["wavefront_4_cost"] >= o["wavefront_8_cost"] - 1e-9),
            ("ARA* final == optimal (1e-6)", abs(o["ara_final_cost"] - o["wavefront_8_cost"])
             < 1e-6),
            ("beam >= optimal", o["beam_ge_optimal"])],
        "headless_factor_graph_stack": lambda o: [
            ("IMU drift < 1e-6", o["stationary_imu_drift"] < 1e-6),
            ("pose graph error < 0.2", o["pose_graph_terminal_error"] < 0.2),
            ("BA point error < 0.1", o["bundle_adjustment_mean_point_error"] < 0.1),
            ("ICP error < 1e-3", o["point_to_plane_icp_transform_error"] < 1e-3)],
        "headless_conformal_sipp": lambda o: [
            ("feasible, arrival <= 20", o["feasible"] and o["arrival"] <= 20),
            ("min confidence >= 0.9", o["min_confidence"] >= 0.9),
            ("violation bound <= 0.1", o["trajectory_violation_bound"] <= 0.1)],
        "headless_stl_cbs_multi_robot": lambda o: [
            ("success, >= 1 conflict resolved", o["success"] and o["conflicts_resolved"] >= 1),
            ("min separation >= 1", o["min_separation"] >= 1.0)],
        "headless_kinodynamic_stl_cbs": lambda o: [
            ("both succeed, speed-up", o["both_succeed"] and o["speedup"]),
            ("fast arrives first", o["fast_arrival"] < o["slow_arrival"]),
            ("avoid robustness > 0", o["fast_avoid_robustness"] > 0)],
        "headless_hierarchical_mapf_replanning": lambda o: [
            ("both plans succeed", o["base_success"] and o["replan_success"]),
            ("replan not shorter", o["replan_not_shorter"])],
        "headless_traversal_risk_graph": lambda o: [("risk-averse safer", o["risk_averse_safer"])],
        "headless_clearance_risk_graph": lambda o: [
            ("clearance improved", o["clearance_improved"])],
        "headless_elevation_risk_graph": lambda o: [
            ("avoids the blocked cells, >= 1 of them",
             o["avoids_blocked"] and o["blocked_cells"] >= 1)],
        "headless_risk_map_smoothing": lambda o: [
            ("smoothing straightens", o["smoothing_straightens"])],
        "headless_adaptive_costmap_namo": lambda o: [
            ("first plan through the corridor", o["initial_through_corridor"]),
            ("replanned around", o["replanned_around"]),
            ("3 stuck observations to lethal", o["stuck_observations_to_lethal"] == 3),
            ("replanned cost higher", o["replanned_cost"] > o["initial_cost"])],
        "headless_rigid_body_mip_planning": lambda o: [
            ("reached and certified", o["reached"] and o["certified"]),
            ("margin > 0", o["min_separation_margin"] > 0),
            ("path >= 8 m", o["path_length"] >= 8.0)],
        "headless_localizers": lambda o: [
            *((f"{n} RMSE in (0, 0.5)", 0.0 < o[f"{n}_rmse"] < 0.5) for n in ("ekf", "ukf", "ckf")),
            ("PF RMSE < 0.2", o["pf_rmse"] < 0.2), ("the PF best", o["best"] == "pf")],
        "headless_mppi_double_integrator": lambda o: [
            ("goal reached", o["goal_reached"]), ("final distance < 0.3", o["final_distance"] < 0.3),
            ("mean ESS > 10", o["mean_ess"] > 10.0)],
        "headless_mppi_terminal_value": lambda o: [
            ("value wins", o["value_wins"]),
            ("value nearer", o["value_final_distance"] < o["naive_final_distance"])],
        "headless_mppi_value_learning": lambda o: [
            ("improved", o["improved"]), ("TD delta shrinks",
                                          o["last_td_delta"] <= o["first_td_delta"]),
            ("last episode cost > 0", o["last_episode_cost"] > 0.0)],
        "headless_mppi_replay_value_learning": lambda o: [
            ("improved", o["improved"]), ("all rollouts kept", o["buffer_count"] == o["episodes"]),
            ("TD delta shrinks", o["last_td_delta"] <= o["first_td_delta"])],
        "headless_mppi_adaptive_temperature": lambda o: [
            ("lambda changed", o["lambda_changed"]),
            ("ESS fraction >= the fixed run's", o["mean_ess_fraction_adaptive"]
             >= o["mean_ess_fraction_fixed"] - 1e-6),
            ("final distance < 1", o["final_distance"] < 1.0)],
        "headless_mppi_constraint_discount": lambda o: [
            ("discount helps progress", o["discount_helps_progress"]), *mppi_rows(o)],
        "headless_mppi_track_progress": lambda o: [
            ("completed", o["completed"]), ("max lateral error < 1.5", o["max_lateral_error"] < 1.5),
            ("progress fraction <= 1.5", o["progress_fraction"] <= 1.5)],
        "headless_mppi_racing_gate_progress": lambda o: [
            (">= 1 gate", o["gates_passed"] >= 1), ("lap fraction >= 0.5", o["lap_fraction"] >= 0.5),
            ("SOC in (0, 1]", 0.0 < o["final_soc"] <= 1.0),
            ("saturation <= 0.5", o["saturation_fraction"] <= 0.5),
            ("mean speed > 0.5", o["mean_speed"] > 0.5)],
        "headless_adap_rpf_mppi": lambda o: [
            ("adaptive less occluded", o["adaptive_less_occluded"]),
            ("adaptive clearance > 0.5", o["adaptive_min_clearance"] > 0.5),
            ("adaptive clearance >= fixed", o["adaptive_min_clearance"]
             >= o["fixed_min_clearance"] - 1e-6),
            ("adaptive proximity <= fixed", o["adaptive_mean_proximity"]
             <= o["fixed_mean_proximity"])],
        "headless_branchout_multimodal_driving": lambda o: [
            ("no collision", o["no_collision_rate"] == 1.0),
            ("TTC > 1", o["min_time_to_collision"] > 1.0),
            ("clearance > 0.5", o["min_clearance"] > 0.5),
            ("route completion > 0.3", o["route_completion"] > 0.3),
            (">= 1 mode", o["modes_used"] >= 1)],
    }


@contextlib.contextmanager
def fam_count_wavefront():
    """Counts the `wavefront_costs` calls made on cuda tensors while the
    block runs into FAM_WAVEFRONT_CALLS: the callers of phases 26 and 27
    (the demos, the playground, dataflow, the speed comparison, the
    benches, the renders and `plan_grid`) look the function up in
    `planning/wavefront.py` when they run, or in the modules of
    WAVEFRONT_CALLERS, which bind it at import."""
    def counted(free, goals, *args, **kwargs):
        if torch.as_tensor(free).is_cuda:
            FAM_WAVEFRONT_CALLS[0] += 1
        return wavefront_costs(free, goals, *args, **kwargs)

    for module in (pwavefront, *WAVEFRONT_CALLERS):
        module.wavefront_costs = counted
    try:
        yield
    finally:
        for module in (pwavefront, *WAVEFRONT_CALLERS):
            module.wavefront_costs = wavefront_costs


def fam_part(label, fn, counted, short=None):
    """fn() once under sync debug mode "warn" on the host clock (its reads)
    and, given `short` = (its name, a callable), that short call under the
    profiler; the kernel entries counted over both: B2 once per cuda
    `wavefront_costs` call, every other entry never (summed into
    FAM_KERNEL_LAUNCHES). Returns (fn's result, the numbers)."""
    for k in counted:
        k.launches = 0
    calls = FAM_WAVEFRONT_CALLS[0]
    host_s, (out, reads) = timed(lambda: reads_in(fn))
    stats = {"host_s": host_s, "reads": reads}
    if short is not None:
        stats["profiled"] = short[0]
        stats.update(profile_once(label, short[1]))
    stats["kernel_launches"] = {k.__name__: k.launches for k in counted}
    stats["wavefront_costs_calls"] = FAM_WAVEFRONT_CALLS[0] - calls
    for name, n in stats["kernel_launches"].items():
        FAM_KERNEL_LAUNCHES[name] = FAM_KERNEL_LAUNCHES.get(name, 0) + n
    prof = (f"; profiled call ({short[0]}): device busy {stats['busy_ms']!r} ms, "
            f"{stats['launches']} launches, {stats['idle']:.3f} idle" if short else "")
    print(f"{label}: {host_s!r} s host; {reads} device reads{prof}; "
          f"{stats['wavefront_costs_calls']} wavefront_costs calls; kernel entries "
          f"{stats['kernel_launches']}")
    others = {n: v for n, v in stats["kernel_launches"].items() if n != "wavefront_relax" and v}
    if others or stats["kernel_launches"]["wavefront_relax"] != stats["wavefront_costs_calls"]:
        fail(f"{label}: kernel entries {stats['kernel_launches']} for "
             f"{stats['wavefront_costs_calls']} wavefront_costs calls")
    return out, stats


def fam_same(label, got, want, atol=FAM_ATOL):
    """Two demo outputs: the same keys, floats within atol, anything else
    equal; gated. Returns the largest float difference."""
    _gate(f"{label}: the same keys", sorted(got) == sorted(want), sorted(got))
    worst, bad = 0.0, []
    for k, w in want.items():
        if isinstance(w, float):
            d = abs(got[k] - w) if math.isfinite(w) else (0.0 if got[k] == w else math.inf)
            worst = max(worst, d)
            if not d <= atol:
                bad.append((k, got[k], w))
        elif got[k] != w or type(got[k]) is not type(w):
            bad.append((k, got[k], w))
    _gate(label, not bad, f"max|diff| {worst!r} (<= {atol}), discrete outputs equal"
          if not bad else f"differ: {bad}")
    return worst


def fam_draws(name, shape, seed):
    """Host draws for a demo's FAM_SHORT-step runs: normals of `shape`, or
    the localizer's (init, predict, resample)."""
    r = np.random.default_rng(seed)
    if name == "headless_localizers":
        return (r.standard_normal((512, 4)), r.standard_normal((FAM_SHORT, 512, 2)),
                r.uniform(size=(FAM_SHORT, 1)))
    return r.standard_normal(shape)


def fam_headless_part(card, device, counted):
    """(a) The 23 demos in f64 at their sizes, each through its EXPECT gate;
    the FAST twelve cuda = CPU at full size, the demos with steps cuda =
    CPU over FAM_SHORT steps on shared draws."""
    f64 = torch.float64
    expect = _fam_expect()
    out = {}
    # the longest demos, each profiled on a short call
    profiled = {name: ("2 steps", lambda name=name: hfam.HEADLESS[name](
        2, device=device, dtype=f64)) for name in (
        "headless_localizers", "headless_mppi_double_integrator",
        "headless_mppi_adaptive_temperature", "headless_mppi_racing_gate_progress")}
    cpu_s = 0.0
    for name, demo in hfam.HEADLESS.items():
        got, stats = fam_part(f"{name} f64 on {card}", lambda demo=demo: demo(
            device=device, dtype=f64), counted, profiled.get(name))
        for what, holds in expect[name](got):
            _gate(f"{name}: {what} (tests/test_headless_family.py)", holds, "holds")
        row = {**stats, "out": got}
        if name in FAM_FAST:
            seconds, want = timed(lambda: hfam.HEADLESS[name](device="cpu", dtype=f64))
            cpu_s += seconds
            row["f64_max_diff"] = fam_same(f"{name} f64 cuda = CPU", got, want)
        out[name] = row
    print(f"the FAST twelve on the CPU (torch {torch.get_num_threads()} threads): {cpu_s!r} s")
    out["fast_cpu_s"] = cpu_s

    def short_runs():
        diffs = {}
        for i, (name, kw, shape) in enumerate(FAM_STEPPED):
            draws = fam_draws(name, shape, SEED + 300 + i)

            def run(dev, name=name, kw=kw, draws=draws):
                return hfam.HEADLESS[name](steps=FAM_SHORT, **kw, device=dev, dtype=f64,
                                           draws=draws)

            diffs[name] = fam_same(f"{name} {FAM_SHORT} steps f64 cuda = CPU on shared draws",
                                   run(device), run("cpu"))
        return diffs

    diffs, out["short_runs"] = fam_part(
        f"the demos with steps, {FAM_SHORT} steps f64 on {card} and the CPU", short_runs,
        counted)
    out["short_runs"]["f64_max_diff"] = diffs
    return out


def fam_playground_part(card, device, counted):
    """(b) The playground's five tabs in f64 into a temporary directory:
    the grid tab equal to docs/playground/data.json's (read, never
    written), every tab's equality to it reported; the arena's speed lanes
    bitwise their solo rollouts over FAM_ARENA_LANE_STEPS steps."""
    f64 = torch.float64
    tab_s = {}

    def timed_tab(name, tab):
        def run(**kw):
            seconds, out = timed(lambda: tab(**kw))
            tab_s[name] = seconds
            return out
        return run

    tabs = {n: getattr(pground, n) for n in ("_grid_planners_tab", "_localization_tab",
                                              "_slam_tab", "_admm_tab", "_arena_tab")}
    with tempfile.TemporaryDirectory() as tmp:
        for n, tab in tabs.items():  # each tab's seconds, as main builds it
            setattr(pground, n, timed_tab(n, tab))
        try:
            (_, stats) = fam_part(f"playground main(tmp) f64 on {card}", lambda: pground.main(
                tmp, device=device, dtype=f64), counted, ("the arena's LQR steer, 2 steps",
                                                          lambda: pground.arena_rollouts(
                                                              "lqr_steer", steps=2,
                                                              device=device, dtype=f64)))
        finally:
            for n, tab in tabs.items():
                setattr(pground, n, tab)
        print(f"playground tabs' seconds on {card}: {tab_s}")
        stats["tab_s"] = tab_s
        with open(os.path.join(tmp, "data.json")) as fh:
            data = json.load(fh)
        files = sorted(os.listdir(tmp))
    _gate("playground: main wrote data.json and index.html", files == ["data.json", "index.html"],
          files)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "playground",
                           "data.json")) as fh:
        artifact = json.load(fh)
    equal = {tab: json.dumps(data[tab]) == json.dumps(artifact[tab]) for tab in artifact}
    print(f"playground tabs equal to docs/playground/data.json on {card}: {equal}")
    _gate("playground: the grid tab (12 wavefront plans) equals docs/playground/data.json's",
          equal["grid_planners"] and stats["wavefront_costs_calls"] == 12,
          f"{stats['wavefront_costs_calls']} wavefront_costs calls")
    reached = all(r["reached"] for r in data["grid_planners"]["runs"].values())
    progress = min(r["progress"] for r in data["controller_arena"]["runs"].values())
    _gate("playground: every grid run reaches its goal, every arena run progresses > 30 m "
          "(tests/test_playground.py)", reached and progress > 30.0, f"least progress {progress}")
    for name in pground.ARENA_CONTROLLERS:
        # a speed a lane: the rollout's second axis
        lanes = pground.arena_rollouts(name, steps=FAM_ARENA_LANE_STEPS, device=device, dtype=f64)
        ctl_lanes(f"playground arena {name}, {FAM_ARENA_LANE_STEPS} steps f64, a speed a lane",
                  lanes.transpose(0, 1), lambda i, name=name: pground.arena_rollouts(
                      name, speeds=(pground.ARENA_SPEEDS[i],), steps=FAM_ARENA_LANE_STEPS,
                      device=device, dtype=f64)[:, 0], lanes=(0, 1, 2))
    return {**stats, "tabs_equal_artifact": equal}


def fam_dataflow_part(card, device, counted):
    """(c) Dataflow: the path-planning graph for 5 ticks (cuda = CPU, and a
    rerun the same) and the EKF graph for 50 ticks."""
    f64 = torch.float64

    def run():
        reports, metrics = dflow.run_path_planning_dataflow(5, device=device, dtype=f64)
        flow, est = dflow.build_ekf_dataflow(device=device, dtype=f64)
        flow.run(50)
        again, _ = dflow.run_path_planning_dataflow(1, device=device, dtype=f64)
        return reports, metrics, est, again

    (reports, metrics, est, again), stats = fam_part(
        f"dataflow: 5 planner ticks and 50 EKF ticks, then a tick again, f64 on {card}", run,
        counted)
    cpu, _ = dflow.run_path_planning_dataflow(5, device="cpu", dtype=f64)
    ok = (len(reports) == len(metrics) == 5 and all(r["found"] for r in reports)
          and all(m["waypoint_count"] == len(r["waypoints"])
                  and abs(m["euclidean_length"] - r["cost"]) <= 1e-5 * r["cost"]
                  for r, m in zip(reports, metrics)))
    _gate("dataflow: 5 reports found, the metrics agree (tests/test_aux.py)", ok,
          f"cost {reports[0]['cost']!r}, {len(reports[0]['waypoints'])} waypoints")
    _gate("dataflow: the planner's reports equal the CPU's and a rerun's",
          [r["waypoints"] for r in reports] == [r["waypoints"] for r in cpu]
          and max(abs(a["cost"] - b["cost"]) for a, b in zip(reports, cpu)) <= FAM_ATOL
          and again[0] == reports[0], "equal")
    _gate("dataflow: 50 EKF estimates, the last within 0.5 m (tests/test_aux.py)",
          len(est) == 50 and est[-1]["position_error"] < 0.5, f"{est[-1]['position_error']!r}")
    return {**stats, "cost": reports[0]["cost"], "ekf_last_error": est[-1]["position_error"]}


def fam_speed_part(card, device, counted):
    """(d) run_speed_comparison at its defaults (f32), the rows printed with
    the card."""
    (header, rows), stats = fam_part(
        f"run_speed_comparison({FAM_SPEED}) f32 on {card}", lambda: speed.run_speed_comparison(
            **FAM_SPEED, device=device), counted,
        ("one A* query", lambda: speed.speed_workloads(2, device)["a_star"][0]()))
    table = [dict(zip(header, row)) for row in rows]
    for row in table:
        print(f"speed comparison on {card}: {row}")
    # a warm-up and the runs, single and batched, and the profiled query
    want = 2 * (FAM_SPEED["runs"] + 1) + 1
    _gate("speed comparison: the four rows, one wavefront_costs call a timed A* run",
          [r["algorithm"] for r in table] == ["a_star", "rrt", "ekf", "cubic_spline"]
          and stats["wavefront_costs_calls"] == want, f"{stats['wavefront_costs_calls']} calls")
    return {**stats, "rows": table}


def fam_embedded_part(card, device, counted):
    """(e) The embedded demo (NumPy only): its PASS line."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report, stats = fam_part("embedded demo (host, NumPy)", lambda: embedded.run_embedded_demo(
            verbose=True), counted)
    lines = buf.getvalue().strip().splitlines()
    print("\n".join(lines))
    _gate("embedded demo: PASS (main.rs:144-147, tests/test_gallery_embedded.py)",
          report["passed"] and "embedded demo PASS" in lines and report["final_error"] < 0.1,
          f"final error {report['final_error']!r}")
    return {**stats, "final_error": report["final_error"]}


def fam_dare_graph_check(card, device):
    """The LQR laws' DARE as replays of a CUDA graph of its READ_EVERY-
    iteration block (trackers.solve_dare on the card) bitwise the eager
    loop, on LQR steer's error model at random speeds: 3 lanes (the arena's
    speeds) and 1024 (the fleets), f32 and f64."""
    rng = np.random.default_rng(SEED + 310)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for n in (3, 1024):
            v = torch.tensor(rng.uniform(0.2, 6.0, n), dtype=dtype, device=device)
            zero, one = torch.zeros_like(v), torch.ones_like(v)
            a = torch.stack([torch.stack([one, zero + 0.1, zero, zero], -1),
                             torch.stack([zero, zero, v, zero], -1),
                             torch.stack([zero, zero, one, zero + 0.1], -1),
                             torch.stack([zero, zero, zero, zero], -1)], -2)
            b = torch.stack([zero, zero, zero, v / 2.9], -1)[..., None]
            q = torch.diag_embed(torch.stack([one] * 4, -1))
            r = one[..., None, None]
            graphed = ctrack.solve_dare(a, b, q, r)
            eager = masked_fixpoint(ctrack._dare_step(a, b, q, r), q.expand(a.shape), 150, 0.01)
            key = f"{'f32' if dtype == torch.float32 else 'f64'} x {n}"
            out[key] = bitwise_equal(graphed, eager)
            _gate(f"solve_dare {key} on {card}: the CUDA graph's blocks bitwise the eager loop",
                  out[key], "bitwise" if out[key] else "differ")
    return out


def family_phase(card, device, counted):
    """The headless demo family, the playground, dataflow, the speed
    comparison and the embedded demo (phase 26): B2 once per cuda
    `wavefront_costs` call, every other kernel entry never."""
    out = {"card": card}
    FAM_KERNEL_LAUNCHES.clear()
    FAM_WAVEFRONT_CALLS[0] = 0
    start = time.perf_counter()
    out["dare_graph_bitwise"] = fam_dare_graph_check(card, device)
    with fam_count_wavefront():
        for name, part in (("headless", fam_headless_part), ("playground", fam_playground_part),
                           ("dataflow", fam_dataflow_part), ("speed", fam_speed_part),
                           ("embedded", fam_embedded_part)):
            t0 = time.perf_counter()
            calls = FAM_WAVEFRONT_CALLS[0]
            out[name] = part(card, device, counted)
            out[name]["part_s"] = time.perf_counter() - t0
            out[name]["part_wavefront_costs_calls"] = FAM_WAVEFRONT_CALLS[0] - calls
            print(f"demo family, part {name}: {out[name]['part_s']!r} s; "
                  f"{out[name]['part_wavefront_costs_calls']} wavefront_costs calls on {card}")
    out["phase_s"] = time.perf_counter() - start
    out["kernel_launches"] = dict(FAM_KERNEL_LAUNCHES)
    out["wavefront_costs_calls"] = FAM_WAVEFRONT_CALLS[0]
    print(f"demo family: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']} for {out['wavefront_costs_calls']} wavefront_costs calls")
    others = {n: v for n, v in out["kernel_launches"].items() if n != "wavefront_relax" and v}
    if others or out["kernel_launches"]["wavefront_relax"] != out["wavefront_costs_calls"]:
        fail(f"phase 26: kernel entries {out['kernel_launches']} for "
             f"{out['wavefront_costs_calls']} wavefront_costs calls")
    return out


# ---------------------------------------------------------------------------
# 27. the pinned benchmark registry, the render family and the gallery, the
# native host runtime, the scaling report (B2 on every wavefront_costs call)

# tests/test_bench_gate.py's SLOW set, cheapest first by their host time on
# an NVIDIA H100 80GB HBM3 at 700 W (0.17-2.63 s each, PERF.md §6): the
# registry runs every bench outside it first, then these while its host
# time is under SL_BENCH_BUDGET_S (phase 27's budget is 75 s; the renders,
# gallery, native checks and scaling rows take ~24 s of it)
SL_BENCH_SLOW = (
    "localizers-benchmark", "racing-quadrotor-benchmark", "adap-rpf-metrics-benchmark",
    "racing-powertrain-benchmark", "branchout-closed-loop-benchmark",
    "racing-mppi-3d-benchmark", "racing-powertrain-endurance-benchmark",
    "dwa-navigation-benchmark", "racing-powertrain-aware-benchmark",
    "racing-powertrain-budget-benchmark", "mission-recovery-benchmark",
    "pusher-slider-benchmark", "admm-horizon-consensus-benchmark", "slam-node-benchmark")
SL_BENCH_BUDGET_S = 42.0
SL_BENCH_RTOL = 1e-9  # a stochastic bench's cuda = CPU, f64, on its own draws
# the drawing benches whose floats are rounding: ICP's final error mean is
# the residual at f64's floor (~1e-8 m, the root of an expanded squared
# distance; 1.25e-8 on the card against 1.59e-8 on the CPU), and the
# value-guided MPPI's 70 steps and the powertrain-aware race amplify a
# last-bit difference ~10x a step (JAX's own jitted run misses its CSV):
# integers and words exactly, floats within SL_BENCH_ROUNDING_RTOL
SL_BENCH_ROUNDING = frozenset({"icp-benchmark", "mppi-value-benchmark",
                               "racing-powertrain-aware-benchmark"})
SL_BENCH_ROUNDING_RTOL = 1e-2
SL_CPU_PROCESSES, SL_CPU_THREADS = 2, 3  # the CPU runs: processes, torch threads each
SL_GALLERY = ("render_svg_path_planning", "render_svg_dubins")  # test_gallery_embedded.py:48
SL_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "assets")
# the functional columns of the stochastic benches with a gate in the JAX
# tests (test_mppi_value.py: value-guided beats vanilla; test_icp.py:
# converged; test_arm.py: RRT* found): (row, column, test)
SL_BENCH_GATES = {
    "mppi-value-benchmark": (0, "beats_vanilla", lambda v: v == "1"),
    "icp-benchmark": (0, "converged", lambda v: v == "true"),
    "arm-rrt-star-benchmark": (0, "found", lambda v: v == "true"),
}


def _csv_cells_close(got, want, rtol):
    """(ok, max relative difference): two benches' (header, rows) with the
    same header and shape, integers and words equal, floats within rtol."""
    (gh, gr), (wh, wr) = got, want
    if gh != wh or [len(r) for r in gr] != [len(r) for r in wr]:
        return False, math.inf
    worst, ok = 0.0, True
    for g_row, w_row in zip(gr, wr):
        for g, w in zip(g_row, w_row):
            try:
                gf, wf = float(g), float(w)
            except ValueError:
                ok &= g == w
                continue
            if re.fullmatch(r"-?\d+", w):
                ok &= g == w
                continue
            d = abs(gf - wf) / max(abs(wf), 1.0) if math.isfinite(wf) else (
                0.0 if gf == wf else math.inf)
            worst = max(worst, d)
            ok &= d <= rtol
    return ok, worst


def sl_bench_order():
    """The registry's order: every bench outside SL_BENCH_SLOW, then those."""
    return sorted(set(bmk.PINNED) - set(SL_BENCH_SLOW)) + list(SL_BENCH_SLOW)


def sl_cpu_bench_rows(path, names):
    """The CPU f64 runs of the benches `names` (of `DRAWS`) on their own
    draws, with each run's host seconds, into the JSON file `path`: phase
    27 runs it in other processes while the card runs the registry,
    `python3 chip_smoke.py --bench-cpu PATH NAME...`."""
    torch.set_num_threads(SL_CPU_THREADS)
    out = {}
    for name in names:
        start = time.perf_counter()
        header, rows = bmk.run_benchmark(name, device="cpu")
        out[name] = {"header": header, "rows": rows, "cpu_s": time.perf_counter() - start}
        with open(path + ".tmp", "w") as fh:
            json.dump(out, fh)
        os.replace(path + ".tmp", path)


def sl_registry_part(card, device, counted):
    """(a) The pinned registry on the card, f64, in `sl_bench_order()`, the
    SLOW benches while the registry's host time is under SL_BENCH_BUDGET_S.
    A deterministic bench's CSV against docs/assets/ through `compare_csv`
    (headers and rows exact, numerics 1e-6, wall-clock columns ignored); a
    bench of `DRAWS` on its own draws against its CPU run (integers and
    words exact, floats within SL_BENCH_RTOL, SL_BENCH_ROUNDING's within
    SL_BENCH_ROUNDING_RTOL; the CPU runs in SL_CPU_PROCESSES other
    processes meanwhile, `sl_cpu_bench_rows`) and its JAX test's gate
    where SL_BENCH_GATES has one."""
    from rust_robotics_tpu_torch.utils.bench_gate import compare_csv

    out, cut, drawn = {}, [], {}
    start = time.perf_counter()
    order = sl_bench_order()
    drawing = [n for n in order if n in bmk.DRAWS]
    with tempfile.TemporaryDirectory(prefix="bench_cpu_") as tmp:
        cpu_paths = [os.path.join(tmp, f"cpu{i}.json") for i in range(SL_CPU_PROCESSES)]
        cpu_procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--bench-cpu", path,
             *drawing[i::SL_CPU_PROCESSES]]) for i, path in enumerate(cpu_paths)]

        def cpu_done():
            done = {}
            for path in cpu_paths:
                if os.path.exists(path):
                    with open(path) as fh:
                        done.update(json.load(fh))
            return done

        try:
            for name in order:
                if name in SL_BENCH_SLOW and time.perf_counter() - start > SL_BENCH_BUDGET_S:
                    cut.append(name)
                    continue
                short = None
                if name == "mppi-benchmark":  # the registry's profiled call: two MPPI steps
                    short = ("2 MPPI steps", lambda: bmk.run_benchmark(
                        name, device=device, draws=bmk.DRAWS[name][0](
                            torch.Generator().manual_seed(0))[:2]))
                got, stats = fam_part(f"{name} f64 on {card}", lambda name=name: bmk.run_benchmark(
                    name, device=device), counted, short)
                out[name] = {**stats, "rows": got[1]}
                if name in bmk.DRAWS:
                    drawn[name] = got
                    if name in SL_BENCH_GATES:
                        r, col, holds = SL_BENCH_GATES[name]
                        v = got[1][r][got[0].index(col)]
                        _gate(f"{name}: {col} (the JAX test's gate)", holds(v), v)
                    continue
                with open(os.path.join(SL_ASSETS, f"{name}.csv")) as fh:
                    problems = compare_csv(fh.read(), bmk.csv_text(*got))
                _gate(f"{name}: the CSV equals docs/assets/{name}.csv (compare_csv, 1e-6)",
                      not problems, problems or "equal")
            out["cuda_s"] = time.perf_counter() - start
            # the CPU runs of the benches not run here are not waited for
            wait_start = time.perf_counter()
            while (not all(n in cpu_done() for n in drawn)
                   and any(p.poll() is None for p in cpu_procs)):
                time.sleep(0.2)
            out["cpu_wait_s"] = time.perf_counter() - wait_start
            cpu = cpu_done()
        finally:
            for p in cpu_procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    differ = []
    for name, got in drawn.items():
        want = (cpu[name]["header"], cpu[name]["rows"])
        rtol = SL_BENCH_ROUNDING_RTOL if name in SL_BENCH_ROUNDING else SL_BENCH_RTOL
        same, worst = _csv_cells_close(got, want, rtol)
        out[name].update(cpu_s=cpu[name]["cpu_s"], cuda_cpu_max_rel=worst, cpu_rows=want[1])
        print(f"{name}: f64 cuda = CPU on its own draws (integers and words exact, floats "
              f"within {rtol}): max rel diff {worst!r}; cuda {got[1]} CPU {want[1]}")
        if not same:
            differ.append(name)
    if differ:
        fail(f"the registry's drawing benches {differ}: cuda differs from the CPU")
    out["cut_for_time"] = cut
    out["registry_s"] = time.perf_counter() - start
    print(f"registry: {len(bmk.PINNED) - len(cut)} of {len(bmk.PINNED)} benches in "
          f"{out['registry_s']!r} s on {card} (waited {out['cpu_wait_s']!r} s for the CPU "
          f"runs); cut for time: {cut}")
    return out


def _media_ok(path):
    """tests/test_render_family.py:_run's check of one written file."""
    if not os.path.exists(path) or os.path.getsize(path) <= 200:
        return False
    with open(path, "rb") as fh:
        head = fh.read(100)
    return head[:3] == b"GIF" if path.endswith(".gif") else b"<svg" in head


def sl_render_part(card, device, counted):
    """(b) Every render of RENDERS on the card into a temporary directory
    (GIFs through the native writer), each file passing
    tests/test_render_family.py's check; render_svg_euroc_vio skips where
    the reference's fixture is absent."""
    from rust_robotics_tpu_torch import native

    _gate("native runtime built (GIFs through NativeGifWriter)", native.available(),
          native.available())
    out = {}
    with tempfile.TemporaryDirectory(prefix="renders_") as tmp:
        for name, fn in rnd.RENDERS.items():
            path = os.path.join(tmp, name + (".gif" if "gif" in name else ".svg"))
            short = (("the render", lambda: fn(path, device=device))
                     if name == "render_svg_path_planning" else None)
            ret, stats = fam_part(f"{name} on {card}", lambda fn=fn, path=path: fn(
                path, device=device), counted, short)
            if ret is None and not os.path.exists(path):
                print(f"{name}: skipped, source data unavailable")
                out[name] = {**stats, "skipped": "source data unavailable"}
                continue
            _gate(f"{name}: the file passes test_render_family.py's check", _media_ok(path),
                  os.path.getsize(path) if os.path.exists(path) else "missing")
            out[name] = {**stats, "bytes": os.path.getsize(path)}
    return out


def sl_gallery_part(card, device, counted):
    """(c) `build_gallery` on SL_GALLERY in a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="gallery_") as tmp:
        index, stats = fam_part(f"build_gallery {SL_GALLERY} on {card}",
                                lambda: gallery.build_gallery(tmp, names=list(SL_GALLERY),
                                                              device=device), counted)
        with open(index) as fh:
            page = fh.read()
        media = sorted(os.listdir(os.path.join(tmp, "media")))
    _gate("gallery: every tile rendered, no FAILED tile",
          "FAILED" not in page and all(n in page for n in SL_GALLERY) and len(media) == 2, media)
    return {**stats, "media": media}


SL_MAP = "type octile\nheight 4\nwidth 5\nmap\n.....\n..@..\n.TT.G\nSW..O\n"
SL_SCEN = ("version 1\n0\ta.map\t5\t4\t0\t0\t4\t0\t4.0\n"
           "1 a.map 5 4 1 1 3 3 2.828427\n")
SL_G2O = ("VERTEX_SE2 0 0.0 0.0 0.0\nVERTEX_SE2 1 1.0 0.5 0.1\n"
          "EDGE_SE2 0 1 1.0 0.5 0.1 100 0 0 100 0 25\n"
          "VERTEX_SE3:QUAT 7 1 2 3 0 0 0 1\n"
          "EDGE_SE3:QUAT 7 7 0.1 0 0 0 0 0 1 1 0 0 0 0 0 2 0 0 0 0 3 0 0 0 4 0 0 5 0 6\n")


def sl_native_part(card):
    """(d) The native parsers on map, scenario and g2o text equal to the
    pure-Python ones; the native GIF stream decoded by PIL equal to the
    frames through the encoder's palette."""
    from PIL import Image

    from rust_robotics_tpu_torch import native
    from rust_robotics_tpu_torch.data import moving_ai
    from rust_robotics_tpu_torch.slam import g2o

    py_map, nat_map = moving_ai._parse_map_py(SL_MAP), moving_ai.parse_map(SL_MAP)
    same_map = (nat_map.width, nat_map.height) == (py_map.width, py_map.height) and \
        np.array_equal(nat_map.tiles, py_map.tiles)
    same_scen = moving_ai.parse_scenarios(SL_SCEN) == moving_ai._parse_scenarios_py(SL_SCEN)
    py_g, nat_g = g2o._parse_g2o_py(SL_G2O), g2o.parse_g2o(SL_G2O)
    same_g2o = g2o.write_g2o(nat_g) == g2o.write_g2o(py_g) and all(
        np.array_equal(nat_g.edges_se3[0][i], py_g.edges_se3[0][i]) for i in range(2, 5))
    rng = np.random.default_rng(SEED + 27)
    frames = [rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8) for _ in range(3)]
    with tempfile.TemporaryDirectory(prefix="gif_") as tmp:
        path = os.path.join(tmp, "native.gif")
        writer = native.NativeGifWriter(path, 32, 24)
        for fr in frames:
            writer.add_frame(fr, delay_cs=7)
        count = writer.close()
        with Image.open(path) as im:
            decoded = []
            for i in range(im.n_frames):
                im.seek(i)
                decoded.append(np.asarray(im.convert("RGB")))
    same_gif = count == 3 and all(np.array_equal(d, native.quantize_rgb_native(f))
                                  for d, f in zip(decoded, frames))
    out = {"map": same_map, "scenarios": same_scen, "g2o": same_g2o, "gif": same_gif}
    _gate(f"native runtime on {card}'s host: parsers = pure Python, GIF = PIL's decoding",
          all(out.values()), out)
    return out


def sl_scaling_part(card):
    """(e) The scaling report and the chain weak-scaling sweep on one NCCL
    rank."""
    t0 = time.perf_counter()
    train = scaling.run_scaling_report((1,))
    chain = scaling.run_chain_weak_scaling((1,), poses_per_device=2048)
    rows = {"train": train, "chain": chain, "host_s": time.perf_counter() - t0}
    print(f"scaling report on one NCCL rank of {card}: {json.dumps(rows)}")
    _gate("scaling rows: one each, finite, efficiency 1", len(train) == len(chain) == 1 and all(
        math.isfinite(r[k]) for r, k in ((train[0], "loss"), (chain[0], "rmse")))
        and train[0]["efficiency"] == chain[0]["efficiency"] == 1.0, rows)
    return rows


def slice_phase(card, device, counted):
    """The pinned registry, the renders, the gallery, the native runtime and
    the scaling report (phase 27): B2 once per cuda `wavefront_costs` call,
    every other kernel entry never."""
    out = {"card": card}
    FAM_KERNEL_LAUNCHES.clear()
    FAM_WAVEFRONT_CALLS[0] = 0
    start = time.perf_counter()
    with fam_count_wavefront():
        for name, part in (("registry", sl_registry_part), ("renders", sl_render_part),
                           ("gallery", sl_gallery_part)):
            t0 = time.perf_counter()
            calls = FAM_WAVEFRONT_CALLS[0]
            out[name] = part(card, device, counted)
            out[name]["part_s"] = time.perf_counter() - t0
            out[name]["part_wavefront_costs_calls"] = FAM_WAVEFRONT_CALLS[0] - calls
            print(f"phase 27, part {name}: {out[name]['part_s']!r} s; "
                  f"{out[name]['part_wavefront_costs_calls']} wavefront_costs calls on {card}")
    out["native"] = sl_native_part(card)
    for k in counted:
        k.launches = 0
    out["scaling"] = sl_scaling_part(card)
    out["scaling"]["kernel_launches"] = {k.__name__: k.launches for k in counted}
    out["phase_s"] = time.perf_counter() - start
    out["kernel_launches"] = dict(FAM_KERNEL_LAUNCHES)
    out["wavefront_costs_calls"] = FAM_WAVEFRONT_CALLS[0]
    print(f"phase 27: {out['phase_s']!r} s; kernel entries over its parts "
          f"{out['kernel_launches']} for {out['wavefront_costs_calls']} wavefront_costs calls")
    others = {n: v for n, v in out["kernel_launches"].items() if n != "wavefront_relax" and v}
    if (others or out["kernel_launches"]["wavefront_relax"] != out["wavefront_costs_calls"]
            or any(out["scaling"]["kernel_launches"].values())):
        fail(f"phase 27: kernel entries {out['kernel_launches']} for "
             f"{out['wavefront_costs_calls']} wavefront_costs calls; scaling "
             f"{out['scaling']['kernel_launches']}")
    return out


# The SPIKE-chunked chain (phase 28). (a) bench.py's chain at 300,000 poses
# (loop stride 100: 2,999 closures), past the 262,144 poses above which the
# auto rule chunks (`_auto_chunks`: 4 chunks of 75,000 rows), f32, LM as phase
# 15's (PG_ITERATIONS, PG_TOLERANCE, RMSE < PG_CHAIN_RMSE; JAX's 1M row
# measured 7.4e-4).
SC_POSES, SC_CHUNKS = 300_000, 4
# (b) the chunked ladder against the plain one (nested off) on the same
# chain, f64, SC_COMPARE_ITERATIONS LM steps; poses within SC_F64_ATOL. As
# PG_F64_ATOL's: each step's solve is off the exact one by ~kappa·eps of the
# step, kappa ~ n^2 = 9e10 for a 300k chain: 9e10 · 1.1e-16 · 0.03 (a
# first step corrects the 0.03 m perturbation) ~ 3e-7 a step and route, so
# the two routes differ by < 1.2e-6 after 2 steps; 1e-5 leaves ~8x.
SC_COMPARE_ITERATIONS, SC_F64_ATOL = 2, 1e-5
# (c) tests/test_tridiag.py:64-90: `solve_chain_lm(chunks=8)` on the
# 500-pose chain, 25 iterations, f64, cuda against the CPU: kappa ~ n^2 =
# 2.5e5, 2.5e5 · 1.1e-16 · 0.03 ~ 8e-13 a step, < 2e-11 over 25 steps;
# 1e-9 (the JAX test's gate on its own side is 1e-10) leaves 50x.
SC_SMALL, SC_SMALL_CHUNKS, SC_CUDA_CPU_ATOL = 500, 8, 1e-9
SC_SMALL_LM = dict(residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3,
                   max_iterations=25, gradient_tolerance=1e-10, step_tolerance=1e-10,
                   cost_tolerance=1e-16)
# (d) phase 16's anchored 10k SE(3) chain, f32, chunks=4: RMSE < SE3_RMSE_F32,
# and its positions against the unchunked run's within 2 · SE3_RMSE_F32 (RMSE):
# each run is within SE3_RMSE_F32 of the truth, so the two are within twice it.
# (e) CUDA graph = eager, SC_GRAPH_STEPS LM steps of each route, bitwise.
SC_GRAPH_STEPS = 2


def sc_part(out, label, fn):
    """One part of phase 28 under sync debug mode "warn" on the host clock:
    out[label] = fn()'s dict with its seconds and device reads."""
    (seconds, res), reads = reads_in(lambda: timed(fn))
    out[label] = {**res, "part_s": seconds, "device_reads": reads}
    print(f"phase 28, part {label}: {seconds!r} s; {reads} device reads")


def sc_full_width(card, device):
    """(a) The 300k chain f32 through `optimize_pose_graph_2d(chain_direct)`
    with the auto rule, to its end; one step profiled."""
    truth, initial, ef, et, meas, info = pose_graph_bench.synthesize_chain(SC_POSES)
    chunks = _auto_chunks(SC_POSES, None)
    loops = int((et - ef != 1).sum())
    per_chunk = tridiag.woodbury_edge_chunk(SC_POSES, loops, 3, tridiag.WOODBURY_CHUNK_BYTES,
                                            chunks)
    if chunks != SC_CHUNKS:
        fail(f"the auto rule gave {chunks} chunks at {SC_POSES} poses, not {SC_CHUNKS}")
    sites = {}
    steps = tridiag.lm_run.steps
    (seconds, (poses, summary)), reads = reads_in(lambda: timed(lambda: optimize_pose_graph_2d(
        initial, ef, et, meas, info, PG_ITERATIONS, PG_TOLERANCE, "chain_direct",
        device=device)), sites)
    steps = tridiag.lm_run.steps - steps
    err = pose_graph_bench.rmse(poses.cpu().numpy(), truth)
    print(f"spike-chunked {SC_POSES} chain f32 on {card}: {chunks} chunks of "
          f"{-(-SC_POSES // chunks)} rows; {loops} closures in {-(-loops // per_chunk)} Woodbury "
          f"edge chunks of {per_chunk} an iteration; RMSE {err!r} (gate {PG_CHAIN_RMSE}); "
          f"{seconds!r} s host clock (the graph's capture included); {summary}; device reads "
          f"{reads} ({reads / max(steps, 1)!r} an iteration; by site {sites})")
    if not err < PG_CHAIN_RMSE:
        fail(f"the {SC_POSES} chain: RMSE {err!r} >= {PG_CHAIN_RMSE}")
    _, init_d, args = chain_problem_on(device, torch.float32, SC_POSES)
    state, step = tridiag.chain_lm_start(init_d[None], *args, chunks=chunks, **PG_LM)
    prof = device_breakdown(f"spike-chunked {SC_POSES} chain, one LM step (f32, a graph "
                            f"replay) on {card}", lambda: step(state), full=False)
    return {"seconds": seconds, "rmse": err, "iterations": summary.iterations,
            "termination": summary.termination, "chunks": chunks, "rows_per_chunk":
            -(-SC_POSES // chunks), "closures": loops, "woodbury_edge_chunks_per_iteration":
            -(-loops // per_chunk), "reads_per_iteration": reads / max(steps, 1),
            "read_sites": sites, "launches_per_iteration": len(prof["names"]),
            "profile": {k: v for k, v in prof.items() if k != "names"}}


def sc_chunked_against_plain(card, device):
    """(b) The 300k chain in f64, SC_COMPARE_ITERATIONS LM steps through the
    chunked ladder and the plain one: equal counts, poses within
    SC_F64_ATOL; each route's start and warm s a step (the lesser of its
    two). The steps run eagerly: at this size a step is device-bound (a
    graph replay of (a)'s idles 0.012), so its capture would buy nothing
    in two steps; (e) holds the graph to the eager step."""
    _, init, args = chain_problem_on(device, torch.float64, SC_POSES)
    out, ends = {}, {}
    for route, kw in (("chunked", dict(chunks=SC_CHUNKS)), ("plain", dict(chunks=0,
                                                                          nested=False))):
        start_s, (state, step) = timed(lambda: tridiag.chain_lm_start(
            init[None], *args, graphed=False, **PG_LM, **kw))
        times = []
        for _ in range(SC_COMPARE_ITERATIONS):
            t, state = timed(lambda: step(state))
            times.append(t)
        ends[route] = tridiag.LMState(*(x.clone() for x in state))
        out[route] = {"start_s": start_s, "warm_s_per_step": min(times),
                      "iterations": int(ends[route].it), "accepted": int(ends[route].accepted)}
        print(f"spike-chunked {SC_POSES} chain f64 {route} on {card}: start {start_s!r} s, "
              f"eager steps {times} s; {out[route]}")
        del state, step
    diff = float((ends["chunked"].values - ends["plain"].values).abs().max())
    out["max_abs_diff"] = diff
    print(f"spike-chunked {SC_POSES} chain f64: chunked against plain after "
          f"{SC_COMPARE_ITERATIONS} steps max|diff| {diff!r} (atol {SC_F64_ATOL}); faster on "
          f"{card}: {min(('chunked', 'plain'), key=lambda r: out[r]['warm_s_per_step'])}")
    counts = [(out[r]["iterations"], out[r]["accepted"]) for r in ("chunked", "plain")]
    if counts[0] != counts[1] or not diff <= SC_F64_ATOL:
        fail(f"chunked against plain: counts {counts}, max|diff| {diff!r} > {SC_F64_ATOL}")
    return out


def sc_cuda_against_cpu(card, device):
    """(c) JAX's test, `solve_chain_lm(chunks=8)` on the 500-pose chain for
    25 iterations, f64, cuda against the CPU."""
    runs = {}
    for where in (device, "cpu"):
        _, init, args = chain_problem_on(where, torch.float64, SC_SMALL)
        values, summ = tridiag.solve_chain_lm(init, *args, chunks=SC_SMALL_CHUNKS,
                                              **SC_SMALL_LM)
        runs[str(where)] = (values.cpu().numpy(), [int(x) for x in summ[2:]])
    diff = float(np.abs(runs[str(device)][0] - runs["cpu"][0]).max())
    print(f"spike-chunked {SC_SMALL} chain f64 chunks={SC_SMALL_CHUNKS} on {card} against the "
          f"CPU: (iterations, accepted, termination) {runs[str(device)][1]} and "
          f"{runs['cpu'][1]}, max|diff| {diff!r} (atol {SC_CUDA_CPU_ATOL})")
    if runs[str(device)][1] != runs["cpu"][1] or not diff <= SC_CUDA_CPU_ATOL:
        fail(f"the {SC_SMALL} chain chunks={SC_SMALL_CHUNKS}: cuda against the CPU "
             f"{runs[str(device)][1]} {runs['cpu'][1]}, max|diff| {diff!r}")
    return {"counts": runs["cpu"][1], "max_abs_diff": diff}


def sc_anchored(card, device):
    """(d) Phase 16's anchored 10k SE(3) chain, f32, with chunks=4."""
    truth_t, tm, init_t, ef, et, meas, info = pose_graph_bench.synthesize_se3_chain(SE3_CHAIN)
    kw = dict(max_iterations=SE3_ITERATIONS, tolerance=SE3_TOLERANCE,
              linear_solver="chain_direct", anchored=True, device=device)
    if "poses" not in SE3_ANCHORED:  # the phase run alone
        SE3_ANCHORED["poses"] = optimize_pose_graph_3d(init_t, ef, et, meas, info,
                                                       **kw)[0].cpu().numpy()
    seconds, (poses, summary) = timed(lambda: optimize_pose_graph_3d(
        init_t, ef, et, meas, info, chunks=SC_CHUNKS, **kw))
    poses = poses.cpu().numpy()
    err = pose_graph_bench.se3_position_rmse(poses, tm)
    gap = pose_graph_bench.se3_position_rmse(
        poses, lie_np.se3_exp(SE3_ANCHORED["poses"].astype(np.float64)))
    print(f"SE(3) {SE3_CHAIN} chain f32 anchored chunks={SC_CHUNKS} on {card}: RMSE {err!r} "
          f"(gate {SE3_RMSE_F32}); positions against the unchunked run {gap!r} (RMSE, gate "
          f"{2 * SE3_RMSE_F32}); {seconds!r} s host clock (first call); last round {summary}")
    if not (err < SE3_RMSE_F32 and gap < 2 * SE3_RMSE_F32):
        fail(f"anchored SE(3) chunks={SC_CHUNKS}: RMSE {err!r}, against unchunked {gap!r}")
    return {"rmse": err, "against_unchunked": gap, "seconds": seconds,
            "last_round": vars(summary)}


def sc_graph_gate(card, device):
    """(e) The chain LM's CUDA graph bitwise the eager step, SC_GRAPH_STEPS
    steps of each route: plain, nested and chunked on the 10k chain, the LU
    capacitance (spd=False, the anchored path's), and 256 lanes of 200
    poses (the serving row)."""
    _, init, args = chain_problem_on(device, torch.float32, PG_CHAIN)
    _, init_b, args_b = pose_graph_bench.batched_problem(*PG_SERVING, device)
    routes = {"plain": (init[None], args, {}), "nested": (init[None], args, dict(nested=True)),
              "chunked": (init[None], args, dict(chunks=SC_CHUNKS)),
              "lu": (init[None], args, dict(spd=False)), "lanes": (init_b, args_b, {})}
    out = {}
    for route, (values, a, kw) in routes.items():
        first, eager = tridiag.chain_lm_start(values, *a, graphed=False, **PG_LM, **kw)
        _, graphed = tridiag.chain_lm_start(values, *a, graphed=True, **PG_LM, **kw)
        if not hasattr(graphed, "graph"):
            fail(f"the chain LM's {route} step is not a CUDA graph")
        want = got = first
        same = True
        for _ in range(SC_GRAPH_STEPS):
            want, got = eager(want), graphed(got)
            same &= all(bitwise_equal(g, w) for g, w in zip(got, want))
        out[route] = same
        print(f"chain LM graph on {card}, {route}: {SC_GRAPH_STEPS} replays bitwise the eager "
              f"steps: {same}")
    if not all(out.values()):
        fail(f"the chain LM's graph differs from its eager step: {out}")
    return {"bitwise": out}


def spike_chunked_phase(card, device):
    """The SPIKE-chunked chain (phase 28), each part once under sync debug
    mode "warn" on the host clock."""
    out = {"card": card}
    start = time.perf_counter()
    tridiag._CHAIN_STEPS.clear()  # the earlier phases' graphs and their memory
    torch.cuda.empty_cache()
    for label, part in (("full_width_f32", sc_full_width),
                        ("chunked_against_plain_f64", sc_chunked_against_plain),
                        ("cuda_against_cpu_f64", sc_cuda_against_cpu),
                        ("anchored_se3_f32", sc_anchored), ("graph_gate", sc_graph_gate)):
        sc_part(out, label, lambda: part(card, device))
    tridiag._CHAIN_STEPS.clear()
    out["phase_s"] = time.perf_counter() - start
    print(f"phase 28: {out['phase_s']!r} s on {card}")
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


def trace_loss_probe(traces=150):
    """ROADMAP C10 on the card: `traces` torch.profiler traces of one call,
    host and device activities or the device's alone, with no idle time
    around the call and with TRACE_MARGIN_S of it on each side, for one
    histogram update+predict of 1024 rasters (f64) and for one add; per
    case, the traces with no device event and those with fewer than the
    most seen."""
    device, f64 = "cuda", torch.float64
    cfg = HistogramConfig()
    gen = torch.Generator(device=device).manual_seed(SEED)
    lms = torch.tensor([[5.0, 5.0], [-5.0, 5.0], [0.0, -5.0]], dtype=f64, device=device)
    truth = 8.0 * torch.rand((HIST_FLEET, 2), dtype=f64, device=device, generator=gen) - 4.0
    z = torch.linalg.norm(lms - truth[:, None], dim=-1)
    still = torch.zeros((HIST_FLEET, 2), dtype=f64, device=device)
    bel = histogram_init(cfg, f64, device=device, batch_shape=(HIST_FLEET,))
    calls = {"histogram update+predict": lambda: histogram_predict(
                 histogram_update_ranges(bel, z, lms, cfg), still, cfg),
             "one add": lambda: z + 1.0}
    for fn in calls.values():
        fn()

    def count(fn, margin, activities):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(margin)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())

    out = {}
    for name, fn in calls.items():
        for margin in (0.0, TRACE_MARGIN_S):
            for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]):
                counts = [count(fn, margin, acts) for _ in range(traces)]
                key = f"{name}, margin {margin} s, {'host+device' if len(acts) == 2 else 'device'}"
                out[key] = {"traces": traces, "empty": sum(c == 0 for c in counts),
                            "short": sum(0 < c < max(counts) for c in counts),
                            "events": max(counts)}
                print(f"{key}: {out[key]}", flush=True)
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
    try:
        peaks = card_peaks(name)
    except ValueError as exc:
        fail(str(exc))
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
    start = time.perf_counter()
    b3_branches = resample_branch_checks(device)
    b3_ptxas = resample_ptxas()
    b3_added_s = time.perf_counter() - start

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
    start = time.perf_counter()
    flush = torch.empty(RESAMPLE_FLUSH_BYTES, dtype=torch.uint8, device=device)
    b3_pinned_cold = resample_cold_ms(pinned_args, flush)
    b3_added_s += time.perf_counter() - start
    print(f"resample pinned B={pb} P={pp} D={RESAMPLE_D} f32 on {card}: the kernel's own device "
          f"time (profiler) min {b3_pinned_profiler['min_ms']!r} ms, mean "
          f"{b3_pinned_profiler['mean_ms']!r} ms over {b3_pinned_profiler['launches']} launches "
          f"(inputs warm in L2); cold (a {RESAMPLE_FLUSH_BYTES >> 20} MB buffer zeroed between "
          f"calls) min {b3_pinned_cold['min_ms']!r} ms, mean {b3_pinned_cold['mean_ms']!r} ms; "
          f"CUDA events around the wrapper {b3_times['pinned']['ms']!r} ms; bound "
          f"{b3_times['pinned']['bound_ms']!r} ms")
    print(f"resample: the branch checks, ptxas report and cold pinned timing took {b3_added_s!r} s")
    del pinned_args, flush
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
    pose_graph = pose_graph_phase(card, device)
    print(json.dumps({"pose_graph": pose_graph}))

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

    # 20. the SPIKE programs on one NCCL rank (no kernel on their path)
    for fn in counted:
        fn.launches = 0
    spike_out = spike_phase(card, device)
    spike_out["kernel_launches"] = {fn.__name__: fn.launches for fn in counted}
    print(f"kernel launches in the SPIKE programs: {spike_out['kernel_launches']}")
    print(json.dumps({"parallel_spike": spike_out}))

    # 21. the navigation stack: DWA and the demos, mapping, grid search
    # (no kernel on its path)
    print(json.dumps({"navigation": navigation_phase(card, device, counted)}))

    # 22. planning II: any-angle, A* variants, fields, frontier, risk,
    # coverage, road maps, temporal, conformal, STL (B2 on fields, coverage
    # and frontier)
    planning_ii = planning_ii_phase(card, device, counted)
    print(json.dumps({"planning_ii": planning_ii}))

    # 23. the control layer: trackers, laws, CBF, ADMM, MPC, iLQR/DDP,
    # C/GMRES, the rocket, the arm, MPPI and its variants, gate racing, the
    # pusher-slider (B2 on the value-guided MPPI's grid)
    control = control_phase(card, device, counted)
    print(json.dumps({"control": control}))

    # 24. the kinematic planners: curves, Frenet, Reeds-Shepp, eta3, the RRT
    # family and its variants, the kinematic RRTs, the reactive planners,
    # hybrid A*, the lattice, CHOMP, bipedal (no kernel on their path)
    print(json.dumps({"kinematic_planning": kinematic_phase(card, device, counted)}))

    # 25. the rigid-body and BranchOut planners, the aerial, meta and arena
    # controllers, the compaction runner, the experiment suites, utils/ and
    # viz/ (no kernel on their path)
    rates = {"ekf_updates_per_s": updates,
             "resampled_particles_per_s": b3_times["saturated"]["particles_per_s"]}
    print(json.dumps({"breadth": breadth_phase(card, device, counted, rates,
                                               pose_graph["serving"])}))

    # 26. the headless demo family, the playground, dataflow, the speed
    # comparison and the embedded demo (B2 on every wavefront_costs call)
    family = family_phase(card, device, counted)
    print(json.dumps({"family": family}))

    # 27. the pinned benchmark registry, the renders and the gallery, the
    # native runtime, the scaling report (B2 on every wavefront_costs call)
    tools = slice_phase(card, device, counted)
    print(json.dumps({"tools": tools}))

    # 28. the SPIKE-chunked chain: the 300k chain, chunked against plain, the
    # 500-pose chain cuda against the CPU, the anchored SE(3) chain, the chain
    # LM's graph against its eager step (no kernel on its path)
    for fn in counted:
        fn.launches = 0
    spike_chunked = spike_chunked_phase(card, device)
    spike_chunked["kernel_launches"] = {fn.__name__: fn.launches for fn in counted}
    if any(spike_chunked["kernel_launches"].values()):
        fail(f"phase 28 launched kernels: {spike_chunked['kernel_launches']}")
    print(json.dumps({"spike_chunked": spike_chunked}))

    # 29. the kernels line
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
                       "profiler_kernel_cold_ms": b3_pinned_cold,
                       "bound_ms": b3_times["pinned"]["bound_ms"]}} if rp == 1024 else {}),
        "branches": b3_branches,
        "ptxas": b3_ptxas,
        "checks_added_s": b3_added_s,
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
        "launches_planning_ii": planning_ii["kernel_launches"]["wavefront_relax"],
        "path_planning_ii": "phase 22's fields, coverage and frontier parts: one launch per "
                            "wavefront_costs call (flow_field, coverage_transform's and "
                            "obstacle_distance_transform's, frontier_navigate's two an episode)",
        "launches_control": control["kernel_launches"]["wavefront_relax"],
        "path_control": "phase 23's value-guided MPPI (bench_mppi_value): one launch per "
                        "wavefront_costs call of its 48x48 terminal-value grid",
        "launches_family": family["kernel_launches"]["wavefront_relax"],
        "path_family": "phase 26: one launch per wavefront_costs call (headless_grid_planners' "
                       "two plan_grid calls, headless_mppi_terminal_value's grid, the "
                       "playground's 12 grid plans, dataflow's planner a tick, the speed "
                       "comparison's A* a run)",
        "family_calls": {p: family[p]["part_wavefront_costs_calls"]
                         for p in ("headless", "playground", "dataflow", "speed", "embedded")},
        "launches_tools": tools["kernel_launches"]["wavefront_relax"],
        "path_tools": "phase 27: one launch per wavefront_costs call (the benches' grid "
                      "planners, coverage and value-guided MPPI grid, the renders' path "
                      "planning, any-angle, frontier and value grid, the gallery's path "
                      "planning)",
        "tools_calls": {p: tools[p]["part_wavefront_costs_calls"]
                        for p in ("registry", "renders", "gallery")},
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

    # 30. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def resample_times():
    """`python3 chip_smoke.py --resample-times`: B3 alone at bench.py's three
    f32 shapes, to compare two trees on one card (run it from each tree's
    root, in turns; it calls only the entry, so it measures any tree's
    kernel): CUDA events around the wrapper (min over 5 bursts of 20 calls),
    then the kernel's own device time by the profiler (min and mean of 20
    launches), at the pinned shape also with its inputs cold. Prints the
    card and one JSON line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    device = torch.device("cuda", 0)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    print(f"build: {_build.build(['resample'])}")
    rng = np.random.default_rng(SEED + 2)
    inputs = {key: resample_inputs(rng, rb, rp, RESAMPLE_D, torch.float32, device)
              for key, (rb, rp) in RESAMPLE_SHAPES.items()}
    out = {}
    for key, args in inputs.items():  # events first: the profiler slows what follows it
        out[key] = {"events_ms": time_ms(lambda: systematic_resample_gather(*args), 20, 5),
                    "bound_ms": resample_bound(*RESAMPLE_SHAPES[key], RESAMPLE_D, torch.float32,
                                               peaks)[0][0]}
    for key, args in inputs.items():
        out[key]["kernel"] = kernel_device_ms(lambda: systematic_resample_gather(*args),
                                              "resample_kernel")
    flush = torch.empty(RESAMPLE_FLUSH_BYTES, dtype=torch.uint8, device=device)
    out["pinned"]["kernel_cold"] = resample_cold_ms(inputs["pinned"], flush)
    print(json.dumps({"resample_times": out, "card": smi, "root": os.getcwd()}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resample-times"]:
        sys.exit(resample_times())
    if sys.argv[1:2] == ["--bench-cpu"]:
        sl_cpu_bench_rows(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
