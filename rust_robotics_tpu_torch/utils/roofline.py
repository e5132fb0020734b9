"""Roofline accounting for the headline workloads, on the card the port runs on.

The port of rust_robotics_tpu/utils/roofline.py. Each model pins the
analytic work per unit of a workload's metric and turns a measured rate
into achieved operations/s and memory bytes/s and their shares of the
card's peaks. The JAX package's peaks are a TPU v5e's; the port's are the
data-sheet peaks of the NVIDIA cards in `CARDS`, the one table that
`chip_smoke.py` also reads for every kernel's bound.

Each model counts the work the port's code does, which is not always the
JAX package's figure: where they differ, the comment says why.
"""

from __future__ import annotations

import dataclasses

import torch

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
H100_PEAK = CARDS[-1][1]


def card_peaks(name: str) -> dict:
    """The peaks of the first entry of `CARDS` whose fragment is in `name`;
    ValueError for a card the table does not know."""
    for fragment, peaks in CARDS:
        if fragment in name:
            return peaks
    raise ValueError(f"no data-sheet peaks known for card {name!r}")


# Least arithmetic of one EKF step of the unicycle + GPS model, counting
# only terms the model's sparsity leaves non-zero: 118 adds/multiplies/
# divides plus 4 sin/cos counted as one operation each. (The JAX package
# counts ~360 flops, with the dense products its kernel computes.)
EKF_OPS_PER_STEP = 122
# The least work of one sweep of one cell of the grid kernel (B2),
# min(cur, s + straight, g + diagonal): per direction a bit test and a min
# into s or g, and per kind of direction (straight, and with 8 directions
# diagonal) an add and a min with the cell. None of them is an FMA, so
# each is one instruction per lane per clock: half the float32 peak,
# which counts an FMA as two.
WAVEFRONT_OPS_PER_DIRECTION = 2
WAVEFRONT_OPS_PER_KIND = 2
# Resampling per particle: normalise, square-add, scan add, CDF divide,
# position add+divide, and a log2(P)-step binary search.
RESAMPLE_OPS_PER_PARTICLE = 7


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Analytic per-unit work for one workload."""

    name: str
    flops_per_unit: float      # arithmetic operations per unit of the metric
    hbm_bytes_per_unit: float  # memory traffic per unit (amortized)
    bound: str                 # "operations" | "bytes" — expected limiter
    # the share of the card's compute peak these operations can reach (0.5
    # where none is a fused multiply-add, which the peak counts as two)
    peak_share: float = 1.0

    def report(self, units_per_s: float, peaks: dict = H100_PEAK,
               dtype=torch.float32) -> dict:
        flops = units_per_s * self.flops_per_unit
        bw = units_per_s * self.hbm_bytes_per_unit
        peak_flops = peaks["flops"][dtype] * self.peak_share
        return {
            "achieved_flops_per_s": flops,
            "achieved_hbm_bytes_per_s": bw,
            "pct_of_compute_peak": 100.0 * flops / peak_flops,
            "pct_of_hbm_peak": 100.0 * bw / peaks["bytes_per_s"],
            "expected_bound": self.bound,
        }


# --- workload models (formulas documented inline) --------------------------

# The EKF scan kernel (B1, csrc/ekf_scan.cu), 4-state unicycle + 2D GPS,
# per update: EKF_OPS_PER_STEP operations. Memory per update (the T-step
# chain's belief stays in registers): z[2] + u[2] f32 read = 16 B; belief
# in and out amortized over T=200 steps, (4+16)·4·2/200 = 0.8 B.
EKF_UPDATE = WorkloadModel("ekf_update", flops_per_unit=float(EKF_OPS_PER_STEP),
                           hbm_bytes_per_unit=16.8, bound="bytes")

# Wavefront relaxation, the plain-PyTorch twin (one tensor op per
# direction, each a pass over memory; the JAX package's XLA path has the
# same shape), per cell per sweep, 8-connected: the kernel's 20 operations
# (WAVEFRONT_OPS_*) at half the peak; memory: the field read and written
# (4 + 4 B) and the direction bits (1 B) at least once a sweep.
WAVEFRONT_XLA = WorkloadModel(
    "wavefront_sweep_cell_xla",
    flops_per_unit=float(8 * WAVEFRONT_OPS_PER_DIRECTION + 2 * WAVEFRONT_OPS_PER_KIND),
    hbm_bytes_per_unit=9.0, bound="bytes", peak_share=0.5)

# The grid kernel (B2, csrc/wavefront_sweep.cu), which replaces the Pallas
# kernel (name kept): one launch a call, the field held on chip until
# every map stops, so memory is the field in and out and the bit plane
# once a call (9 B a cell) over the sweeps of the call: bench.py's
# 64 x 128² maps need 181 (chip_smoke.py phase 10).
WAVEFRONT_PALLAS = WorkloadModel(
    "wavefront_sweep_cell_pallas",
    flops_per_unit=float(8 * WAVEFRONT_OPS_PER_DIRECTION + 2 * WAVEFRONT_OPS_PER_KIND),
    hbm_bytes_per_unit=9.0 / 181, bound="operations", peak_share=0.5)

# The resampling kernel (B3, csrc/resample.cu), per particle at P=1024:
# RESAMPLE_OPS_PER_PARTICLE + log2(P) operations. (The JAX package's 4,200
# flops a particle count its one-hot gather matmul and [P, P] triangular
# prefix sum, which the port left out: a scan and a gather do the same
# work.) Memory per particle at D=4 f32: weight 4 B, the states read and
# written 2·16 B, the index 4 B.
RESAMPLE = WorkloadModel("resampled_particle", flops_per_unit=RESAMPLE_OPS_PER_PARTICLE + 10.0,
                         hbm_bytes_per_unit=40.0, bound="bytes")

# The device-resident 10k-pose chain LM (nlls/tridiag.py, plain PyTorch:
# the same cyclic-reduction ladder and streamed Woodbury as the JAX
# package). Per LM iteration, n=10k, t=3, K=297 Woodbury columns: the
# ladder on the [n, 3, 3+K] rhs ~6.5e8, block ops ~1e8, linearize ~2e7,
# the capacitance products n·t·K²·2 ≈ 1.6e9 => ~2.4e9 operations.
CHAIN_SOLVE_10K = WorkloadModel("chain_lm_iteration_10k", flops_per_unit=2.4e9,
                                hbm_bytes_per_unit=0.0, bound="operations")


def roofline_extras(measured: dict, peaks: dict = H100_PEAK) -> dict:
    """Build the bench.py roofline extras from measured rates.

    measured keys (any subset): ekf_updates_per_s, wavefront_cells_per_s,
    wavefront_pallas_cells_per_s, resampled_particles_per_s,
    chain_lm_iterations_per_s.
    """
    models = {
        "ekf_updates_per_s": EKF_UPDATE,
        "wavefront_cells_per_s": WAVEFRONT_XLA,
        "wavefront_pallas_cells_per_s": WAVEFRONT_PALLAS,
        "resampled_particles_per_s": RESAMPLE,
        "chain_lm_iterations_per_s": CHAIN_SOLVE_10K,
    }
    out = {}
    for key, rate in measured.items():
        if key in models and rate:
            out[models[key].name] = models[key].report(rate, peaks)
    return out
