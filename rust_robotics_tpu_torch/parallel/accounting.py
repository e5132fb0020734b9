"""Per-iteration FLOP and collective-volume accounting for the SPIKE
solvers: the port's own copy of rust_robotics_tpu/parallel/accounting.py
(pure Python, held equal to it by tests/test_torch_parallel.py).

Model (counts, not measurements):

- Cyclic-reduction ladder over m blocks of size b: each level halves the
  active length and does, per surviving block pair, one SPD inverse
  (~2b³ via the Schur recursion) and six b×b matmuls (2b³ each) — ~14b³
  per block, summed over levels ≈ m blocks total (geometric series).
- A ladder APPLY with r RHS columns: four b×b·b×r products per block
  over ~2m total block rows → ~8·m·b²·r.
- SPIKE factor phase: local ladder factor at m/D rows + one 2b-column
  apply for the spikes + the interface pre-elimination (dense (2Db)³·2/3
  LU, or block-Thomas D·(~4·(2b)³) — the dense-interface switch).
- SPIKE apply phase: local ladder apply at m/D rows + interface
  back-substitution.
- Collectives: factor all_gathers the W/V tips (D·2·b·2b scalars);
  each apply all_gathers the G tips (D·2·b·r scalars).
"""

from __future__ import annotations

from typing import NamedTuple


class SpikeAccounting(NamedTuple):
    serial_factor_flops: float      # single-device ladder factor
    local_factor_flops: float       # per-device SPIKE factor (ladder part)
    spike_columns_flops: float      # per-device 2b-column spike apply
    interface_factor_flops: float   # replicated interface pre-elimination
    serial_apply_flops: float       # single-device ladder apply (r cols)
    local_apply_flops: float        # per-device SPIKE apply (ladder part)
    interface_apply_flops: float    # replicated interface back-subst.
    factor_gather_bytes: float      # all_gather volume at factor time
    apply_gather_bytes: float       # all_gather volume per apply


def ladder_factor_flops(m: int, b: int) -> float:
    """Cyclic-reduction factorization of m blocks of size b."""
    return 14.0 * m * b**3


def ladder_apply_flops(m: int, b: int, r: int) -> float:
    """Ladder apply with r RHS columns."""
    return 8.0 * m * b**2 * r


def spike_accounting(ns: int, b: int, devices: int, r: int,
                     dense_interface_max: int = 256,
                     dtype_bytes: int = 4) -> SpikeAccounting:
    """Accounting for one damped-system SPIKE factor + one r-column
    apply over `devices` devices, blocks [ns, b, b].

    The headline identity (pinned by tests/test_sharded_banded.py):
    local ladder work ≈ serial / D, and the interface work is o(ladder)
    once ns/D >> D — the partitioned solve is work-efficient."""
    d = devices
    m_loc = -(-ns // d)
    iface_dim = 2 * d * b
    if iface_dim <= dense_interface_max:
        iface_factor = (2.0 / 3.0) * iface_dim**3
        iface_apply = 2.0 * iface_dim**2 * r
    else:
        # block-Thomas: per device step, one (2b)³ inverse (~2x) plus
        # two (2b)³ products; apply is 3 (2b)²·r products per step
        iface_factor = d * 4.0 * (2 * b) ** 3
        iface_apply = d * 3.0 * (2 * b) ** 2 * r
    return SpikeAccounting(
        serial_factor_flops=ladder_factor_flops(ns, b),
        local_factor_flops=ladder_factor_flops(m_loc, b),
        spike_columns_flops=ladder_apply_flops(m_loc, b, 2 * b),
        interface_factor_flops=iface_factor,
        serial_apply_flops=ladder_apply_flops(ns, b, r),
        local_apply_flops=ladder_apply_flops(m_loc, b, r),
        interface_apply_flops=iface_apply,
        factor_gather_bytes=float(d * 2 * b * 2 * b * dtype_bytes),
        apply_gather_bytes=float(d * 2 * b * r * dtype_bytes),
    )


def lm_iteration_flops(ns: int, b: int, devices: int, grad_cols: int,
                       woodbury_cols: int, woodbury_chunks: int,
                       **kw) -> dict:
    """Totals for ONE banded LM iteration on the sharded path with the
    (factor, apply) hook: 1 factor + (1 gradient apply + nc Woodbury
    chunk applies + 1 correction apply), all sharing the factorization.
    Returns a dict with per-device and replicated totals plus the
    round-4 comparison (the single-callable hook refactored per apply)."""
    acc = spike_accounting(ns, b, devices, grad_cols, **kw)
    applies = 2 + woodbury_chunks  # gradient + chunks + correction
    wood_cols_per_chunk = max(woodbury_cols // max(woodbury_chunks, 1), 1)
    apply_ladder = (
        acc.local_apply_flops  # gradient (r = grad_cols)
        + woodbury_chunks * ladder_apply_flops(
            -(-ns // devices), b, wood_cols_per_chunk)
        + acc.local_apply_flops)  # correction
    per_device = (acc.local_factor_flops + acc.spike_columns_flops
                  + apply_ladder)
    r4_per_device = applies * (acc.local_factor_flops
                               + acc.spike_columns_flops) + apply_ladder
    return {
        "factor_once_per_device_flops": per_device,
        "round4_refactor_per_apply_flops": r4_per_device,
        "replicated_interface_flops": (
            acc.interface_factor_flops + applies * acc.interface_apply_flops),
        "serial_equivalent_flops": (
            acc.serial_factor_flops + 2 * acc.serial_apply_flops
            + woodbury_chunks * ladder_apply_flops(
                ns, b, wood_cols_per_chunk)),
        "collective_bytes": (
            acc.factor_gather_bytes + applies * acc.apply_gather_bytes),
    }
