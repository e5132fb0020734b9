"""Multi-rank general-graph solver: SPIKE over fat supernodal blocks.

The port of rust_robotics_tpu/parallel/sharded_banded.py. The RCM-banded
supernodal system of `nlls/banded.py` is block-tridiagonal in supernodes,
which is the structure the SPIKE phases of `sharded_tridiag.py` partition,
and those phases take blocks of any width. Each rank factors its run of
fat (s·t)² blocks; the interface system over the 2D chunk-boundary rows
is pre-eliminated by block-Thomas on every rank once 2·D·s·t exceeds
`sharded_tridiag._DENSE_INTERFACE_MAX` (the dense solve below).

Split of labour: the linearisation, the fat-block scatter and the LM run
on every rank alike (edge Jacobians are O(E·t²), the ladder
O(Ns·(s·t)³)); only the ladder is split over the axis, injected through
`solve_banded_lm`'s `fat_solve` hook as a (factor, apply) pair. The local
ladder, the spikes and the interface elimination are computed once per
damped system and reused by the gradient, Woodbury-column and correction
applies of that LM iteration; every apply all-gathers the solution, so
that every rank holds the same x and takes the same LM decisions.

The system is global on every rank, so a rank reads its coupling blocks
to its neighbours from it directly, where JAX's `shard_map` shifts them
around the ring. JAX caches the pair per (mesh, axis) because the hook is
a static argument of a jitted LM; nothing here is traced, so there is no
cache.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.nlls.banded import solve_general_graph
from rust_robotics_tpu_torch.parallel.mesh import axis_index, axis_size, gather_shards
from rust_robotics_tpu_torch.parallel.sharded_tridiag import (
    spike_apply_local,
    spike_factor_local,
)


def _pad_system(diag, upper, num_devices):
    """diag [..., Ns, B, B] and upper [..., Ns-1, B, B] padded to ns_pad, a
    multiple of num_devices, with decoupled identity blocks. The padded
    upper has ns_pad blocks: rank d's rows [d·m, d·m + m) carry uppers
    [d·m, d·m + m), the last of which couples it to rank d + 1. Returns
    (diag_p, upper_p, ns_pad)."""
    ns, b = diag.shape[-3], diag.shape[-1]
    lead = diag.shape[:-3]
    ns_pad = -(-ns // num_devices) * num_devices
    if ns_pad > ns:
        eye = torch.eye(b, dtype=diag.dtype, device=diag.device)
        diag = torch.cat([diag, eye.expand(*lead, ns_pad - ns, b, b)], -3)
    upper = torch.cat([upper, upper.new_zeros((*lead, ns_pad - upper.shape[-3], b, b))], -3)
    return diag, upper, ns_pad


def make_sharded_fat_factor_apply(mesh, axis: str):
    """The (factor, apply) pair for `solve_banded_lm`'s fat_solve hook:
    factor(diag [..., Ns, B, B], upper [..., Ns-1, B, B]) -> fac, this
    rank's SPIKE factorisation of its run of blocks (Ns padded to a
    multiple of the axis size with identity blocks); apply(fac, rhs
    [..., Ns, B, r]) -> x [..., Ns, B, r], gathered on every rank."""
    dd, d = axis_size(mesh, axis), axis_index(mesh, axis)

    def factor(diag, upper):
        ns = diag.shape[-3]
        diag_p, up_p, ns_pad = _pad_system(diag, upper, dd)
        m = ns_pad // dd
        a_left = up_p[..., d * m - 1, :, :].mT if d > 0 else None
        c_right = up_p[..., (d + 1) * m - 1, :, :] if d < dd - 1 else None
        state = spike_factor_local(diag_p[..., d * m:(d + 1) * m, :, :],
                                   up_p[..., d * m:(d + 1) * m - 1, :, :], a_left, c_right,
                                   mesh, axis)
        return state, ns, ns_pad

    def apply_(fac, rhs):
        state, ns, ns_pad = fac
        m = ns_pad // dd
        if ns_pad > ns:
            rhs = torch.cat([rhs, rhs.new_zeros((*rhs.shape[:-3], ns_pad - ns,
                                                 *rhs.shape[-2:]))], -3)
        x_l = spike_apply_local(*state, rhs[..., d * m:(d + 1) * m, :, :], mesh, axis)
        return gather_shards(x_l, mesh, axis, dim=-3)[..., :ns, :, :]

    return factor, apply_


def make_sharded_fat_tridiag_solver(mesh, axis: str):
    """The one-shot form: solve(diag [..., Ns, B, B], upper [..., Ns-1, B,
    B], rhs [..., Ns, B, r]) -> x, one factor and one apply. The LM hook
    takes `make_sharded_fat_factor_apply`, which shares the factorisation
    between applies."""
    factor, apply_ = make_sharded_fat_factor_apply(mesh, axis)

    def solve(diag, upper, rhs):
        return apply_(factor(diag, upper), rhs)

    return solve


def solve_general_graph_sharded(values0, edges_from, edges_to, measurements, information,
                                fixed_mask, mesh, axis: str, **kwargs):
    """`nlls/banded.py::solve_general_graph` (the same plan and LM; its
    keyword arguments) with the fat-block ladder SPIKE-partitioned over
    `axis` of `mesh` through the (factor, apply) hook. values0 on the
    mesh's device. Returns (values [n, dim], ChainSummary, BandedPlan), the
    same on every rank."""
    return solve_general_graph(values0, edges_from, edges_to, measurements, information,
                               fixed_mask, fat_solve=make_sharded_fat_factor_apply(mesh, axis),
                               **kwargs)
