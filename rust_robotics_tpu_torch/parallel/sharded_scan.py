"""Sequence-parallel scan matching with a ring halo exchange (SP/CP).

The port of rust_robotics_tpu/parallel/sharded_scan.py. The time axis of
a long scan sequence is split over a mesh axis:

- each rank holds a contiguous chunk of C scans and matches its C
  consecutive pairs in one lock-step batch (`slam/scan_matching.py`'s
  robust ICP, whose arithmetic is batch-invariant, so a pair gives the
  same pose in any batch);
- the pair that straddles a chunk boundary needs the first scan of the
  next rank: a ring shift (i → i − 1) sends each rank's first scan to its
  left neighbour, the halo. The last rank's halo wraps around to scan 0,
  and its pair is dropped, as JAX drops it;
- the relative poses are all-gathered and composed into the absolute
  trajectory by an associative scan over the SE(2) group product
  (`filters/smoother.py::associative_scan`, JAX's order).

The sharded run equals `scan_odometry_serial` bitwise on any layout.
"""

from __future__ import annotations

import torch

from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.filters.smoother import associative_scan
from rust_robotics_tpu_torch.parallel.mesh import axis_size, gather_shards, local_shard, ppermute
from rust_robotics_tpu_torch.slam.scan_matching import robust_icp


def se2_compose(a, b):
    """Group product of SE(2) poses [..., 3] (x, y, yaw): a ∘ b."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + c * b[..., 0] - s * b[..., 1]
    y = a[..., 1] + s * b[..., 0] + c * b[..., 1]
    yaw = normalize_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, yaw], dim=-1)


def compose_trajectory(rel_poses):
    """Absolute poses [T, 3] from relative scan-to-scan poses [T, 3]:
    absolute[t] = rel[0] ∘ ... ∘ rel[t] (the pose of scan t + 1 in the frame
    of scan 0), by a parallel prefix over the group product."""
    return associative_scan(lambda a, b: (se2_compose(a[0], b[0]),), (rel_poses,))[0]


def _pair_icp(prev_scans, cur_scans, iterations):
    """The pose of each cur scan in its prev scan's frame, [..., 3], from
    a zero initial pose."""
    init = torch.zeros(3, dtype=cur_scans.dtype, device=cur_scans.device)
    pose, _ = robust_icp(prev_scans, cur_scans, init_pose=init, iterations=iterations)
    return pose


def scan_odometry_serial(scans, iterations: int = 20):
    """The unsharded oracle: all T − 1 consecutive pairs in one batch, then
    composed. scans [T, M, 2] -> (rel [T − 1, 3], absolute [T − 1, 3])."""
    rel = _pair_icp(scans[:-1], scans[1:], iterations)
    return rel, compose_trajectory(rel)


def make_sharded_scan_odometry(mesh, axis: str = "data", iterations: int = 20):
    """run(scans_local [C, M, 2]) -> (rel [T − 1, 3], absolute [T − 1, 3]),
    the same on every rank of `axis`, where this rank holds scans
    [i·C, (i + 1)·C) of T = C·S (`shard_scans`). Collectives: one ring
    shift of one scan, one all-gather of C poses."""
    n = axis_size(mesh, axis)
    perm = [(i, (i - 1) % n) for i in range(n)]  # send left = receive from the right

    def run(scans_local):
        halo = ppermute(scans_local[:1], mesh, axis, perm)
        ext = torch.cat([scans_local, halo], dim=0)  # [C + 1, M, 2]
        rel_local = _pair_icp(ext[:-1], ext[1:], iterations)  # [C, 3]
        rel = gather_shards(rel_local, mesh, axis)[:-1]  # the wrapped pair dropped
        return rel, compose_trajectory(rel)

    return run


def shard_scans(mesh, scans, axis: str = "data"):
    """This rank's chunk of a [T, M, 2] scan stack, time-sharded."""
    return local_shard(scans, mesh, axis)
