"""The benchmark's own copy of the reference's pose-graph problem (NumPy only).

Frozen from the port's `demos/pose_graph_bench.py` (`relative`,
`synthesize_chain`, `rmse`, and `batched_problem`'s wobble), which copies
the reference crate's benchmark problem
(crates/rust_robotics/examples/benchmark_large_pose_graph.rs:11-97): a
sinusoidal ground-truth SE(2) chain, a deterministic perturbation of the
initial guess, odometry edges with information 100·I and a loop closure
every 100 poses with information 20·I, all measurements exact. The
optimum of every such graph is its ground truth, with zero cost.

The benchmark holds the problem here so that a change to the program can
never change what is measured; `test_harness_reference.py` holds this copy
equal to the port's.
"""

from __future__ import annotations

import numpy as np


def relative(a, b):
    """benchmark_large_pose_graph.rs:11-16, the pose of b in a's frame
    (yaw left unwrapped, as in the reference), over leading axes."""
    a = np.asarray(a)
    b = np.asarray(b)
    s, c = np.sin(a[..., 2]), np.cos(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy, b[..., 2] - a[..., 2]], axis=-1)


def synthesize_chain(size: int, loop_stride: int = 100, odometry_information: float = 100.0,
                     loop_information: float = 20.0):
    """benchmark_large_pose_graph.rs:19-56. Returns (truth [N, 3], initial
    [N, 3], edges_from [E], edges_to [E], measurements [E, 3], information
    [E, 3, 3]): the N − 1 odometry edges first, then a closure i → i +
    loop_stride for every i = 0, loop_stride, ... below N − loop_stride."""
    i = np.arange(size, dtype=np.float64)
    x = i * 0.05
    truth = np.stack([x, 2.0 * np.sin(x * 0.015), 0.03 * np.cos(x * 0.015)], axis=-1)
    initial = truth + np.stack([0.02 * np.sin(i * 0.013), 0.03 * np.cos(i * 0.021),
                                0.005 * np.sin(i * 0.017)], axis=-1)
    initial[0] = truth[0]
    ef_c = np.arange(size - 1, dtype=np.int32)
    et_c = ef_c + 1
    meas_c = relative(truth[:-1], truth[1:])
    ef_l = np.arange(0, max(size - loop_stride, 0), loop_stride, dtype=np.int32)
    et_l = ef_l + loop_stride
    meas_l = relative(truth[ef_l], truth[et_l])
    info = np.concatenate([
        np.broadcast_to(np.eye(3) * odometry_information, (len(ef_c), 3, 3)),
        np.broadcast_to(np.eye(3) * loop_information, (len(ef_l), 3, 3)),
    ]).copy()
    return (truth, initial, np.concatenate([ef_c, ef_l]), np.concatenate([et_c, et_l]),
            np.concatenate([meas_c, meas_l]), info)


class Wobbles:
    """`batched_problem`'s per-graph wobble of the initial guess,
    amplitude · sin(frequency · k + φ) over the flattened [N, 3] poses, times
    `scale` per component, for many phases φ at once: by sin(a + φ) = sin a ·
    cos φ + cos a · sin φ over the precomputed sin a and cos a, in `dtype`
    (a few ms for 1024 graphs of 200 poses)."""

    def __init__(self, size: int, amplitude: float = 0.01, frequency: float = 0.01,
                 scale=(1.0, 1.0, 0.1), dtype=np.float64):
        k = np.arange(size * 3, dtype=np.float64) * frequency
        s = np.asarray(scale, dtype=np.float64)
        self.sin = ((amplitude * np.sin(k)).reshape(size, 3) * s).astype(dtype)
        self.cos = ((amplitude * np.cos(k)).reshape(size, 3) * s).astype(dtype)

    def __call__(self, phase, base=None):
        """base (default 0) plus the wobbles of phase [G]: [G, N, 3]."""
        phase = np.asarray(phase, dtype=np.float64)[:, None, None]
        out = self.sin * np.cos(phase).astype(self.sin.dtype)
        out += self.cos * np.sin(phase).astype(self.sin.dtype)
        if base is not None:
            out += base
        return out


def stratified_phases(seed: int, first: int, count: int, strata: int):
    """Phases in [0, 2π) of items first .. first + count − 1. Items fall in
    blocks of `strata` consecutive ones; block b holds one phase in each of
    the `strata` equal parts of the circle, at a random offset and in a
    random order, both drawn from the seed and b. Every block thus holds the
    same spread of phases, in another order."""
    out = np.empty(count)
    for b in range(first // strata, (first + count - 1) // strata + 1):
        rng = np.random.default_rng([seed, 1, b])
        block = (rng.permutation(strata) + rng.uniform()) * (2.0 * np.pi / strata)
        lo, hi = max(first, b * strata), min(first + count, (b + 1) * strata)
        out[lo - first:hi - first] = block[lo - b * strata:hi - b * strata]
    return out


def rmse(poses, truth):
    """benchmark_large_pose_graph.rs:77-89: sqrt of the mean over poses of
    the summed squared (x, y, yaw) errors; over leading axes."""
    d = np.asarray(poses, dtype=np.float64) - np.asarray(truth, dtype=np.float64)
    return np.sqrt(np.mean(np.sum(d * d, axis=-1), axis=-1))
