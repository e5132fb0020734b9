"""KITTI odometry loader.

The port's own copy of rust_robotics_tpu/data/kitti.py (reference:
slam/src/dataset.rs KITTI loader (:231-256): poses/NN.txt (3×4 row-major
world-from-camera per line), sequences/NN/times.txt, sequences/NN/calib.txt
(P0..P3, Tr)). Host-side numpy; it returns the same arrays.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class KittiSequence:
    poses: np.ndarray  # [N, 4, 4]
    times: np.ndarray  # [N]
    calib: dict  # name -> [3, 4]

    @staticmethod
    def load(root, sequence: str = "00") -> "KittiSequence":
        root = str(root)
        rows = np.loadtxt(os.path.join(root, "poses", f"{sequence}.txt"), ndmin=2)
        n = rows.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, :] = rows.reshape(n, 3, 4)

        seq_dir = os.path.join(root, "sequences", sequence)
        times = np.loadtxt(os.path.join(seq_dir, "times.txt"), ndmin=1)
        calib = {}
        calib_file = os.path.join(seq_dir, "calib.txt")
        if os.path.exists(calib_file):
            with open(calib_file) as f:
                for ln in f:
                    if ":" not in ln:
                        continue
                    name, vals = ln.split(":", 1)
                    calib[name.strip()] = np.asarray(vals.split(), np.float64).reshape(3, 4)
        if len(times) != n:
            raise ValueError("times.txt length must match pose count")
        return KittiSequence(poses, times, calib)

    def relative_pose(self, i, j):
        return np.linalg.inv(self.poses[i]) @ self.poses[j]
