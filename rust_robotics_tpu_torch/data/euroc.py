"""EuRoC MAV dataset loader.

The port's own copy of rust_robotics_tpu/data/euroc.py (reference:
slam/src/dataset.rs — `EurocDataset::load` (:107): reads
mav0/{cam0,imu0}/data.csv + sensor.yaml (T_BS, pinhole intrinsics),
optional state_groundtruth_estimate0/data.csv, validates increasing
timestamps; `imu_between` interval slices (:146); feature-track sidecar
mav0/rust_robotics/{landmarks.csv, observations.csv} (:158-191). Layout
contract: docs/datasets.md:10-66).

Host-side numpy; it returns the JAX loader's arrays exactly. One
difference: sensor.yaml is read by `_parse_sensor_yaml`, a reader of the
subset of YAML that EuRoC's sensor files use (top-level keys, one level of
nested mapping, flow lists that may span lines, `#` comments), where the
JAX package calls PyYAML, which is not among the port's dependencies.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraSensor:
    t_bs: np.ndarray  # [4, 4] body-from-sensor
    intrinsics: Optional[np.ndarray]  # [fx, fy, cx, cy] or None
    resolution: Optional[tuple]
    timestamps: np.ndarray  # [F] ns
    filenames: list


@dataclasses.dataclass(frozen=True)
class ImuSensor:
    t_bs: np.ndarray
    timestamps: np.ndarray  # [N] ns
    gyro: np.ndarray  # [N, 3]
    accel: np.ndarray  # [N, 3]


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    timestamps: np.ndarray
    positions: np.ndarray  # [N, 3]
    quaternions: np.ndarray  # [N, 4] (w, x, y, z)
    velocities: np.ndarray  # [N, 3]
    gyro_bias: np.ndarray
    accel_bias: np.ndarray


@dataclasses.dataclass(frozen=True)
class FeatureTracks:
    landmarks: np.ndarray  # [L, 3]
    obs_timestamps: np.ndarray  # [O]
    obs_landmark_ids: np.ndarray  # [O]
    obs_pixels: np.ndarray  # [O, 2]


def _scalar(token):
    token = token.strip()
    for cast in (int, float):
        try:
            return cast(token)
        except ValueError:
            pass
    return token.strip("'\"")


def _parse_sensor_yaml(text):
    """The mapping of a EuRoC sensor.yaml: {key: number, string, list of
    numbers, or {key: ...}} for one level of nesting."""
    lines = [ln.split("#", 1)[0].rstrip() for ln in text.splitlines()]
    doc, nested = {}, None
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if ":" not in line:
            continue
        key, value = (s.strip() for s in line.split(":", 1))
        if value.startswith("["):
            while "]" not in value and i < len(lines):
                value += " " + lines[i].strip()
                i += 1
            value = [_scalar(v) for v in value.strip("[]").split(",") if v.strip()]
        elif value:
            value = _scalar(value)
        if line[0].isspace() and nested is not None:
            nested[key] = value
        elif value == "":
            nested = doc[key] = {}
        else:
            nested = None
            doc[key] = value
    return doc


def _read_sensor_yaml(path):
    if not os.path.exists(path):
        return np.eye(4), None, None
    with open(path) as f:
        doc = _parse_sensor_yaml(f.read())
    t_bs = np.eye(4)
    if "T_BS" in doc:
        t_bs = np.asarray(doc["T_BS"]["data"], dtype=np.float64).reshape(4, 4)
    intr = np.asarray(doc["intrinsics"], np.float64) if "intrinsics" in doc else None
    res = tuple(doc["resolution"]) if "resolution" in doc else None
    return t_bs, intr, res


def _check_increasing(ts, what):
    if len(ts) > 1 and not np.all(np.diff(ts) > 0):
        raise ValueError(f"{what} timestamps must be strictly increasing")


def _mav0(root):
    return root if os.path.basename(root) == "mav0" else os.path.join(root, "mav0")


@dataclasses.dataclass(frozen=True)
class EurocDataset:
    imu: ImuSensor
    cam: Optional[CameraSensor]
    ground_truth: Optional[GroundTruth]
    root: str

    @staticmethod
    def load(root) -> "EurocDataset":
        root = str(root)
        mav0 = _mav0(root)
        if not os.path.isdir(mav0):
            raise FileNotFoundError(f"no mav0 directory under {root}")

        imu_csv = np.loadtxt(os.path.join(mav0, "imu0", "data.csv"), delimiter=",",
                             skiprows=1, ndmin=2)
        _check_increasing(imu_csv[:, 0], "imu")
        imu_tbs, _, _ = _read_sensor_yaml(os.path.join(mav0, "imu0", "sensor.yaml"))
        imu = ImuSensor(t_bs=imu_tbs, timestamps=imu_csv[:, 0].astype(np.int64),
                        gyro=imu_csv[:, 1:4], accel=imu_csv[:, 4:7])

        cam = None
        cam_dir = os.path.join(mav0, "cam0")
        if os.path.isdir(cam_dir):
            rows = []
            with open(os.path.join(cam_dir, "data.csv")) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln or ln.startswith("#"):
                        continue
                    ts, name = ln.split(",")[:2]
                    rows.append((int(ts), name))
            ts = np.array([r[0] for r in rows], np.int64)
            _check_increasing(ts, "cam0")
            tbs, intr, res = _read_sensor_yaml(os.path.join(cam_dir, "sensor.yaml"))
            cam = CameraSensor(tbs, intr, res, ts, [r[1] for r in rows])

        gt = None
        gt_csv = os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")
        if os.path.exists(gt_csv):
            g = np.loadtxt(gt_csv, delimiter=",", skiprows=1, ndmin=2)
            gt = GroundTruth(
                timestamps=g[:, 0].astype(np.int64),
                positions=g[:, 1:4],
                quaternions=g[:, 4:8],
                velocities=g[:, 8:11] if g.shape[1] > 8 else np.zeros((len(g), 3)),
                gyro_bias=g[:, 11:14] if g.shape[1] > 11 else np.zeros((len(g), 3)),
                accel_bias=g[:, 14:17] if g.shape[1] > 14 else np.zeros((len(g), 3)),
            )
        return EurocDataset(imu, cam, gt, root)

    def imu_between(self, t0_ns, t1_ns):
        """Samples with t0 < t <= t1 (dataset.rs:146 interval contract);
        returns (accel [K,3], gyro [K,3], dt [K] seconds)."""
        ts = self.imu.timestamps
        sel = (ts > t0_ns) & (ts <= t1_ns)
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            return (np.zeros((0, 3)),) * 2 + (np.zeros((0,)),)
        prev = np.concatenate([[t0_ns], ts[idx[:-1]]])
        dts = (ts[idx] - prev) / 1e9
        return self.imu.accel[idx], self.imu.gyro[idx], dts

    def load_feature_tracks(self) -> Optional[FeatureTracks]:
        """Sidecar loader (dataset.rs:158-191)."""
        side = os.path.join(_mav0(self.root), "rust_robotics")
        lm_f = os.path.join(side, "landmarks.csv")
        ob_f = os.path.join(side, "observations.csv")
        if not (os.path.exists(lm_f) and os.path.exists(ob_f)):
            return None
        lm = np.loadtxt(lm_f, delimiter=",", skiprows=1, ndmin=2)
        ob = np.loadtxt(ob_f, delimiter=",", skiprows=1, ndmin=2)
        ids = lm[:, 0].astype(np.int64)
        if not np.array_equal(ids, np.arange(len(ids))):
            raise ValueError("landmark ids must be contiguous and zero-based")
        return FeatureTracks(
            landmarks=lm[:, 1:4],
            obs_timestamps=ob[:, 0].astype(np.int64),
            obs_landmark_ids=ob[:, 1].astype(np.int64),
            obs_pixels=ob[:, 2:4],
        )


def quat_to_rot(q):
    """(w, x, y, z) [..., 4] -> rotation [..., 3, 3] (numpy)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / np.clip(n, 1e-30, None)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.stack(
        [
            np.stack([1 - (yy + zz), xy - wz, xz + wy], -1),
            np.stack([xy + wz, 1 - (xx + zz), yz - wx], -1),
            np.stack([xz - wy, yz + wx, 1 - (xx + yy)], -1),
        ],
        -2,
    )
