"""Headless demos — the CI-runnable closed-loop sims of the reference's
examples layer (SURVEY.md §2.11).

The port, in part, of rust_robotics_tpu/demos/headless.py: the EuRoC VIO
replay (headless_euroc_vio.rs, §3.3: EuRoC-layout fixture →
preintegration → BA → IMU refinement → SE(3) fusion with pose-error
reporting). The file's other two demos, the DWA navigation loop and the
mission FSM, need DWA and the mission state machine, which the port does
not have yet.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import tempfile

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.data.euroc import EurocDataset, quat_to_rot
from rust_robotics_tpu_torch.data.fixtures import reference_fixture_root
from rust_robotics_tpu_torch.slam.vio import (
    nav_to_se3,
    pose_error,
    pose_error_se3,
    run_vio_pipeline,
)

__all__ = ["headless_euroc_vio"]


def headless_euroc_vio(tmpdir=None, device=None, dtype=torch.float32):
    """Fixture EuRoC replay through the full VIO pipeline
    (headless_euroc_vio.rs:22-58) on `device` (default cuda) in `dtype`.
    Prefers the reference's own checked-in euroc_mini fixture (with the
    example's landmark perturbation and 5e-2 terminal SE(3) acceptance
    gate); falls back to the synthetic generator, tests/fixture_gen.py
    loaded by path, when the reference checkout is absent. The landmark
    noise of the fallback comes from the pipeline's seeded generator."""
    device = resolve_device(device)
    ref_root = tmpdir is None and reference_fixture_root("euroc_mini")
    if ref_root:
        ds = EurocDataset.load(ref_root)
        tracks = ds.load_feature_tracks()
        tracks = dataclasses.replace(
            tracks, landmarks=tracks.landmarks + np.array([0.02, -0.01, 0.04]))
        res = run_vio_pipeline(ds, tracks, device=device, dtype=dtype)
        gt = ds.ground_truth
        wfb = np.eye(4)
        wfb[:3, :3] = quat_to_rot(gt.quaternions[-1])
        wfb[:3, 3] = gt.positions[-1]
        t_bs = np.asarray(ds.cam.t_bs)
        fused = res.fused_poses.double().cpu().numpy()
        terminal = float(pose_error_se3(fused[-1] @ t_bs, wfb @ t_bs))
        err_fused = pose_error(fused, gt.positions)
        err_dead = pose_error(nav_to_se3(res.dead_reckoned).double(), gt.positions)
        return {
            "source": "reference_fixture",
            "keyframes": int(fused.shape[0]),
            "imu_samples": int(ds.imu.timestamps.shape[0]),
            "feature_observations": int(tracks.obs_pixels.shape[0]),
            "terminal_se3_error": terminal,
            "acceptance": bool(terminal <= 5.0e-2),
            "fused_position_rmse": float(err_fused),
            "dead_reckoned_rmse": float(err_dead),
            "fusion_improves": bool(err_fused <= err_dead + 1e-9),
        }

    # the synthetic fixture generator lives beside the tests (the
    # reference checks its euroc_mini fixture into tests/fixtures)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "fixture_gen", os.path.join(here, "tests", "fixture_gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    root = tmpdir or tempfile.mkdtemp(prefix="euroc_mini_")
    truth, _, _ = mod.make_euroc_fixture(root)
    ds = EurocDataset.load(root)
    tracks = ds.load_feature_tracks()
    res = run_vio_pipeline(ds, tracks, max_keyframes=10, point_init_noise=0.05,
                           device=device, dtype=dtype)
    k = res.fused_poses.shape[0]
    gt_pos = truth["pos"][truth["cam_idx"][:k]]
    err_fused = pose_error(res.fused_poses.double(), gt_pos)
    err_dead = pose_error(nav_to_se3(res.dead_reckoned).double(), gt_pos)
    return {
        "keyframes": k,
        "fused_position_rmse": float(err_fused),
        "dead_reckoned_rmse": float(err_dead),
        "fusion_improves": bool(err_fused <= err_dead + 1e-9),
    }
