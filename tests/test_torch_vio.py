"""The batch VIO path against the JAX package's: the EuRoC/KITTI loaders
(`data/`), the batch pipeline (`slam/vio.py`) and the headless EuRoC replay
(`demos/headless.py`), on tests/fixture_gen.py's synthetic EuRoC layout
(the reference's euroc_mini is absent): JAX on the CPU at x64, torch in
float64 on the CPU. The JAX pipeline runs once per process (~30 s, most of
this file's time); the windowed pipeline is in test_torch_vio_pp.py.

Tolerances:
- loaders: every array equal (the same numpy parsing; sensor.yaml read by
  the port's own reader of its subset of YAML);
- `run_vio_pipeline` at max_keyframes = 10 with point_init_noise = 0.05 and
  JAX's draws fed in: every state, pose and point within 1e-8 (~1e-13
  measured), each solver's costs at rtol 1e-9 with atol 1e-12 (the BA ends
  at ~3e-12, on its rounding floor), both runs converged;
- `headless_euroc_vio`: the keyframes and the dead-reckoned RMSE (no noise
  on that path) equal to JAX's at 1e-12; the fused RMSE, whose landmark
  noise comes from the port's generator, under the 0.05 gate of
  tests/test_datasets_vio.py:58 and not above the dead-reckoned.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_gen import make_euroc_fixture, make_kitti_fixture

from rust_robotics_tpu.core.lie import se3_exp as j_se3_exp
from rust_robotics_tpu.data.euroc import EurocDataset as JEuroc
from rust_robotics_tpu.data.euroc import quat_to_rot as j_quat_to_rot
from rust_robotics_tpu.data.kitti import KittiSequence as JKitti
from rust_robotics_tpu.slam import vio as jvio
from rust_robotics_tpu_torch.data.euroc import EurocDataset, _parse_sensor_yaml, quat_to_rot
from rust_robotics_tpu_torch.data.kitti import KittiSequence
from rust_robotics_tpu_torch.demos.headless import headless_euroc_vio
from rust_robotics_tpu_torch.slam import vio as tvio

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def euroc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_mini"))
    truth, landmarks, _ = make_euroc_fixture(root)
    return root, truth, landmarks


def _assert_same_fields(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


def test_euroc_loader_matches_jax(euroc):
    root, truth, landmarks = euroc
    got, want = EurocDataset.load(root), JEuroc.load(root)
    _assert_same_fields(got.imu, want.imu, ("t_bs", "timestamps", "gyro", "accel"))
    _assert_same_fields(got.cam, want.cam, ("t_bs", "intrinsics", "resolution", "timestamps",
                                            "filenames"))
    _assert_same_fields(got.ground_truth, want.ground_truth,
                        [f.name for f in dataclasses.fields(want.ground_truth)])
    _assert_same_fields(got.load_feature_tracks(), want.load_feature_tracks(),
                        ("landmarks", "obs_timestamps", "obs_landmark_ids", "obs_pixels"))
    for lo, hi in ((0, 10), (3, 4), (7, 7)):
        t0, t1 = int(truth["ts_ns"][lo]), int(truth["ts_ns"][hi])
        for g, w in zip(got.imu_between(t0, t1), want.imu_between(t0, t1)):
            np.testing.assert_array_equal(g, w)
    q = want.ground_truth.quaternions
    np.testing.assert_array_equal(quat_to_rot(q), j_quat_to_rot(q))


def test_sensor_yaml_reader_matches_pyyaml():
    yaml = pytest.importorskip("yaml")
    text = """sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
    assert _parse_sensor_yaml(text) == yaml.safe_load(text)


def test_kitti_loader_matches_jax(tmp_path):
    make_kitti_fixture(str(tmp_path))
    got, want = KittiSequence.load(str(tmp_path), "00"), JKitti.load(str(tmp_path), "00")
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.times, want.times)
    assert got.calib.keys() == want.calib.keys()
    for name in want.calib:
        np.testing.assert_array_equal(got.calib[name], want.calib[name])
    np.testing.assert_array_equal(got.relative_pose(2, 5), want.relative_pose(2, 5))


@functools.lru_cache(maxsize=None)
def _jax_batch(root):
    ds = JEuroc.load(root)
    tracks = ds.load_feature_tracks()
    res = jvio.run_vio_pipeline(ds, tracks, max_keyframes=10, point_init_noise=0.05)
    draws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), tracks.landmarks.shape,
                                         jnp.float64))
    return res, draws


def test_run_vio_pipeline_matches_jax(euroc):
    root, _, _ = euroc
    want, draws = _jax_batch(root)
    ds = EurocDataset.load(root)
    got = tvio.run_vio_pipeline(ds, ds.load_feature_tracks(), max_keyframes=10,
                                point_init_noise=0.05, draws=draws, device=CPU, dtype=F64)
    for name in ("nav_states", "biases", "fused_poses", "ba_cameras", "ba_points",
                 "dead_reckoned"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    for stage in ("ba", "imu", "fusion"):
        g, w = got.summaries[stage], want.summaries[stage]
        for name in ("initial_cost", "final_cost"):
            np.testing.assert_allclose(getattr(g, name), getattr(w, name), rtol=1e-9,
                                       atol=1e-12, err_msg=f"{stage} {name}")
        assert g.termination != "max_iterations" and w.termination != "max_iterations"
    assert set(got.summaries["seconds"]) == {"preintegrate", "bundle_adjust", "imu_refine",
                                             "fusion"}


def test_headless_euroc_vio_matches_jax(euroc):
    root, truth, _ = euroc
    want_res, _ = _jax_batch(root)  # the JAX demo's run: the same fixture and settings
    k = np.asarray(want_res.fused_poses).shape[0]
    gt_pos = truth["pos"][truth["cam_idx"][:k]]
    want_dead = jvio.pose_error(np.asarray(jvio.nav_to_se3(want_res.dead_reckoned)), gt_pos)
    got = headless_euroc_vio(tmpdir=root + "_headless", device=CPU, dtype=F64)
    assert got["keyframes"] == k == 10
    np.testing.assert_allclose(got["dead_reckoned_rmse"], want_dead, rtol=0, atol=1e-12)
    assert got["fused_position_rmse"] < 0.05 and got["fusion_improves"]


def test_pose_error_se3_matches_jax():
    rng = np.random.default_rng(0)
    a = np.asarray(j_se3_exp(jnp.asarray(0.3 * rng.normal(size=(2, 4, 6)))))
    np.testing.assert_allclose(tvio.pose_error_se3(a[0], a[1]),
                               jvio.pose_error_se3(a[0], a[1]), rtol=0, atol=1e-12)
