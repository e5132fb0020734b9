"""The slice end to end: the port's 330-step EKF localization demo against
the JAX demo and against the numpy golden of tests/test_kalman.py, both in
float64 at 1e-9 (the golden's own tolerance); batched-against-single
consistency; the other Gaussian filters in the same loop; and the
`convert` round trips that carry the JAX package's arrays across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import ekf_localization as j_demo
from rust_robotics_tpu.ops import ekf_pallas
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.demos.ekf_localization import (
    default_ekf_noise,
    deterministic_noise,
    run_ekf_localization_demo,
)
from rust_robotics_tpu_torch.filters import kalman as tk
from rust_robotics_tpu_torch.ops.ekf_scan import ekf_scan_reference
from test_kalman import numpy_ekf_reference

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = dict(device="cpu", dtype=torch.float64)


def test_demo_matches_jax_demo_and_numpy_golden():
    trace = run_ekf_localization_demo(steps=330, **F64)
    want = j_demo.run_ekf_localization_demo(steps=330)
    assert trace["estimate"].shape == (330, 4) and trace["cov"].shape == (330, 4, 4)
    for key in ("truth", "estimate", "measurement", "cov", "final_mean", "final_cov"):
        np.testing.assert_allclose(trace[key].numpy(), np.asarray(want[key]), atol=1e-9, rtol=0)
    np.testing.assert_allclose(trace["estimate"].numpy(), numpy_ekf_reference(330), atol=1e-9, rtol=0)


def test_demo_batched_consistent_with_single():
    single = run_ekf_localization_demo(steps=50, noise_phase_offset=0.0, **F64)
    batched = run_ekf_localization_demo(steps=50, noise_phase_offset=[0.0, 0.5, 1.0], **F64)
    assert batched["estimate"].shape == (3, 50, 4)
    np.testing.assert_allclose(batched["estimate"][0], single["estimate"], atol=1e-12, rtol=0)
    other = run_ekf_localization_demo(steps=50, noise_phase_offset=0.5, **F64)
    np.testing.assert_allclose(batched["estimate"][1], other["estimate"], atol=1e-12, rtol=0)
    want = j_demo.run_ekf_localization_demo(steps=50, noise_phase_offset=jnp.array([0.0, 0.5, 1.0]))
    np.testing.assert_allclose(batched["cov"], np.asarray(want["cov"]), atol=1e-12, rtol=0)


@pytest.mark.parametrize("name", ["iekf_step", "ukf_step", "ckf_step"])
def test_other_filters_track_circle_like_ekf(name):
    """tests/test_kalman.py::test_all_gaussian_filters_track_circle for the port."""

    def rmse(step):
        trace = run_ekf_localization_demo(steps=330, filter_step=step, **F64)
        err = trace["estimate"][..., :2] - trace["truth"][..., :2]
        return float(torch.sqrt(torch.mean(err**2)))

    rmse_ekf, rmse_other = rmse(tk.ekf_step), rmse(getattr(tk, name))
    assert rmse_ekf < 0.5 and rmse_other < 0.5, (rmse_ekf, rmse_other)
    assert abs(rmse_other - rmse_ekf) < 0.05


def test_noise_helpers_match_jax():
    q, r = default_ekf_noise(**F64)
    jq, jr = j_demo.default_ekf_noise()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    k = np.arange(10.0)
    got = deterministic_noise(torch.tensor(k, dtype=torch.float64), 0.6, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_demo.deterministic_noise(jnp.asarray(k), 0.6, 2.0)),
                               atol=1e-15, rtol=0)
    assert deterministic_noise(3, 0.6, 2.0) == pytest.approx(float(j_demo.deterministic_noise(3, 0.6, 2.0)),
                                                             abs=1e-15)


def test_convert_round_trips():
    rng = np.random.default_rng(0)
    b = 6
    mean = rng.standard_normal((b, 4))
    a = rng.standard_normal((b, 4, 4))
    cov = a @ np.swapaxes(a, -1, -2)
    belief = convert.belief_from_numpy(mean, cov, **F64)
    assert isinstance(belief, GaussianBelief) and belief.cov.dtype == torch.float64
    np.testing.assert_array_equal(belief.mean.numpy(), mean)

    # lanes: the layout of ekf_pallas.ekf_scan_reference (ekf_pallas.py:157-170)
    lane_mean, lane_cov = convert.belief_to_lanes(belief)
    assert lane_mean.is_contiguous() and lane_cov.is_contiguous()
    np.testing.assert_array_equal(lane_mean.numpy(), mean.T)
    np.testing.assert_array_equal(lane_cov.numpy(), np.moveaxis(cov, 0, -1).reshape(16, b))
    back = convert.belief_from_lanes(lane_mean, lane_cov)
    np.testing.assert_array_equal(back.mean.numpy(), mean)
    np.testing.assert_array_equal(back.cov.numpy(), cov)

    # arrays as the JAX scan takes them cross unchanged, in the dtype asked for
    zs = rng.standard_normal((3, 2, b))
    (t_zs, t_mean, t_cov) = convert.lanes_from_numpy(zs, mean.T, lane_cov.numpy(),
                                                     device="cpu", dtype=torch.float32)
    assert t_zs.dtype == torch.float32 and t_cov.shape == (16, b)
    np.testing.assert_allclose(t_zs.numpy(), zs.astype(np.float32), atol=0, rtol=0)

    # noise: dense or diagonal in, dense out
    q_diag = np.array([0.01, 0.01, 3e-4, 0.01])
    q, r = convert.noise_from_numpy(q_diag, np.eye(2), **F64)
    np.testing.assert_array_equal(q.numpy(), np.diag(q_diag))
    np.testing.assert_array_equal(r.numpy(), np.eye(2))

    # a JAX scan's output belief comes back through the same conversion
    z = 10 + 0.3 * rng.standard_normal((4, 2, b))
    u = np.stack([np.ones((4, b)), np.full((4, b), 0.1)], axis=1)
    m0 = np.zeros((4, b))
    c0 = np.repeat(np.eye(4).reshape(16, 1), b, axis=1)
    jm, jp = ekf_pallas.ekf_scan_reference(*(jnp.asarray(x) for x in (z, u, m0, c0)), 0.1,
                                           tuple(q_diag), (1.0, 1.0))
    got = convert.belief_from_lanes(*convert.lanes_from_numpy(jm, jp, **F64))
    tm, tp = ekf_scan_reference(*convert.lanes_from_numpy(z, u, m0, c0, **F64), 0.1, q_diag, (1.0, 1.0))
    ref = convert.belief_from_lanes(tm, tp)
    np.testing.assert_allclose(got.mean.numpy(), ref.mean.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.cov.numpy(), ref.cov.numpy(), atol=1e-12, rtol=0)
