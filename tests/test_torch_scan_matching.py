"""Scan matching, the SLAM node and g2o I/O (`slam/scan_matching.py`,
`slam/slam_node.py`, `slam/g2o.py`) against the JAX package's, on numpy
inputs made from a seed: JAX on the CPU at x64, torch in float64 on the
CPU.

Tolerances: the ICPs take the same neighbours and the same closed-form
steps, so their poses are held at 1e-12 (0 measured) and their mean
distances at 1e-10 (the final distances of noisy clouds, ~1e-2, through
the rounding of |c|² + |p|² − 2c·p). The correlative search's scores at
1e-10 (sums of ~100 likelihoods of O(1)), its best pose exactly.
`graph_slam_from_landmarks` ends an LM run at the rounding floor, where
the number of steps may differ (ROADMAP C, "LM at the rounding floor"):
its poses are held at 1e-8 (3e-10 measured) and its final cost at rtol
1e-9. The SLAM node's decisions and reasons are held exactly, its poses
at 1e-12; its ICP error at 1e-7, because consecutive scans of the exact
wall points align to ~1e-8 and the error is the rounding noise of that
alignment.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.slam import g2o as jg
from rust_robotics_tpu.slam import scan_matching as js
from rust_robotics_tpu.slam import slam_node as jn
from rust_robotics_tpu_torch.slam import g2o as tg
from rust_robotics_tpu_torch.slam import scan_matching as ts
from rust_robotics_tpu_torch.slam import slam_node as tn

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def make_scan(seed, n=200):
    """Two noisy walls meeting at the origin (tests/test_scan_matching_g2o.py)."""
    t = np.linspace(0.0, 6.0, n // 2)
    pts = np.concatenate([np.stack([t, 0 * t], -1), np.stack([0 * t, t], -1)])
    return pts + 0.01 * np.random.default_rng(seed).normal(size=pts.shape)


def moved(pts, pose):
    """The current scan that `pose` maps onto `pts`: pts under pose⁻¹."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    return (pts - pose[:2]) @ np.array([[c, s], [-s, c]]).T


@functools.lru_cache(maxsize=None)
def pair(seed, pose, outliers=False):
    prev = make_scan(seed)
    cur = moved(prev, np.array(pose)) + 0.005 * np.random.default_rng(seed + 50).normal(
        size=prev.shape)
    if outliers:
        cur[::25] += 5.0
    return prev, cur


def test_robust_icp_matches_jax():
    prev, cur = pair(0, (0.3, -0.2, 0.1), outliers=True)
    want = jax.jit(lambda a, b: js.robust_icp(a, b, huber_delta=0.3))(jnp.asarray(prev),
                                                                       jnp.asarray(cur))
    got = ts.robust_icp(t64(prev), t64(cur), huber_delta=0.3)
    close(got[0], want[0])
    close(got[1], want[1], 1e-10)
    close(got[0], [0.3, -0.2, 0.1], 0.03)


jax_p2l = jax.jit(jax.vmap(js.point_to_line_icp))


def test_point_to_line_icp_batch_matches_vmap_and_solo():
    pairs = [pair(s, (0.05 * s, 0.1, 0.02 * s)) for s in range(1, 4)]
    prev, cur = (np.stack(x) for x in zip(*pairs))
    want = jax_p2l(jnp.asarray(prev), jnp.asarray(cur))
    got = ts.point_to_line_icp(t64(prev), t64(cur))
    close(got[0], want[0])
    close(got[1], want[1], 1e-10)
    for k in range(3):
        solo = ts.point_to_line_icp(t64(prev[k]), t64(cur[k]))
        assert torch.equal(solo[0], got[0][k]) and torch.equal(solo[1], got[1][k])


def test_two_nearest_on_ties_is_top_k():
    dd = np.array([[3.0, 1.0, 2.0, 1.0, 0.5, 0.5], [1.0, 1.0, 1.0, 1.0, 2.0, 2.0],
                   [2.0, 0.0, 2.0, 2.0, 5.0, 2.0]])
    _, want = jax.lax.top_k(-jnp.asarray(dd), 2)
    got = torch.stack(ts._two_nearest(t64(dd)), -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_correlative_scan_match_matches_jax():
    from rust_robotics_tpu.mapping.gaussian_map import gaussian_grid_map

    pts = make_scan(2, 100)
    lik, min_x, min_y = gaussian_grid_map(jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), 0.2,
                                          0.3, extend=3.0)
    scan = moved(pts, np.array([0.4, -0.3, 0.12]))
    kw = dict(search_xy=0.8, search_theta=0.3, n_xy=17, n_theta=13)
    # two starts in one batch, held to jax.vmap (one compile)
    init = np.array([[0.0, 0.0, 0.0], [0.2, -0.1, 0.05]])
    want = jax.jit(jax.vmap(lambda p0: js.correlative_scan_match(
        jnp.asarray(scan), lik, float(min_x), float(min_y), 0.2, init_pose=p0, **kw)))(
        jnp.asarray(init))
    got = ts.correlative_scan_match(t64(np.stack([scan, scan])), t64(lik), float(min_x),
                                    float(min_y), 0.2, init_pose=t64(init), **kw)
    close(got[0], want[0])
    close(got[1], want[1], 1e-10)
    close(got[2], want[2], 1e-10)
    close(got[0][0], [0.4, -0.3, 0.12], 0.12)
    solo = ts.correlative_scan_match(t64(scan), t64(lik), float(min_x), float(min_y), 0.2, **kw)
    close(solo[0], want[0][0])


def test_graph_slam_from_landmarks_matches_jax():
    rng = np.random.default_rng(0)
    n = 15
    truth = np.stack([np.linspace(0, 7, n), 0.5 * np.sin(np.linspace(0, 3, n)), 0.2 * np.ones(n)],
                     -1)
    lms = np.array([[3.0, 4.0], [6.0, -2.0], [1.0, -3.0]])
    obs = np.zeros((n, 3, 2))
    mask = rng.uniform(size=(n, 3)) < 0.8
    for i in range(n):
        d = lms - truth[i, :2]
        obs[i, :, 0] = np.linalg.norm(d, axis=-1)
        obs[i, :, 1] = np.arctan2(d[:, 1], d[:, 0]) - truth[i, 2]
    noisy = truth.copy()
    noisy[1:, :2] += 0.2 * rng.standard_normal((n - 1, 2))
    want, want_summary = js.graph_slam_from_landmarks(jnp.asarray(noisy), jnp.asarray(obs),
                                                      jnp.asarray(mask))
    got, summary = ts.graph_slam_from_landmarks(noisy, obs, mask, device="cpu",
                                                dtype=torch.float64)
    close(got, want, 1e-8)
    np.testing.assert_allclose(summary.final_cost, want_summary.final_cost, rtol=1e-9)
    assert np.abs(got.numpy()[:, :2] - truth[:, :2]).mean() < np.abs(noisy[:, :2]
                                                                      - truth[:, :2]).mean()


def test_point_to_plane_icp_matches_jax():
    rng = np.random.default_rng(5)
    prev = rng.normal(size=(150, 3))
    normals = rng.normal(size=(150, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    cur = prev + np.array([0.05, -0.03, 0.02]) + 0.01 * rng.normal(size=(150, 3))
    want = jax.jit(lambda a, b, c: js.point_to_plane_icp(a, b, c, iterations=8))(
        jnp.asarray(prev), jnp.asarray(normals), jnp.asarray(cur))
    got = ts.point_to_plane_icp(t64(prev), t64(normals), t64(cur), iterations=8)
    close(got[0], want[0])
    close(got[1], want[1], 1e-10)


DECISION_CASES = {  # tests/test_slam_node.py's cases: odom, icp, converged, iterations, error
    "accepted": ([0.1, 0.0, 0.0], [0.11, 0.0, 0.01], True, 4, 0.005),
    "high_error": ([0.1, 0.0, 0.0], [0.11, 0.0, 0.01], True, 4, 10.0),
    "not_converged": ([0.1, 0.0, 0.0], [0.11, 0.0, 0.0], False, 4, 0.005),
    "invalid_error": ([0.1, 0.0, 0.0], [0.11, 0.0, 0.0], True, 4, float("nan")),
    "low_motion": ([0.02, 0.0, 0.02], [0.03, 0.0, 0.03], True, 4, 0.005),
    "outlier": ([0.1, 0.0, 0.0], [0.4, 0.0, 0.0], True, 4, 0.005),
    "zero_motion": ([0.0, 0.0, 0.0], [0.02, 0.0, 0.0], True, 4, 0.005),
    "slow": ([0.1, 0.0, 0.0], [0.11, 0.0, 0.0], True, 50, 0.005),
    "attenuated": ([0.1, 0.02, 0.05], [0.16, 0.0, 0.12], True, 20, 0.009),
    "yaw_outlier": ([0.1, 0.0, 0.1], [0.1, 0.0, 0.6], True, 4, 0.005),
}


def test_blend_decisions_match_jax_batched():
    odom, icp, conv, iters, err = (np.array(x) for x in zip(*DECISION_CASES.values()))
    want = jax.vmap(jn.compute_icp_blend_decision)(*map(jnp.asarray, (odom, icp, conv, iters,
                                                                       err)))
    got = tn.compute_icp_blend_decision(t64(odom), t64(icp), torch.tensor(conv),
                                        torch.tensor(iters), t64(err))
    for key in ("alpha_xy", "alpha_yaw"):
        close(got[key], want[key])
    for key in ("reason_xy", "reason_yaw"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    reasons = {tn.REASONS[int(r)] for r in got["reason_xy"]} | {tn.REASONS[int(r)]
                                                                for r in got["reason_yaw"]}
    assert len(reasons) >= 8, reasons
    blended = tn.blend_motion_delta(t64(odom), t64(icp), got["alpha_xy"], got["alpha_yaw"])
    close(blended, jax.vmap(jn.blend_motion_delta)(jnp.asarray(odom), jnp.asarray(icp),
                                                   want["alpha_xy"], want["alpha_yaw"]))
    values = t64([0.005, 0.009, 0.02])
    close(tn.ramp_weight(values, 0.007, 0.011), jn.ramp_weight(jnp.asarray(values), 0.007, 0.011))
    close(tn.ramp_up_weight(values, 0.0125, 0.05),
          jn.ramp_up_weight(jnp.asarray(values), 0.0125, 0.05))


def test_scan_points_stride_and_submap_match_jax():
    ranges = np.array([1.0, np.inf, 0.01, 5.0, np.nan, 2.0, 12.0, 3.0])
    for g, w in zip(tn.scan_to_points(t64(ranges), 0.0, 0.5, 0.05, 10.0),
                    jn.scan_to_points(jnp.asarray(ranges), 0.0, 0.5, 0.05, 10.0)):
        close(g, w)
    valid = np.array([[True] * 10, [True, True, True] + [False] * 7, [True, False] * 5])
    for stride in (1, 3, 4):
        got = tn.subsample_stride(None, torch.tensor(valid), stride)
        want = jax.vmap(lambda v: jn.subsample_stride(None, v, stride))(jnp.asarray(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(6)
    sub = rng.normal(scale=4.0, size=(16, 2))
    sub_valid = rng.uniform(size=16) < 0.6
    new = rng.normal(scale=4.0, size=(10, 2))
    anchor = np.array([0.5, -0.5, 0.1])
    for radius, budget in ((5.0, 12), (1e9, 6), (2.0, 16)):
        want = jn.append_and_prune(jnp.asarray(sub), jnp.asarray(sub_valid), jnp.asarray(new),
                                   jnp.ones(10, bool), jnp.asarray(anchor), radius, budget)
        got = tn.append_and_prune(t64(sub), torch.tensor(sub_valid), t64(new),
                                  torch.ones(10, dtype=torch.bool), t64(anchor), radius, budget)
        close(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_slam_node_loop_matches_jax():
    want = jn.run_slam_node_loop(steps=3)
    got = tn.run_slam_node_loop(steps=3, device="cpu")
    gd, wd = got["diagnostics"], want["diagnostics"]
    for name in ("reason_xy", "reason_yaw", "icp_iterations", "submap_points"):
        np.testing.assert_array_equal(getattr(gd, name).numpy(), np.asarray(getattr(wd, name)))
    for name in ("alpha_xy", "alpha_yaw", "pose_error", "odom_error"):
        close(getattr(gd, name), getattr(wd, name))
    close(gd.icp_error, wd.icp_error, 1e-7)
    for key in ("truth", "raw_odom", "corrected"):
        close(got[key], want[key])
    close(got["submap"][0], want["submap"][0])
    np.testing.assert_array_equal(got["submap"][1].numpy(), np.asarray(want["submap"][1]))


G2O_TEXT = """VERTEX_SE2 0 0 0 0
VERTEX_SE2 3 1 0.5 0.2
VERTEX_SE2 1 2.5 -0.25 1.5
EDGE_SE2 0 3 1 0.5 0.2 100 0 0 100 0 25
EDGE_SE2 3 1 1.5 -0.75 1.3 50 1 2 40 3 10

VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1
VERTEX_SE3:QUAT 1 1 2 3 0 0 0.3826834 0.9238795
EDGE_SE3:QUAT 0 1 1 2 3 0 0 0 1 100 0 0 0 0 0 100 0 0 0 0 100 0 0 0 25 0 0 25 0 25
"""


def _same_graph(got, want):
    assert sorted(got.vertices_se2) == sorted(want.vertices_se2)
    for k in want.vertices_se2:
        np.testing.assert_array_equal(got.vertices_se2[k], want.vertices_se2[k])
    for k in want.vertices_se3:
        for g, w in zip(got.vertices_se3[k], want.vertices_se3[k]):
            np.testing.assert_array_equal(g, w)
    for edges in ("edges_se2", "edges_se3"):
        assert len(getattr(got, edges)) == len(getattr(want, edges))
        for ge, we in zip(getattr(got, edges), getattr(want, edges)):
            assert ge[:2] == we[:2]
            for g, w in zip(ge[2:], we[2:]):
                np.testing.assert_array_equal(g, w)


def test_g2o_parse_write_round_trip_as_the_jax_parser():
    want = jg._parse_g2o_py(G2O_TEXT)
    got = tg.parse_g2o(G2O_TEXT)
    _same_graph(got, want)
    text = tg.write_g2o(got)
    assert text == jg.write_g2o(want)
    _same_graph(tg.parse_g2o(text), got)
    for g, w in zip(tg.se2_arrays(got), jg.se2_arrays(want)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="line 2"):
        tg.parse_g2o("VERTEX_SE2 0 0 0 0\nEDGE_SE2 0 1 x\n")
