"""The curve primitives, Frenet, Reeds-Shepp and η³
(`planning/{curves,frenet,reeds_shepp,eta3}.py`) against the JAX
package's: JAX on the CPU at x64, torch in float64 on the CPU, on seeded
numpy inputs and the JAX tests' problems (tests/test_curves.py,
test_frenet_fields.py, test_round2_batch.py, test_coverage_eta3.py).

Tolerances: indices, words and counts exactly; float64 values at 1e-12
unless stated (JAX's jitted XLA and torch may round a transcendental or a
fused multiply-add an ulp apart); a float32 run of each within 1e-4 of
float64 where the function is used in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import curves as jc
from rust_robotics_tpu.planning import eta3 as je
from rust_robotics_tpu.planning import frenet as jf
from rust_robotics_tpu.planning import reeds_shepp as jrs
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.planning import curves as tc
from rust_robotics_tpu_torch.planning import eta3 as te
from rust_robotics_tpu_torch.planning import frenet as tf
from rust_robotics_tpu_torch.planning import reeds_shepp as trs

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64


def close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def test_cubic_spline_quintic_and_spline_course_match_jax():
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.5, 2.0, 7))
    y = rng.normal(0, 2, 7)
    q = np.linspace(t[0] - 0.5, t[-1] + 0.5, 41)
    js = jax.jit(jc.CubicSpline1D.fit)(jnp.asarray(t), jnp.asarray(y))
    ts = tc.CubicSpline1D.fit(t64(t), t64(y))
    for name in ("calc", "calc_d", "calc_dd"):
        close(getattr(ts, name)(t64(q)), jax.jit(getattr(js, name))(jnp.asarray(q)), 1e-11)
    # the JAX spline carried across by convert
    conv = convert.cubic_spline_from_numpy(*(np.asarray(v) for v in (js.t, js.a, js.b, js.c,
                                                                       js.d)), device="cpu")
    close(conv.calc(t64(q)), jax.jit(js.calc)(jnp.asarray(q)), 1e-11)

    x, yy = [0.0, 2.0, 4.0, 6.0, 8.0], [0.0, 1.5, 0.0, -1.5, 0.0]
    got = tc.calc_spline_course(x, yy, ds=0.1, dtype=F64, device="cpu")
    want = jax.jit(lambda a, b: jc.calc_spline_course(a, b, 0.1, got[0].shape[0]))(
        jnp.asarray(x), jnp.asarray(yy))
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        close(g, w, 1e-11)
    got32 = tc.calc_spline_course(x, yy, ds=0.1, dtype=torch.float32, device="cpu")
    for g, w in zip(got32, want):
        close(g, w, 1e-4)
    sp = jax.jit(jc.Spline2D.fit)(jnp.asarray(x), jnp.asarray(yy))
    conv = convert.spline2d_from_numpy(np.asarray(sp.s), *(np.asarray(v) for v in (
        sp.sx.t, sp.sx.a, sp.sx.b, sp.sx.c, sp.sx.d, sp.sy.t, sp.sy.a, sp.sy.b, sp.sy.c, sp.sy.d)),
        device="cpu")
    close(conv.calc_curvature(got[4]), want[3], 1e-11)

    jq = jax.jit(jc.QuinticPolynomial.boundary)(0.0, 1.0, 0.2, 5.0, -0.5, 0.1, 4.0)
    tq = tc.QuinticPolynomial.boundary(0.0, 1.0, 0.2, 5.0, -0.5, 0.1, 4.0, dtype=F64,
                                       device="cpu")
    close(tq.coeffs, jq.coeffs)
    close(convert.quintic_from_numpy(np.asarray(jq.coeffs), device="cpu").coeffs, jq.coeffs)
    tt = np.linspace(0, 4, 9)
    for name in ("calc_point", "calc_first_derivative", "calc_second_derivative",
                 "calc_third_derivative"):
        close(getattr(tq, name)(t64(tt)), jax.jit(getattr(jq, name))(jnp.asarray(tt)), 1e-11)


def test_bezier_catmull_rom_bspline_match_jax():
    path, cp = jax.jit(jc.bezier_path)(jnp.array([0.0, 0.0, 0.0]), jnp.array([6.0, 3.0, jnp.pi / 4]))
    tpath, tcp = tc.bezier_path((0.0, 0.0, 0.0), (6.0, 3.0, np.pi / 4), dtype=F64, device="cpu")
    close(tcp, cp)
    close(tpath, path)
    pts = np.array([[0.0, 0.0], [1.0, 2.0], [3.0, 3.0], [5.0, 0.0], [7.0, 1.0], [9.0, 2.0]])
    close(tc.catmull_rom_course(pts, 25, dtype=F64, device="cpu"),
          jax.jit(lambda p: jc.catmull_rom_course(p, 25))(jnp.asarray(pts)))
    close(tc.bspline_course(pts, 20, dtype=F64, device="cpu"),
          jax.jit(lambda p: jc.bspline_course(p, 20))(jnp.asarray(pts)))


def _pose_pairs(n, seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b = np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    return a, b


@jax.jit
def _jax_dubins(a, b, curvature):
    lens = jax.vmap(lambda p, q: jc.dubins_path_lengths(p, q, curvature))(a, b)
    return (lens,) + jax.vmap(lambda p, q: jc.dubins_shortest_path(p, q, curvature, 24))(a, b)


def jax_dubins(n, seed, curvature):
    a, b = _pose_pairs(n, seed)
    return tuple(np.asarray(v) for v in _jax_dubins(jnp.asarray(a), jnp.asarray(b), curvature))


@jax.jit
def _jax_reeds_shepp(a, b, curvature):
    def one(p, q):
        segs, steers, total = jrs.reeds_shepp_path(p, q, curvature)
        return segs, steers, total, jrs.sample_reeds_shepp(p, segs, steers, curvature, 24)

    return jax.vmap(one)(a, b)


def jax_reeds_shepp(n, seed, curvature):
    a, b = _pose_pairs(n, seed)
    return tuple(np.asarray(v) for v in _jax_reeds_shepp(jnp.asarray(a), jnp.asarray(b),
                                                         curvature))


_jax_dub1 = jax.jit(lambda p, q, c: jc.dubins_shortest_path(p, q, c, 100))
_jax_rs1 = jax.jit(jrs.reeds_shepp_path)
_jax_rss1 = jax.jit(lambda p, a, b, c: jrs.sample_reeds_shepp(p, a, b, c, 50))


def rs_ties(a, b, curvature):
    """The pairs whose two best verified Reeds-Shepp words are within
    1e-12 of each other (a tie in exact arithmetic)."""
    start, goal = t64(a), t64(b)
    dx, dy = goal[:, 0] - start[:, 0], goal[:, 1] - start[:, 1]
    c, s = torch.cos(start[:, 2]), torch.sin(start[:, 2])
    x, y = (c * dx + s * dy) * curvature, (-s * dx + c * dy) * curvature
    phi = trs._mod2pi(goal[:, 2] - start[:, 2])
    ok, lens, steers = trs._candidates(x, y, phi)
    ex, ey, eyaw = trs._endpoint_normalized(lens, steers)
    hit = ((ex - x[:, None]).abs() < 1e-6) & ((ey - y[:, None]).abs() < 1e-6) & (
        trs._mod2pi(eyaw - phi[:, None]).abs() < 1e-6)
    totals = torch.where(ok & hit, lens.abs().sum(-1), torch.inf).sort(-1).values
    return (totals[:, 1] - totals[:, 0] < 1e-12).numpy()


@pytest.mark.parametrize("curvature", [1.0, 0.8])
def test_dubins_and_reeds_shepp_batches_match_jax(curvature):
    """64 random pose pairs at once; words and steers exactly; the lengths
    and samples within 1e-11 (JAX's jitted vmap fuses multiply-adds); the
    tests' goals eagerly, one pair at a time."""
    a, b = _pose_pairs(64, 1)
    lens, pts, total, word = jax_dubins(64, 1, curvature)
    got = tc.dubins_path_lengths(t64(a), t64(b), curvature)
    fin = np.isfinite(lens)
    assert np.array_equal(np.isfinite(got.numpy()), fin)
    close(got.numpy()[fin], lens[fin], 1e-11)
    gpts, gtotal, gword = tc.dubins_shortest_path(t64(a), t64(b), curvature, num_points=24)
    assert np.array_equal(gword.numpy(), word)
    close(gtotal, total, 1e-11)
    close(gpts, pts, 1e-10)

    segs, steers, rtotal, rpts = jax_reeds_shepp(64, 1, curvature)
    gsegs, gsteers, gtot = trs.reeds_shepp_path(t64(a), t64(b), curvature)
    close(gtot, rtotal, 1e-11)
    # a CCC word and its timeflip may tie in exact arithmetic (12 of these 64
    # pairs): rounding picks one in each package; elsewhere the word is JAX's
    tied = rs_ties(a, b, curvature)
    assert (~tied).sum() >= 40
    assert np.array_equal(gsteers.numpy()[~tied], steers[~tied])
    close(gsegs.numpy()[~tied], segs[~tied], 1e-11)
    close(trs.sample_reeds_shepp(t64(a), gsegs, gsteers, curvature, 24).numpy()[~tied],
          rpts[~tied], 1e-10)

    start = np.zeros(3)
    jdub = lambda p, q: _jax_dub1(p, q, curvature)  # noqa: E731
    jrsp = lambda p, q: _jax_rs1(p, q, curvature)  # noqa: E731
    jrss = lambda p, a, b: _jax_rss1(p, a, b, curvature)  # noqa: E731
    for goal in ((4.0, 0.0, 0.0), (3.0, 3.0, np.pi / 2), (-2.0, 1.0, np.pi), (0.5, -0.5, -np.pi / 2),
                 (-0.5, 0.0, 0.0)):
        w = jdub(jnp.asarray(start), jnp.asarray(goal))
        g = tc.dubins_shortest_path(t64(start), t64(goal), curvature, 100)
        assert int(g[2]) == int(w[2])
        close(g[0], w[0], 1e-11)
        w = jrsp(jnp.asarray(start), jnp.asarray(goal))
        g = trs.reeds_shepp_path(t64(start), t64(goal), curvature)
        close(g[0], w[0])
        close(g[2], w[2])
        close(trs.sample_reeds_shepp(t64(start), g[0], g[1], curvature, 50),
              jrss(jnp.asarray(start), w[0], w[1]), 1e-11)


def test_dubins_float32_within_float32_rounding():
    a, b = _pose_pairs(64, 1)
    _, pts, total, word = jax_dubins(64, 1, 1.0)
    g = tc.dubins_shortest_path(torch.tensor(a, dtype=torch.float32),
                                torch.tensor(b, dtype=torch.float32), 1.0, num_points=24)
    same = g[2].numpy() == word
    assert same.mean() > 0.95  # a near-tie of two words may flip in float32
    close(g[1].numpy()[same], total[same], 1e-4)


class TestFrenet:
    wx = [0.0, 10.0, 20.5, 35.0, 70.5]
    wy = [0.0, -6.0, 5.0, 6.5, 0.0]
    obstacles = np.array([[20.0, 10.0], [30.0, 6.0], [30.0, 8.0], [35.0, 8.0], [50.0, 3.0]])

    @functools.cached_property
    def jax_cycle(self):
        return jax.jit(lambda wx, wy, obs: jf.frenet_optimal_plan(
            jc.Spline2D.fit(wx, wy), 0.0, 10.0 / 3.6, 2.0, 0.0, 0.0, obs))(
            jnp.asarray(self.wx), jnp.asarray(self.wy), jnp.asarray(self.obstacles))

    def test_candidate_axes_are_jnp_arange(self):
        cfg = tf.FrenetConfig()
        for args in ((-cfg.max_road_width, cfg.max_road_width + 1e-9, cfg.d_road_w),
                     (cfg.min_t, cfg.max_t + 1e-9, cfg.dt), (0.0, 1.0, 0.1), (4.0, 5.0, 0.2)):
            for dt, jdt in ((F64, jnp.float64), (torch.float32, jnp.float32)):
                want = np.asarray(jnp.arange(*args, dtype=jdt))
                got = tf.float_arange(*args, dt, "cpu").numpy()
                assert got.shape == want.shape and np.array_equal(got, want), args

    def test_one_cycle_matches_jax(self):
        want = self.jax_cycle
        csp = tc.Spline2D.fit(self.wx, self.wy, dtype=F64, device="cpu")
        got = tf.frenet_optimal_plan(csp, 0.0, 10.0 / 3.6, 2.0, 0.0, 0.0, self.obstacles)
        for k in ("best_index", "num_valid", "any_valid"):
            assert int(got[k]) == int(want[k]), k
        for k in ("path", "s", "d", "cost"):
            close(got[k], want[k], 1e-10)
        csp32 = tc.Spline2D.fit(self.wx, self.wy, dtype=torch.float32, device="cpu")
        got32 = tf.frenet_optimal_plan(csp32, 0.0, 10.0 / 3.6, 2.0, 0.0, 0.0, self.obstacles)
        assert int(got32["best_index"]) == int(want["best_index"])
        close(got32["path"], want["path"], 1e-3)


def test_eta3_chain_and_trajectory_match_jax():
    rng = np.random.default_rng(3)
    start, end = np.array([0.0, 0.0, 0.0]), np.array([4.0, 2.0, np.pi / 4])
    eta, kappa = rng.uniform(0, 4, 6), rng.normal(0, 0.3, 4)
    jcoef = jax.jit(je.eta3_coefficients)(jnp.asarray(start), jnp.asarray(end), jnp.asarray(eta),
                                          jnp.asarray(kappa))
    tcoef = te.eta3_coefficients(t64(start), t64(end), t64(eta), t64(kappa))
    close(tcoef, jcoef, 1e-12 * 50)  # coefficients up to ~50 in magnitude
    u = np.linspace(0, 1, 13)
    close(te.eta3_point(tcoef, t64(u)), jax.jit(je.eta3_point)(jcoef, jnp.asarray(u)), 1e-11)
    for g, w in zip(te.eta3_derivatives(tcoef, t64(u)),
                    jax.jit(je.eta3_derivatives)(jcoef, jnp.asarray(u))):
        close(g, w, 1e-10)
    close(te.eta3_segment_length(tcoef), jax.jit(je.eta3_segment_length)(jcoef))

    poses = np.array([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0], [7.0, 3.0, np.pi / 2], [7.0, 7.0, np.pi / 2]])
    jchain = jax.jit(je.eta3_path_coefficients)(jnp.asarray(poses))
    tchain = te.eta3_path_coefficients(poses, dtype=F64, device="cpu")
    close(tchain, jchain, 1e-11)
    close(convert.eta3_chain_from_numpy(np.asarray(jchain), device="cpu"), jchain, 0.0)
    close(te.eta3_path_sample(tchain, 64), je.eta3_path_sample(jchain, 64), 1e-10)
    want = je.eta3_trajectory_sample(jchain, max_vel=2.0, max_accel=1.0, num_points=48)
    got = te.eta3_trajectory_sample(tchain, max_vel=2.0, max_accel=1.0, num_points=48)
    for k in ("times", "states", "total_time", "total_length"):
        close(got[k], want[k], 1e-10)
    got32 = te.eta3_trajectory_sample(tchain.float(), max_vel=2.0, max_accel=1.0, num_points=48)
    close(got32["states"], want["states"], 1e-3)
