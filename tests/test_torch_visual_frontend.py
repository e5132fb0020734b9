"""The visual front end (`slam/visual_frontend.py`, `ops/stencil.py`) against
the JAX package's, on seeded numpy images and views: JAX on the CPU at x64,
torch in float64 on the CPU.

Tolerances:
- `conv2d_same` against `jax.scipy.signal.convolve2d(mode="same")`,
  `image_gradients` and `shi_tomasi_response`: atol 1e-12 on images in
  [0, 1] (sums of at most 25 taps in another order, ~1e-17 measured);
- `detect_corners`: the corners equal exactly (coordinates are float32
  integers) and the responses at atol 1e-12 — including a call asking for
  more corners than the image has peaks, where the rest tie at −inf and
  JAX's `lax.top_k` puts the lower index first; on a checkerboard, whose
  crossings tie in exact arithmetic, the responses at rtol 1e-12 and the
  corners at tests/test_visual_frontend.py's gate;
- `_bilinear`, `lk_track`, `track_with_fb_check`: points and errors within
  1e-9 px, the valid masks equal (10 Gauss-Newton iterations on 49-pixel
  windows, ~1e-14 measured);
- lanes: a batch of image pairs is its pairs' solo calls, bitwise;
- triangulation: within 1e-9 of JAX's (lstsq on SVD with JAX's cutoff),
  including a track seen by one view and one seen by none, which are
  rank-deficient; noise-free views recover the points within 1e-6, as
  tests/test_visual_frontend.py:95 holds JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.core.lie import se3_exp as j_se3_exp
from rust_robotics_tpu.slam import visual_frontend as jv
from rust_robotics_tpu_torch.ops.stencil import conv2d_same
from rust_robotics_tpu_torch.slam import visual_frontend as tv

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
INTR = (300.0, 300.0, 64.0, 48.0)


def t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


@functools.lru_cache(maxsize=None)
def _images(seed, shift=(3.3, -2.1), h=96, w=128):
    """Smooth noise (tests/test_visual_frontend.py:17) and its sub-pixel
    shift by JAX's bilinear resampling, as numpy."""
    rng = np.random.default_rng(seed)
    img0 = jax.scipy.signal.convolve2d(jnp.asarray(rng.uniform(size=(h, w))),
                                       jnp.ones((5, 5)) / 25, mode="same")
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    coords = np.stack([xx - shift[0], yy - shift[1]], axis=-1)
    return np.asarray(img0), np.asarray(jv._bilinear(img0, jnp.asarray(coords))), coords


@pytest.mark.parametrize("shape", [(3, 3), (5, 5), (4, 4), (3, 6), (1, 1)])
def test_conv2d_same_matches_convolve2d(shape):
    rng = np.random.default_rng(sum(shape))
    img, kernel = rng.normal(size=(2, 37, 29)), rng.normal(size=shape)
    want = np.stack([np.asarray(jax.scipy.signal.convolve2d(jnp.asarray(x), jnp.asarray(kernel),
                                                            mode="same")) for x in img])
    np.testing.assert_allclose(conv2d_same(t(img), kernel).numpy(), want, rtol=0, atol=1e-12)


def test_gradients_and_response_match_jax():
    img0, _, _ = _images(0)
    for g, w in zip(tv.image_gradients(t(img0)), jv.image_gradients(jnp.asarray(img0))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    for window in (5, 3, 4):
        np.testing.assert_allclose(
            tv.shi_tomasi_response(t(img0), window).numpy(),
            np.asarray(jv.shi_tomasi_response(jnp.asarray(img0), window)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_features,border", [(40, 16), (100, 8), (400, 8)])
def test_detect_corners_matches_jax(max_features, border):
    img0, _, _ = _images(0)
    want_xy, want_val = jv.detect_corners(jnp.asarray(img0), max_features=max_features,
                                          border=border)
    got_xy, got_val = tv.detect_corners(t(img0), max_features=max_features, border=border)
    assert got_xy.dtype == torch.float32
    np.testing.assert_array_equal(got_xy.numpy(), np.asarray(want_xy))
    want_val = np.asarray(want_val)
    np.testing.assert_array_equal(np.isinf(got_val.numpy()), np.isinf(want_val))
    fin = np.isfinite(want_val)
    np.testing.assert_allclose(got_val.numpy()[fin], want_val[fin], rtol=0, atol=1e-12)
    if max_features == 400:  # more asked than there are peaks: ties at -inf
        assert np.isinf(want_val).sum() > 100


def test_corners_on_checkerboard():
    """tests/test_visual_frontend.py:35's gate. Every crossing of a
    checkerboard has the same response in exact arithmetic, and so do the
    pixels beside it; which of them survive the NMS and the top-K depends on
    the last bits of the sums, so the corners are held to the gate, not to
    JAX's list."""
    tile = 12
    yy, xx = np.meshgrid(np.arange(8 * tile), np.arange(8 * tile), indexing="ij")
    board = (((yy // tile) + (xx // tile)) % 2).astype(float)
    _, want_val = jv.detect_corners(jnp.asarray(board), max_features=49)
    got, got_val = tv.detect_corners(t(board), max_features=49)
    np.testing.assert_allclose(got_val.numpy(), np.asarray(want_val), rtol=1e-12)
    lat = np.arange(tile, 8 * tile, tile) - 0.5
    near = [np.min(np.abs(lat - x)) < 2.5 and np.min(np.abs(lat - y)) < 2.5
            for x, y in got.numpy()]
    assert sum(near) > 30, sum(near)


def test_bilinear_matches_jax():
    img0, img1, coords = _images(0)
    np.testing.assert_allclose(tv._bilinear(t(img0), t(coords)).numpy(), img1, rtol=0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_tracks(seed, shift, max_features=40):
    img0, img1, _ = _images(seed, shift)
    pts, _ = jv.detect_corners(jnp.asarray(img0), max_features=max_features, border=16)
    pts = jnp.asarray(pts, jnp.float64)
    lk = jv.lk_track(jnp.asarray(img0), jnp.asarray(img1), pts)
    fb = jv.track_with_fb_check(jnp.asarray(img0), jnp.asarray(img1), pts)
    return np.asarray(pts), [np.asarray(x) for x in lk], [np.asarray(x) for x in fb]


@pytest.mark.parametrize("seed,shift", [(0, (3.3, -2.1)), (1, (2.0, 1.0))])
def test_lk_and_fb_check_match_jax(seed, shift):
    img0, img1, _ = _images(seed, shift)
    pts, (want_pts, want_valid), (want_fwd, want_ok, want_err) = _jax_tracks(seed, shift)
    got_pts, got_valid = tv.lk_track(t(img0), t(img1), t(pts))
    np.testing.assert_allclose(got_pts.numpy(), want_pts, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    fwd, ok, err = tv.track_with_fb_check(t(img0), t(img1), t(pts))
    np.testing.assert_allclose(fwd.numpy(), want_fwd, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_allclose(err.numpy(), want_err, rtol=0, atol=1e-9)
    flow = (got_pts - t(pts)).numpy()[got_valid.numpy()]
    assert len(flow) > 20
    np.testing.assert_allclose(np.median(flow, axis=0), shift, atol=0.25)
    assert int(ok.sum()) > 15 and float(err[ok].max()) < 1.0


def test_lanes_equal_their_solo_calls():
    (a0, a1, _), (b0, b1, _) = _images(0), _images(1, (2.0, 1.0))
    imgs0, imgs1 = t(np.stack([a0, b0])), t(np.stack([a1, b1]))
    xy, val = tv.detect_corners(imgs0, max_features=30, border=16)
    fwd, ok, err = tv.track_with_fb_check(imgs0, imgs1, xy.to(F64))
    for i in range(2):
        xy_i, val_i = tv.detect_corners(imgs0[i], max_features=30, border=16)
        assert torch.equal(xy[i], xy_i) and torch.equal(val[i], val_i)
        solo = tv.track_with_fb_check(imgs0[i], imgs1[i], xy_i.to(F64))
        for got, want in zip((fwd[i], ok[i], err[i]), solo):
            assert torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _views(noise):
    tangents = np.array([[0.0, 0, 0, 0, 0, 0], [0.5, 0, 0, 0, 0, 0], [1.0, 0.2, 0, 0, 0, 0],
                         [1.5, -0.1, 0, 0, 0.05, 0]])
    cams = np.asarray(j_se3_exp(jnp.asarray(tangents)))
    rng = np.random.default_rng(0)
    pts3d = np.stack([rng.uniform(-1, 2, 12), rng.uniform(-1, 1, 12), rng.uniform(3, 6, 12)], -1)
    pix = np.zeros((12, 4, 2))
    for v in range(4):
        inv = np.linalg.inv(cams[v])
        pc = pts3d @ inv[:3, :3].T + inv[:3, 3]
        pix[:, v] = np.stack([300 * pc[:, 0] / pc[:, 2] + 64, 300 * pc[:, 1] / pc[:, 2] + 48], -1)
    return cams, pts3d, pix + noise * rng.normal(size=pix.shape)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_triangulation_matches_jax(noise):
    cams, pts3d, pix = _views(noise)
    mask = np.random.default_rng(1).uniform(size=(12, 4)) > 0.3
    mask[0] = [False, True, False, False]  # one view: rank-deficient
    mask[1] = False  # no view
    mask[2] = True
    for m in (np.ones_like(mask), mask):
        want = np.asarray(jv.triangulate_tracks(jnp.asarray(cams), jnp.asarray(pix),
                                                jnp.asarray(m), INTR))
        got = tv.triangulate_tracks(t(cams), t(pix), torch.tensor(m), INTR).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    if noise == 0.0:
        got = tv.triangulate_tracks(t(cams), t(pix), torch.ones(12, 4, dtype=torch.bool), INTR)
        np.testing.assert_allclose(got.numpy(), pts3d, atol=1e-6)
    for l in (2, 5):
        want = np.asarray(jv.triangulate_point(jnp.asarray(cams), jnp.asarray(pix[l]), INTR))
        got = tv.triangulate_point(t(cams), t(pix[l]), INTR).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
