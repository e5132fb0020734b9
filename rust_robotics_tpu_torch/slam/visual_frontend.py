"""Sparse visual front end: Shi-Tomasi corners, pyramidal Lucas-Kanade flow,
forward-backward checking, multi-view triangulation.

The port of rust_robotics_tpu/slam/visual_frontend.py (reference:
slam/src/visual_frontend.rs — Shi-Tomasi detection, pyramidal LK optical
flow with forward/backward consistency (`FeatureTracker::process` :160),
triangulation (`triangulate_tracks` :260)). Every function takes leading
batch dims of images [..., H, W] and of points [..., N, 2] (x = column,
y = row), lanes in lock-step, nothing read back.

- `_conv2` is `jax.scipy.signal.convolve2d(mode="same")`, a true
  convolution with zeros padded, by `ops.stencil.conv2d_same`: shifted
  adds rather than cuDNN, so float32 stays float32 whatever
  `torch.backends.cudnn.allow_tf32` holds.
- `detect_corners`: the `reduce_window` max with a −inf pad is
  `max_pool2d` with padding r; `lax.top_k` puts the lower index first
  among equal scores (they tie whenever fewer peaks than `max_features`
  remain, the rest being −inf), and `torch.topk` promises no order on CUDA,
  so the top K come from a stable descending sort. Coordinates are float32,
  as the JAX function returns them.
- `lk_track`: the `fori_loop` is a Python loop; the window offsets take the
  points' dtype (points and images share a dtype, as the JAX loop's carry
  requires).
- Triangulation: `jnp.linalg.lstsq` is the SVD minimum-norm solution with
  the cutoff s >= eps·max(M, N)·s_max. `torch.linalg.lstsq` on CUDA has
  only `gels`, which assumes full rank, and a track masked down to one
  view is rank-deficient, so the port reduces [A | b] by Householder reflections
  (Qᵀ applied to b by the same reflections), takes the SVD of the 3×3 R
  (the singular values of A) and applies the same cutoff, which also drops
  zero singular values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rust_robotics_tpu_torch.core.lie import se3_inverse
from rust_robotics_tpu_torch.ops.smallmat import householder_r
from rust_robotics_tpu_torch.ops.stencil import conv2d_same

_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]) / 8.0
_SOBEL_Y = _SOBEL_X.T


def _conv2(img, kernel):
    return conv2d_same(img, kernel)


def image_gradients(img):
    # convolve2d performs true convolution (kernel flipped); Sobel is
    # antisymmetric, so negate to get the correlation-convention gradient
    return -_conv2(img, _SOBEL_X), -_conv2(img, _SOBEL_Y)


def shi_tomasi_response(img, window: int = 5):
    """Min-eigenvalue corner response (visual_frontend.rs Shi-Tomasi)."""
    ix, iy = image_gradients(img)
    box = np.ones((window, window)) / (window * window)
    sxx = _conv2(ix * ix, box)
    syy = _conv2(iy * iy, box)
    sxy = _conv2(ix * iy, box)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 - disc  # smaller eigenvalue


def detect_corners(img, max_features: int = 100, nms_radius: int = 5, border: int = 8):
    """Top-K spatially-NMS'd corners of img [..., H, W]; returns (xy
    [..., K, 2] float32 (col, row), response [..., K])."""
    resp = shi_tomasi_response(img)
    h, w = resp.shape[-2:]
    lead = resp.shape[:-2]
    k = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp.reshape(-1, 1, h, w), k, stride=1,
                             padding=nms_radius).reshape(resp.shape)
    is_peak = (resp >= local_max) & (resp > 0)
    rr = torch.arange(h, device=img.device)[:, None]
    cc = torch.arange(w, device=img.device)[None, :]
    inb = (rr >= border) & (rr < h - border) & (cc >= border) & (cc < w - border)
    scores = torch.where(is_peak & inb, resp, -torch.inf).reshape(*lead, h * w)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :max_features], idx[..., :max_features]
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = torch.remainder(idx, w).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), vals


def _bilinear(img, xy):
    """Sample img [..., H, W] at float (x=col, y=row) positions
    [..., P..., 2], whose leading dims are img's."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(*lead, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(*lead, -1)
        return torch.take_along_dim(flat, idx, dim=-1).reshape(x.shape)

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


def _downsample(img):
    h, w = img.shape[-2:]
    c = img[..., :(h // 2) * 2, :(w // 2) * 2]
    return 0.25 * (c[..., 0::2, 0::2] + c[..., 1::2, 0::2] + c[..., 0::2, 1::2]
                   + c[..., 1::2, 1::2])


def lk_track(img0, img1, pts, window: int = 7, levels: int = 3, iterations: int = 10):
    """Pyramidal Lucas-Kanade: track pts [..., N, 2] (x, y) from img0 to
    img1 [..., H, W]. Returns (new_pts [..., N, 2], valid [..., N])."""
    pyr0, pyr1 = [img0], [img1]
    for _ in range(levels - 1):
        pyr0.append(_downsample(pyr0[-1]))
        pyr1.append(_downsample(pyr1[-1]))

    r = window // 2
    ar = torch.arange(-r, r + 1.0, dtype=pts.dtype, device=pts.device)
    offs = torch.stack(torch.meshgrid(ar, ar, indexing="xy"), dim=-1).reshape(-1, 2)  # [W², 2]

    flow = torch.zeros_like(pts)
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0**lvl
        i0, i1 = pyr0[lvl], pyr1[lvl]
        gx, gy = image_gradients(i0)
        base = pts / scale
        patches = base[..., :, None, :] + offs  # [..., N, W², 2]
        t0 = _bilinear(i0, patches)
        jx = _bilinear(gx, patches)
        jy = _bilinear(gy, patches)
        a11 = torch.sum(jx * jx, dim=-1)
        a12 = torch.sum(jx * jy, dim=-1)
        a22 = torch.sum(jy * jy, dim=-1)
        det = a11 * a22 - a12 * a12
        flat = torch.abs(det) < 1e-9
        safe = torch.where(flat, 1.0, det)
        for _ in range(iterations):
            cur = base[..., :, None, :] + offs + (flow / scale)[..., :, None, :]
            e = _bilinear(i1, cur) - t0
            b1 = torch.sum(e * jx, dim=-1)
            b2 = torch.sum(e * jy, dim=-1)
            du = -(a22 * b1 - a12 * b2) / safe
            dv = -(-a12 * b1 + a11 * b2) / safe
            step = torch.where(flat[..., None], 0.0, torch.stack([du, dv], dim=-1))
            flow = flow + step * scale

    new_pts = pts + flow
    h, w = img1.shape[-2:]
    valid = ((new_pts[..., 0] >= 1) & (new_pts[..., 0] < w - 1)
             & (new_pts[..., 1] >= 1) & (new_pts[..., 1] < h - 1))
    return new_pts, valid


def track_with_fb_check(img0, img1, pts, fb_threshold: float = 1.0, **kw):
    """Forward-backward consistency (visual_frontend.rs:160): track
    forward, track back, keep points that return within threshold."""
    fwd, v1 = lk_track(img0, img1, pts, **kw)
    back, v2 = lk_track(img1, img0, fwd, **kw)
    err = torch.linalg.vector_norm(back - pts, dim=-1)
    return fwd, v1 & v2 & (err < fb_threshold), err


def _lstsq_min_norm(m, b):
    """jnp.linalg.lstsq(m, b)[0] for m [..., M, N] (M ≥ N), b [..., M]:
    the SVD minimum-norm solution with zero singular values and those below
    eps·max(M, N)·s_max cut (an all-zero m gives 0)."""
    rows, n = m.shape[-2:]
    # R of [m | b] holds R of m and, in its last column, Qᵀb
    red = householder_r(torch.cat([m, b[..., None]], dim=-1))
    r, qtb = red[..., :n, :n], red[..., :n, n]
    u, s, vh = torch.linalg.svd(r)
    rcond = torch.finfo(m.dtype).eps * max(rows, n)
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), 0.0)
    utb = (u.mT @ qtb[..., None])[..., 0]
    return (vh.mT @ (s_inv * utb)[..., None])[..., 0]


def _dlt_rows(cams, pixels, intrinsics):
    """Per view the two DLT rows [..., V, 2, 4] of world-from-camera cams
    [V, 4, 4] and pixels [..., V, 2]."""
    fx, fy, cx, cy = intrinsics
    p = se3_inverse(cams)[..., :3, :]  # camera-from-world [V, 3, 4]
    x = ((pixels[..., 0] - cx) / fx)[..., None]
    y = ((pixels[..., 1] - cy) / fy)[..., None]
    return torch.stack([x * p[..., 2, :] - p[..., 0, :], y * p[..., 2, :] - p[..., 1, :]], dim=-2)


def triangulate_point(cams, pixels, intrinsics):
    """Linear DLT triangulation of one landmark from V views.

    cams [V, 4, 4] world-from-camera; pixels [..., V, 2]; returns xyz
    [..., 3]."""
    a = _dlt_rows(cams, pixels, intrinsics).flatten(-3, -2)
    return _lstsq_min_norm(a[..., :3], -a[..., 3])


def triangulate_tracks(cams, track_pixels, track_mask, intrinsics):
    """Batched triangulation (visual_frontend.rs:260): track_pixels
    [L, V, 2] with mask [L, V] (which views saw which landmark). Unseen
    views get zero-weighted rows."""
    rows = _dlt_rows(cams, track_pixels, intrinsics)
    a = (torch.where(track_mask, 1.0, 0.0).to(rows.dtype)[..., None, None] * rows).flatten(-3, -2)
    return _lstsq_min_norm(a[..., :3], -a[..., 3])
