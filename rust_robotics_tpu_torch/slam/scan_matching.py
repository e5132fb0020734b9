"""Scan matching: robust ICP, point-to-line and point-to-plane ICP,
correlative matching and graph-based SLAM from landmark constraints.

The port of rust_robotics_tpu/slam/scan_matching.py. Reference
(crates/rust_robotics_slam/src/):
- robust_icp.rs — Gauss-Newton + Huber ICP (:77, :95-110);
- geometric_icp.rs — point-to-line 2-D (:51) and point-to-plane 3-D
  (:145) ICP;
- correlative_scan_matching.rs — a brute-force pose-grid search (:55);
- graph_based_slam.rs — a pose graph from virtual landmark constraints
  (:262).

The ICPs run a fixed number of Gauss-Newton steps (JAX's `fori_loop`),
over leading batch dims in lock-step, and read nothing back. Nearest
neighbours come from `slam/icp.py::nearest_neighbor`. The 2-D ICPs keep a
pair's arithmetic independent of the batch around it, as `slam/icp.py`
does: products over coordinates are explicit multiply-adds (`small_mm`),
sums over the points are halving adds, and the 3×3 normal equations are
solved in closed form, so a lane equals its solo run. `point_to_line_icp`
takes the two nearest previous points by two first-index argmins, the
first masked out for the second: the order `lax.top_k` gives on a tie
(the lower index first), which `torch.topk` does not promise on CUDA. The
correlative search scores every (dθ, dx, dy) candidate in one batched
gather; its best is the first maximum, as `jnp.argmax`.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import true_div
from rust_robotics_tpu_torch.core.angles import normalize_angle
from rust_robotics_tpu_torch.nlls.kernels import RobustKernel
from rust_robotics_tpu_torch.nlls.tridiag import _tree_sum, small_mm
from rust_robotics_tpu_torch.ops.smallmat import inv_spd_small
from rust_robotics_tpu_torch.slam.icp import _sq_norm, nearest_neighbor


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _apply_se2(pose, pts):
    """pts [..., M, 2] moved by pose [..., 3]: R p + t."""
    return small_mm(pts, _rot2(pose[..., 2]).mT) + pose[..., None, :2]


def _point_sum(x):
    """x [..., M, k] summed over the points M by halving adds."""
    return _tree_sum(x.movedim(-2, -1)[..., None])


def _initial_pose(init_pose, like, lead, n=3):
    if init_pose is None:
        return like.new_zeros((*lead, n))
    return torch.as_tensor(init_pose, dtype=like.dtype, device=like.device).expand(*lead, n)


def _lead(prev_pts, cur_pts):
    return torch.broadcast_shapes(prev_pts.shape[:-2], cur_pts.shape[:-2])


def _gn_step(pose, j, r, w=None):
    """The Gauss-Newton update of pose [..., 3] from per-point Jacobian
    rows j [..., M, k, 3] and residuals r [..., M, k], weights w [..., M]:
    δ = −(Σ w jᵀj + 1e-9 I)⁻¹ Σ w jᵀr."""
    wj = j if w is None else w[..., None, None] * j
    jtj = _point_sum((wj[..., :, :, None] * j[..., :, None, :]).sum(-3).flatten(-2))
    h = jtj.unflatten(-1, (3, 3)) + 1e-9 * torch.eye(3, dtype=j.dtype, device=j.device)
    g = _point_sum((wj * r[..., None]).sum(-2))
    delta = -small_mm(inv_spd_small(h), g[..., None])[..., 0]
    return torch.cat([pose[..., :2] + delta[..., :2],
                      normalize_angle(pose[..., 2:] + delta[..., 2:])], dim=-1)


def _dp(pose, cur_pts):
    """dR/dθ p [..., M, 2] for the current points."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    d_rot = torch.stack([torch.stack([-s, c], -1), torch.stack([-c, -s], -1)], -2)
    return small_mm(cur_pts, d_rot)


def _final_distance(prev_pts, cur_pts, pose):
    _, dist = nearest_neighbor(prev_pts, _apply_se2(pose, cur_pts))
    return true_div(_point_sum(dist[..., None])[..., 0], dist.shape[-1])


def robust_icp(prev_pts, cur_pts, init_pose=None, iterations: int = 30,
               huber_delta: float = 0.5):
    """Huber-weighted Gauss-Newton point-to-point ICP
    (robust_icp.rs:95-110): the SE(2) pose [dx, dy, dθ] mapping current
    onto previous. prev_pts [..., N, 2], cur_pts [..., M, 2]. Returns
    (pose [..., 3], the final mean nearest distance [...])."""
    lead = _lead(prev_pts, cur_pts)
    pose = _initial_pose(init_pose, prev_pts, lead)
    kernel = RobustKernel("huber", huber_delta)
    m = cur_pts.shape[-2]
    eye = torch.eye(2, dtype=prev_pts.dtype, device=prev_pts.device).expand(*lead, m, 2, 2)
    for _ in range(iterations):
        moved = _apply_se2(pose, cur_pts)
        idx, _ = nearest_neighbor(prev_pts, moved)
        target = torch.take_along_dim(prev_pts, idx[..., None], dim=-2)
        r = moved - target  # [..., M, 2]
        _, w = kernel.evaluate(_sq_norm(r))
        # the residual's Jacobian w.r.t. [dx, dy, dθ]: [I, dR/dθ p]
        j = torch.cat([eye, _dp(pose, cur_pts)[..., None]], dim=-1)  # [..., M, 2, 3]
        pose = _gn_step(pose, j, r, w)
    return pose, _final_distance(prev_pts, cur_pts, pose)


def _dot(a, b):
    """Σ_k a_k b_k over the trailing coordinate axis, by explicit adds."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


def _two_nearest(dd):
    """The indices of the two least entries of dd [..., M, N] along N, the
    lower index first on a tie (as `lax.top_k(-dd, 2)`)."""
    first = torch.argmin(dd, dim=-1)
    masked = dd.scatter(-1, first[..., None], torch.inf)
    return first, torch.argmin(masked, dim=-1)


def point_to_line_icp(prev_pts, cur_pts, init_pose=None, iterations: int = 30):
    """Point-to-line 2-D ICP (geometric_icp.rs:51): the residual
    n·(T p − q) against the local line through the two nearest previous
    points. Returns (pose [..., 3], the final mean nearest distance)."""
    lead = _lead(prev_pts, cur_pts)
    pose = _initial_pose(init_pose, prev_pts, lead)
    prev_sq = _sq_norm(prev_pts)[..., None, :]
    for _ in range(iterations):
        moved = _apply_se2(pose, cur_pts)
        dd = _sq_norm(moved)[..., :, None] + prev_sq - 2.0 * small_mm(moved, prev_pts.mT)
        ia, ib = _two_nearest(dd)
        a = torch.take_along_dim(prev_pts, ia[..., None], dim=-2)
        b = torch.take_along_dim(prev_pts, ib[..., None], dim=-2)
        t = b - a
        t = t / torch.clamp(torch.sqrt(_sq_norm(t)), min=1e-9)[..., None]
        n = torch.stack([-t[..., 1], t[..., 0]], dim=-1)  # the line's normal
        r = _dot(n, moved - a)  # [..., M]
        j = torch.cat([n, _dot(n, _dp(pose, cur_pts))[..., None]], dim=-1)  # [..., M, 3]
        pose = _gn_step(pose, j[..., None, :], r[..., None])
    return pose, _final_distance(prev_pts, cur_pts, pose)


def correlative_scan_match(scan_pts, likelihood, min_x, min_y, resolution,
                           search_xy=1.0, search_theta=0.35, n_xy: int = 21,
                           n_theta: int = 21, init_pose=None):
    """Brute-force pose-grid search (correlative_scan_matching.rs:55): the
    (dx, dy, dθ) candidate that maximises the summed map likelihood of the
    moved scan, every candidate scored in one batched gather.

    scan_pts [..., N, 2]; likelihood [W, H] or [..., W, H]. Returns
    (best_pose [..., 3], best_score [...], scores [..., n_theta, n_xy,
    n_xy]); the best is the first maximum in that order."""
    dtype, device = scan_pts.dtype, scan_pts.device
    lead = torch.broadcast_shapes(scan_pts.shape[:-2], likelihood.shape[:-2])
    p0 = _initial_pose(init_pose, scan_pts, lead)
    grid_xy = torch.linspace(-search_xy, search_xy, n_xy, dtype=dtype, device=device)
    grid_th = torch.linspace(-search_theta, search_theta, n_theta, dtype=dtype, device=device)
    dxs = p0[..., 0, None] + grid_xy
    dys = p0[..., 1, None] + grid_xy
    dth = p0[..., 2, None] + grid_th
    w, h = likelihood.shape[-2:]

    rot_pts = small_mm(scan_pts[..., None, :, :], _rot2(dth).mT)  # [..., T, N, 2]
    px = rot_pts[..., :, None, None, :, 0] + dxs[..., None, :, None, None]  # [..., T, X, 1, N]
    py = rot_pts[..., :, None, None, :, 1] + dys[..., None, None, :, None]  # [..., T, 1, Y, N]
    # truncation toward zero, as .astype(int32)
    ix = torch.clamp(((px - min_x) / resolution).to(torch.int32), 0, w - 1).to(torch.int64)
    iy = torch.clamp(((py - min_y) / resolution).to(torch.int32), 0, h - 1).to(torch.int64)
    flat_idx = (ix * h + iy).flatten(-4)  # [..., T·X·Y·N]
    flat_lik = likelihood.expand(*lead, w, h).flatten(-2)
    vals = torch.take_along_dim(flat_lik, flat_idx, dim=-1)
    scores = vals.unflatten(-1, (n_theta, n_xy, n_xy, -1)).sum(-1)
    best = torch.argmax(scores.flatten(-3), dim=-1)
    ti, rem = best // (n_xy * n_xy), best % (n_xy * n_xy)
    xi, yi = rem // n_xy, rem % n_xy
    pick = lambda v, i: torch.take_along_dim(v, i[..., None], dim=-1)[..., 0]  # noqa: E731
    best_pose = torch.stack([pick(dxs, xi), pick(dys, yi), pick(dth, ti)], dim=-1)
    return best_pose, pick(scores.flatten(-3), best), scores


def graph_slam_from_landmarks(pose_guesses, landmark_obs, obs_mask, information_scale=10.0,
                              max_iterations=30, device=None, dtype=torch.float32):
    """Graph-based SLAM from virtual landmark constraints
    (graph_based_slam.rs:262): each pair of consecutive poses that observe
    the same landmark adds a virtual relative-pose constraint from their
    range-bearing observations; the SE(2) graph, with the odometry
    backbone of the guesses, goes to `slam/pose_graph.py`'s optimiser on
    `device` (default cuda) in `dtype`. The graph is built on the host
    (numpy), as in the JAX package.

    pose_guesses [N, 3]; landmark_obs [N, L, 2] (range, bearing); obs_mask
    [N, L]. Returns (poses [N, 3], summary)."""
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    po, ob, mask = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                    for a in (pose_guesses, landmark_obs, obs_mask))
    n, l, _ = ob.shape
    ef, et, meas, info = [], [], [], []
    # the odometry backbone from the guesses
    for i in range(n - 1):
        a, b = po[i], po[i + 1]
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        meas.append([c * d[0] + s * d[1], -s * d[0] + c * d[1], b[2] - a[2]])
        ef.append(i)
        et.append(i + 1)
        info.append(np.eye(3))

    def lm_from(p, z):
        return p[:2] + z[0] * np.array([np.cos(p[2] + z[1]), np.sin(p[2] + z[1])])

    # the virtual landmark constraints
    for k in range(l):
        seers = np.nonzero(mask[:, k])[0]
        for ii in range(len(seers) - 1):
            i, j = int(seers[ii]), int(seers[ii + 1])
            li = lm_from(po[i], ob[i, k])
            lj = lm_from(po[j], ob[j, k])
            # the virtual relative translation's correction
            d = po[j][:2] + (li - lj) - po[i][:2]
            c, s = np.cos(po[i][2]), np.sin(po[i][2])
            meas.append([c * d[0] + s * d[1], -s * d[0] + c * d[1], po[j][2] - po[i][2]])
            ef.append(i)
            et.append(j)
            info.append(information_scale * np.diag([1.0, 1.0, 0.1]))
    return optimize_pose_graph_2d(po, np.asarray(ef, np.int32), np.asarray(et, np.int32),
                                  np.stack(meas), np.stack(info),
                                  max_iterations=max_iterations, device=device, dtype=dtype)


def point_to_plane_icp(prev_pts, prev_normals, cur_pts, init_xi=None, iterations: int = 30):
    """Point-to-plane 3-D ICP (geometric_icp.rs:145): minimise
    Σ (n_qᵀ (T p − q))² over SE(3), a closed 6×6 Gauss-Newton step per
    iteration against the previous cloud's normals. prev_pts,
    prev_normals [..., N, 3]; cur_pts [..., M, 3]. Returns (xi [..., 6],
    the se(3) tangent of previous-from-current, and the final mean nearest
    distance)."""
    from rust_robotics_tpu_torch.core.lie import se3_exp, se3_log

    lead = _lead(prev_pts, cur_pts)
    xi = _initial_pose(init_xi, prev_pts, lead, 6)
    eye6 = torch.eye(6, dtype=prev_pts.dtype, device=prev_pts.device)

    def move(xi):
        t = se3_exp(xi)
        return cur_pts @ t[..., :3, :3].mT + t[..., None, :3, 3]

    for _ in range(iterations):
        moved = move(xi)
        idx, _ = nearest_neighbor(prev_pts, moved)
        q = torch.take_along_dim(prev_pts, idx[..., None], dim=-2)
        n = torch.take_along_dim(prev_normals, idx[..., None], dim=-2)
        r = torch.sum(n * (moved - q), dim=-1)  # [..., M]
        # the Jacobian w.r.t. a left perturbation: [n, moved × n]
        j = torch.cat([n, torch.linalg.cross(moved, n, dim=-1)], dim=-1)  # [..., M, 6]
        h = j.mT @ j + 1e-9 * eye6
        g = (j.mT @ r[..., None])[..., 0]
        delta = -torch.linalg.solve_ex(h, g[..., None]).result[..., 0]
        xi = se3_log(se3_exp(delta) @ se3_exp(xi))
    _, dist = nearest_neighbor(prev_pts, move(xi))
    return xi, torch.mean(dist, dim=-1)
